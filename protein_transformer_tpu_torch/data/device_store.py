"""Device-resident dataset store: a batch is one gather on the device.

Port of protein_transformer_tpu/data/device_store.py, its single-device
half. Every split is uploaded once as flat residue-major tensors (offsets +
lengths); a batch is then planned on the host (``plan_batch``: which rows,
at which bucket shape) and assembled on the device by plain tensor indexing
(``gather_batch_fields``), so per step the host ships only a (B,) index
vector, through a pinned buffer and without blocking.

The gathered batch equals ``collate(...).to(device)`` bit for bit, all six
fields with their dtypes (ids as int64, as ``Batch.to`` gives them): rows
beyond a protein's length are padding, masked angle and coordinate entries
arrive zeroed, ``protein_mask`` marks real rows, a dead row (index -1)
gathers protein 0 fully masked with ``pad_id`` in ``seq``, rows are clipped
to the store and chains longer than ``max_seq_len`` are cut. The JAX package
computes its gather with XLA outside any Pallas kernel, and so does this
module with PyTorch's indexing: there is no hand kernel to port.

The store keeps the JAX store's int32 sequence and its per-residue byte
count, so that ``auto_enabled`` decides exactly as the JAX package does.

Not in the port yet (multi-GPU, ROADMAP Queue 1 item 8): the store sharded
over a mesh's 'data' axis (the JAX ``_partition_shards``,
``_sharded_gather_impl``, ``_put_sharded``, the ``owner`` branch of
``gather_batch_fields``, and the ``mesh`` / ``sharded`` arguments).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from protein_transformer_tpu_torch.data.dataset import (
    Batch, ProteinSplit, bucket_batch_size, bucket_length)
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES, NUM_PREDICTED_COORDS)
from protein_transformer_tpu_torch.protein.vocab import VOCAB

# bytes per residue across all store arrays (seq 4 + ang 96 + ang_mask 24 +
# crd 168 + crd_mask 14); used for the auto-enable memory estimate
_BYTES_PER_RES = 4 + 24 * 4 + 24 + 14 * 3 * 4 + 14


def store_nbytes(split: ProteinSplit) -> int:
    """Estimated device bytes for a split's store."""
    return int(split.lens.sum()) * _BYTES_PER_RES + len(split) * 8


@dataclasses.dataclass
class BatchPlan:
    """Host-side plan for one batch: which rows, at which bucket shape."""
    idx_padded: np.ndarray   # (Bb,) int32, -1 marks a padding row
    lb: int                  # bucket length
    n_res: int               # real residues (throughput metric)
    n_real: int              # real proteins in the batch


def plan_batch(split: ProteinSplit, indices: np.ndarray,
               length_buckets: Sequence[int], max_seq_len: int) -> BatchPlan:
    """The shape/bookkeeping half of collate, without materialising data."""
    lens = np.minimum(split.lens[np.asarray(indices)], max_seq_len)
    lb = bucket_length(int(lens.max()), length_buckets, max_seq_len)
    n_real = len(indices)
    idx = np.full((bucket_batch_size(n_real),), -1, np.int32)
    idx[:n_real] = indices
    return BatchPlan(idx, lb, int(lens.sum()), n_real)


def gather_batch_fields(store: dict, idx: torch.Tensor, *, lb: int,
                        pad_id: int) -> tuple:
    """Assemble one padded batch from the flat store. idx: (Bb,) integer
    tensor on the store's device, -1 = dead row. Returns the six Batch
    array fields."""
    live_row = idx >= 0
    cidx = torch.where(live_row, idx, 0).long()
    off = store["offsets"][cidx]                                   # (B,)
    ln = store["lens"][cidx]                                       # (B,)
    pos = torch.arange(lb, dtype=torch.int32, device=idx.device)[None, :]
    valid = (pos < ln[:, None]) & live_row[:, None]                # (B, L)
    n_res_total = store["seq"].shape[0]
    rows = torch.clamp(off[:, None] + pos, 0, n_res_total - 1).long()

    seq = torch.where(valid, store["seq"][rows], pad_id).long()
    ang = torch.where(valid[..., None], store["ang"][rows], 0.0)
    ang_mask = store["ang_mask"][rows] & valid[..., None]
    crd = torch.where(valid[..., None, None], store["crd"][rows], 0.0)
    crd_mask = store["crd_mask"][rows] & valid[..., None]
    return seq, ang, ang_mask, crd, crd_mask, live_row


class DeviceStore:
    """One split resident on ``device``, and its batch gather."""

    def __init__(self, split: ProteinSplit, device: torch.device):
        self.split = split
        self.device = torch.device(device)
        n = len(split)
        lens = np.minimum(split.lens, split.max_seq_len).astype(np.int32)
        offsets = np.zeros(n, np.int32)
        if n:
            offsets[1:] = np.cumsum(lens)[:-1]
        total = int(lens.sum())
        base = offsets.astype(np.int64)

        # Vectorised fill: one fancy-indexed assignment per array instead of
        # n per-protein slice copies. rows[j] = destination row of the j-th
        # residue in concatenation order; split.angs/crds arrive
        # zero-filled (ProteinSplit.__init__).
        seq_f = np.zeros(total, np.int32)
        ang_f = np.zeros((total, NUM_PREDICTED_ANGLES * 2), np.float32)
        angm_f = np.zeros_like(ang_f, dtype=bool)
        crd_f = np.zeros((total, NUM_PREDICTED_COORDS, 3), np.float32)
        crdm_f = np.zeros((total, NUM_PREDICTED_COORDS), bool)
        if n:
            rows = np.concatenate(
                [base[i] + np.arange(int(lens[i])) for i in range(n)])
            seq_f[rows] = np.concatenate(
                [split.seq_enc[i][:int(lens[i])] for i in range(n)])
            ang_f[rows] = np.concatenate(
                [split.angs[i][:int(lens[i])] for i in range(n)])
            angm_f[rows] = np.concatenate(
                [split.ang_masks[i][:int(lens[i])] for i in range(n)])
            crd_f[rows] = np.concatenate(
                [split.crds[i][:int(lens[i]) * NUM_PREDICTED_COORDS]
                 for i in range(n)]).reshape(-1, NUM_PREDICTED_COORDS, 3)
            crdm_f[rows] = np.concatenate(
                [split.crd_masks[i][:int(lens[i])] for i in range(n)])

        host = {"seq": seq_f, "ang": ang_f, "ang_mask": angm_f,
                "crd": crd_f, "crd_mask": crdm_f,
                "offsets": offsets, "lens": lens}
        self.store = {k: torch.from_numpy(v).to(self.device)
                      for k, v in host.items()}

    def device_nbytes(self) -> int:
        """Resident bytes of the store on its device."""
        return sum(t.numel() * t.element_size() for t in self.store.values())

    def _index(self, plan: BatchPlan) -> torch.Tensor:
        """The plan's index vector on the device. On a GPU it goes through
        pinned host memory without blocking; the caching host allocator
        keeps the pinned block until the copy has landed."""
        idx = torch.from_numpy(plan.idx_padded)
        if self.device.type != "cuda":
            return idx.to(self.device)
        return idx.pin_memory().to(self.device, non_blocking=True)

    def batch(self, plan: BatchPlan) -> Batch:
        """Assemble the planned batch on the device. n_res and protein_mask
        are not read back: n_res is the plan's, and the device's
        protein_mask is the gather's live rows."""
        fields = gather_batch_fields(self.store, self._index(plan),
                                     lb=plan.lb, pad_id=VOCAB.pad_id)
        return Batch(*fields, n_res=plan.n_res)


class LazyBatch:
    """Batch facade for host bookkeeping on the device-data path.

    Loop bookkeeping needs only the cheap host fields (n_res, protein_mask,
    from the plan); the array fields materialise on first access by one
    gather, which the loop asks for only on the structure-logging cadence.
    """

    def __init__(self, store: DeviceStore, plan: BatchPlan):
        self._store, self._plan = store, plan
        self.n_res = plan.n_res
        self.protein_mask = plan.idx_padded >= 0
        self._dev: Batch | None = None

    def _materialize(self) -> Batch:
        if self._dev is None:
            self._dev = self._store.batch(self._plan)
        return self._dev

    @property
    def seq(self):
        return self._materialize().seq

    @property
    def host_seq(self) -> np.ndarray:
        """The batch's (Bb, lb) sequence ids, made on the host from the
        split as the gather makes them (``pad_id`` past each protein and in
        dead rows), without touching the device."""
        plan, store = self._plan, self._store
        out = np.full((len(plan.idx_padded), plan.lb), VOCAB.pad_id,
                      np.int64)
        for row, i in enumerate(plan.idx_padded):
            if i >= 0:
                n = min(int(store.split.lens[i]), store.split.max_seq_len,
                        plan.lb)
                out[row, :n] = store.split.seq_enc[i][:n]
        return out

    @property
    def ang(self):
        return self._materialize().ang

    @property
    def ang_mask(self):
        return self._materialize().ang_mask

    @property
    def crd(self):
        return self._materialize().crd

    @property
    def crd_mask(self):
        return self._materialize().crd_mask


def auto_enabled(cfg, splits: Sequence[ProteinSplit]) -> bool:
    """Decide the device-data path: an explicit flag wins; 'auto' enables
    when the resident footprint of ``splits`` fits
    ``cfg.device_data_max_mb``."""
    mode = getattr(cfg, "device_data", "auto")
    if mode in (True, "true", "on"):
        return True
    if mode in (False, "false", "off"):
        return False
    budget = getattr(cfg, "device_data_max_mb", 4096) * 1024 * 1024
    return sum(store_nbytes(s) for s in splits) <= budget
