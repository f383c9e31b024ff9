"""Device-resident dataset store: a batch is one gather on the device.

Port of protein_transformer_tpu/data/device_store.py. Every split is
uploaded once as flat residue-major tensors (offsets + lengths); a batch is then planned on the host (``plan_batch``: which rows,
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

Under a mesh (``parallel/mesh.py``) a rank's batch is its rows of the
global batch. When the 'data' axis has more than one rank the store is
SHARDED over it, as in the JAX package: proteins are binned greedily into
balanced per-rank residue blocks (``_partition_shards``, the same layout on
every rank), each rank holds its block (``_put_sharded``), gathers the
batch rows whose proteins it owns, and one collective over 'data' leaves
each rank its row shard (``_sharded_gather``), with the same fields,
dtypes, ``pad_id`` rows and dead rows as ``collate``, bit for bit. The JAX
package's psum-scatter is written as an all-reduce of the packed batch
followed by the rank's own rows, on every backend: gloo runs only
all-reduce and broadcast on CUDA tensors. Each rank contributes -0.0 where
it owns nothing, so the sum is every value exactly (x + -0.0 is x).
Otherwise (one 'data' rank, or ``sharded=False``) every rank holds the
whole split and gathers its own rows.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from protein_transformer_tpu_torch.data.dataset import (
    Batch, ProteinSplit, bucket_batch_size, bucket_length)
from protein_transformer_tpu_torch.parallel.mesh import batch_sharding
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
               length_buckets: Sequence[int], max_seq_len: int,
               batch_multiple: int = 1) -> BatchPlan:
    """The shape/bookkeeping half of collate, without materialising data."""
    lens = np.minimum(split.lens[np.asarray(indices)], max_seq_len)
    lb = bucket_length(int(lens.max()), length_buckets, max_seq_len)
    n_real = len(indices)
    idx = np.full((bucket_batch_size(n_real, batch_multiple),), -1,
                  np.int32)
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


# store keys that scale with the dataset (sharded over 'data'); the
# per-protein metadata (owner/offsets/lens, ~12 B/protein) is on every rank
_DATA_KEYS = ("seq", "ang", "ang_mask", "crd", "crd_mask")


def _partition_shards(lens: np.ndarray, n_shards: int):
    """Greedy balanced residue binning: proteins -> n_shards rank blocks.

    Longest-first into the currently lightest bin (deterministic: stable
    sort, lowest-bin tie-break), so every rank computes the identical
    layout. Returns (owner (n,), local_offset (n,), cap) where cap is the
    padded per-shard residue count (max bin fill)."""
    n = len(lens)
    owner = np.zeros(n, np.int32)
    local = np.zeros(n, np.int32)
    fill = np.zeros(n_shards, np.int64)
    for i in np.argsort(-lens, kind="stable"):
        s = int(np.argmin(fill))
        owner[i] = s
        local[i] = fill[s]
        fill[s] += int(lens[i])
    return owner, local, max(int(fill.max()) if n else 0, 1)


def _put_sharded(host: dict, data, cap: int, device) -> dict:
    """This rank's store: its block of ``cap`` residues of each data array
    (block ``data.rank`` of the 'data' axis ``data``), the metadata
    whole."""
    block = slice(data.rank * cap, (data.rank + 1) * cap)
    return {k: torch.from_numpy(np.ascontiguousarray(
        x[block] if k in _DATA_KEYS else x)).to(device)
        for k, x in host.items()}


# columns of the packed batch that _sharded_gather sums over 'data'
_PACKED = (("seq", 1), ("ang", NUM_PREDICTED_ANGLES * 2),
           ("ang_mask", NUM_PREDICTED_ANGLES * 2),
           ("crd", NUM_PREDICTED_COORDS * 3),
           ("crd_mask", NUM_PREDICTED_COORDS))


def _sharded_gather(store: dict, idx: torch.Tensor, *, lb: int, pad_id: int,
                    data, rows: slice | None) -> tuple:
    """Batch gather from a 'data'-sharded store (JAX
    ``_sharded_gather_impl``). idx: the whole (Bb,) index vector, -1 = dead
    row. Each rank gathers the rows whose proteins live in its block and
    packs the five fields into one float32 (Bb, L, 105) tensor; where it
    owns nothing it puts -0.0, and rank 0 puts the padding's values
    (``pad_id`` ids, +0.0 elsewhere) where no protein is. One all-reduce
    over 'data' then holds the batch exactly, and the rank keeps ``rows``
    of it (all rows for None). Returns the six Batch array fields."""
    live = idx >= 0
    cidx = torch.where(live, idx, 0).long()
    own = (store["owner"][cidx] == data.rank) & live               # (B,)
    off = store["offsets"][cidx]                                    # local
    ln = store["lens"][cidx]
    pos = torch.arange(lb, dtype=torch.int32, device=idx.device)[None, :]
    valid = (pos < ln[:, None]) & live[:, None]                     # (B, L)
    pick = valid & own[:, None]
    cap = store["seq"].shape[0]
    at = torch.clamp(off[:, None] + pos, 0, cap - 1).long()
    bsz = idx.shape[0]
    packed = torch.cat(
        [store["seq"][at][..., None].float(), store["ang"][at],
         store["ang_mask"][at].float(),
         store["crd"][at].reshape(bsz, lb, -1),
         store["crd_mask"][at].float()], dim=-1)
    neutral = torch.full_like(packed, -0.0)
    if data.rank == 0:
        pad = torch.zeros(packed.shape[-1], device=packed.device)
        pad[0] = pad_id
        neutral = torch.where(valid[..., None], neutral, pad)
    packed = data.all_reduce(torch.where(pick[..., None], packed, neutral))
    if rows is not None:
        packed, live = packed[rows], live[rows]
    seq, ang, ang_mask, crd, crd_mask = torch.split(
        packed, [w for _, w in _PACKED], dim=-1)
    return (seq[..., 0].long(), ang.contiguous(), ang_mask.bool(),
            crd.reshape(*crd.shape[:2], NUM_PREDICTED_COORDS, 3),
            crd_mask.bool(), live)


class DeviceStore:
    """One split resident on ``device``, and its batch gather.

    mesh: optional ``parallel.mesh.Mesh``; a batch is then this rank's
    rows of the global batch. With a multi-rank 'data' axis the store is
    SHARDED over it (per-rank bytes ~1/N, see ``_sharded_gather``);
    otherwise every rank holds it whole. ``sharded`` forces the layout
    (tests, explicit control)."""

    def __init__(self, split: ProteinSplit, device: torch.device,
                 mesh=None, sharded: bool | None = None):
        self.split = split
        self.device = torch.device(device)
        self.mesh = mesh
        self.data = mesh.axis("data") if mesh is not None else None
        n_data = self.data.size if mesh is not None else 1
        if sharded is None:
            sharded = n_data > 1
        self.sharded = bool(sharded) and mesh is not None
        n = len(split)
        lens = np.minimum(split.lens, split.max_seq_len).astype(np.int32)
        if self.sharded:
            owner, offsets, cap = _partition_shards(lens, n_data)
            total = n_data * cap
            base = owner.astype(np.int64) * cap + offsets
        else:
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
        if self.sharded:
            host["owner"] = owner
            self.store = _put_sharded(host, self.data, cap, self.device)
        else:
            self.store = {k: torch.from_numpy(v).to(self.device)
                          for k, v in host.items()}

    def device_nbytes(self) -> int:
        """Resident bytes of this rank's store on its device."""
        return sum(t.numel() * t.element_size() for t in self.store.values())

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        """An index vector on the device. On a GPU it goes through pinned
        host memory without blocking; the caching host allocator keeps the
        pinned block until the copy has landed."""
        idx = torch.from_numpy(np.ascontiguousarray(idx))
        if self.device.type != "cuda":
            return idx.to(self.device)
        return idx.pin_memory().to(self.device, non_blocking=True)

    def batch(self, plan: BatchPlan, whole: bool = False) -> Batch:
        """Assemble the planned batch on the device: this rank's rows of
        it under a mesh, all of them with ``whole``. n_res and
        protein_mask are not read back: n_res is the plan's (the global
        batch's), and the device's protein_mask is the gather's live rows.
        With a sharded store every rank of 'data' must call it alike."""
        rows = (None if whole or self.mesh is None
                else batch_sharding(self.mesh).rows(len(plan.idx_padded)))
        if self.sharded:
            fields = _sharded_gather(self.store, self._index(plan.idx_padded),
                                     lb=plan.lb, pad_id=VOCAB.pad_id,
                                     data=self.data, rows=rows)
        else:
            idx = plan.idx_padded if rows is None else plan.idx_padded[rows]
            fields = gather_batch_fields(self.store, self._index(idx),
                                         lb=plan.lb, pad_id=VOCAB.pad_id)
        return Batch(*fields, n_res=plan.n_res)


class LazyBatch:
    """Batch facade for host bookkeeping on the device-data path.

    Loop bookkeeping needs only the cheap host fields (n_res, protein_mask,
    from the plan); the array fields materialise on first access by one
    gather of the whole global batch (every rank of a sharded store must
    ask alike), which the loop asks for only on the structure-logging
    cadence.
    """

    def __init__(self, store: DeviceStore, plan: BatchPlan):
        self._store, self._plan = store, plan
        self.n_res = plan.n_res
        self.protein_mask = plan.idx_padded >= 0
        self._dev: Batch | None = None

    def _materialize(self) -> Batch:
        if self._dev is None:
            self._dev = self._store.batch(self._plan, whole=True)
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


def auto_enabled(cfg, splits: Sequence[ProteinSplit],
                 process_count: int = 1, has_mesh: bool = True,
                 n_data: int = 1) -> bool:
    """Decide the device-data path: an explicit flag wins; 'auto' enables
    when the PER-DEVICE resident footprint of ``splits`` fits
    ``cfg.device_data_max_mb``: the store shards over the 'data' axis when
    it spans more than one rank, so the budget applies to the ~1/n_data
    shard. A multi-process run without a mesh has no store (no rank knows
    its rows)."""
    mode = getattr(cfg, "device_data", "auto")
    if process_count > 1 and not has_mesh:
        if mode in (True, "true", "on"):
            print("[device_data] forced off: multi-process without a mesh "
                  "cannot build a globally-addressed store")
        return False
    if mode in (True, "true", "on"):
        return True
    if mode in (False, "false", "off"):
        return False
    budget = getattr(cfg, "device_data_max_mb", 4096) * 1024 * 1024
    per_device = sum(store_nbytes(s) for s in splits) / max(n_data, 1)
    return per_device <= budget
