"""Host-side data pipeline for the port: splits, bucketed collation, loading.

Port of protein_transformer_tpu/data/dataset.py: splits, the binned
training sampler with its residue budget, and collation. Batches carry
zero-filled arrays plus explicit boolean masks, padded to a bucketed (B, L)
shape lattice. Sampling and collation are numpy on the host, draw for draw
and element for element the JAX package's, so one ``np.random.Generator``
gives the same batches in both; ``Batch.to(device)`` moves a batch onto a
torch device (``data/device_store.py`` assembles the same batch on the
device instead).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from protein_transformer_tpu_torch.protein.constants import (
    MAX_SEQ_LEN, NUM_PREDICTED_ANGLES, NUM_PREDICTED_COORDS)
from protein_transformer_tpu_torch.protein.vocab import VOCAB

VALID_SPLITS = (10, 20, 30, 40, 50, 70, 90)
ALL_SPLITS = ("train",) + tuple(f"valid-{s}" for s in VALID_SPLITS) + ("test",)


@dataclasses.dataclass
class Batch:
    """One padded batch with explicit masks: numpy arrays from ``collate``,
    torch tensors after ``to(device)``."""
    seq: np.ndarray | torch.Tensor          # (B, L) ids, pad_id at padding
    ang: np.ndarray | torch.Tensor          # (B, L, 24) f32, zero where masked
    ang_mask: np.ndarray | torch.Tensor     # (B, L, 24) bool
    crd: np.ndarray | torch.Tensor          # (B, L, 14, 3) f32, zero where masked
    crd_mask: np.ndarray | torch.Tensor     # (B, L, 14) bool
    protein_mask: np.ndarray | torch.Tensor  # (B,) bool: row is a real protein
    n_res: int                               # real residues (throughput)

    def to(self, device: torch.device, non_blocking: bool = False
           ) -> "Batch":
        """The same batch as torch tensors on ``device`` (ids as int64); a
        field already there is used as it is, without a copy. With
        non_blocking, host arrays bound for a GPU go through pinned memory
        and the copies do not wait: the caller orders their use (the caching
        host allocator keeps each pinned block until its copy has landed)."""
        pin = non_blocking and torch.device(device).type == "cuda"

        def put(x):
            t = torch.as_tensor(x)
            if pin and t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(device, non_blocking=non_blocking)
        return Batch(put(self.seq).long(), put(self.ang), put(self.ang_mask),
                     put(self.crd), put(self.crd_mask),
                     put(self.protein_mask), self.n_res)


class ProteinSplit:
    """One split: ragged (seq string, angles (L, 24), coords (L*14, 3)).

    Inputs use the reference's storage conventions (NaN = missing); the
    stored views are zero-filled, with the NaN pattern kept in masks."""

    def __init__(self, seqs, angs, crds, ids=None,
                 skip_missing_residues=True, max_seq_len=MAX_SEQ_LEN):
        self.seqs, self.angs, self.crds, self.ids = [], [], [], []
        self.seq_enc: list[np.ndarray] = []
        self.ang_masks: list[np.ndarray] = []
        self.crd_masks: list[np.ndarray] = []
        ids = ids if ids is not None else [f"p{i}" for i in range(len(seqs))]
        for i in range(len(seqs)):
            ang = np.asarray(angs[i], np.float32)
            # skip proteins with fully-missing residues
            if skip_missing_residues and np.isnan(ang).all(axis=-1).any():
                continue
            crd = np.asarray(crds[i], np.float32)
            self.seqs.append(seqs[i])
            self.ids.append(ids[i])
            self.seq_enc.append(VOCAB.str2array(seqs[i][:max_seq_len]))
            ang_mask = np.isfinite(ang)
            self.ang_masks.append(ang_mask)
            self.crd_masks.append(
                np.isfinite(crd).all(-1).reshape(-1, NUM_PREDICTED_COORDS))
            self.angs.append(np.where(ang_mask, ang, 0.0))
            self.crds.append(np.where(np.isfinite(crd), crd, 0.0))
        self.lens = np.array(
            [min(len(s), max_seq_len) for s in self.seqs], np.int64)
        self.max_seq_len = max_seq_len

    def __len__(self):
        return len(self.seqs)


class BinnedDataset(ProteinSplit):
    """A split with length-histogram bins, for the training sampler."""

    def __init__(self, *args, bins="auto", **kwargs):
        super().__init__(*args, **kwargs)
        self.hist_counts, edges = np.histogram(self.lens, bins=bins)
        self.hist_bins = edges[1:]  # right edge of each bin: '( , ]'
        self.bin_probs = self.hist_counts / max(self.hist_counts.sum(), 1)
        bin_of = np.minimum(
            np.searchsorted(self.hist_bins, self.lens, side="left"),
            len(self.hist_bins) - 1)
        self.bin_map: dict[int, np.ndarray] = {
            int(b): np.flatnonzero(bin_of == b) for b in np.unique(bin_of)}


def binned_batch_sampler(ds: BinnedDataset, batch_size: int,
                         dynamic_batch: Optional[int],
                         rng: np.random.Generator,
                         downsample: Optional[float] = None,
                         repeat_train: int = 1) -> Iterator[np.ndarray]:
    """Arrays of dataset indices, one batch at a time: a length bin drawn
    by its share of the split, then rows drawn from it with replacement.
    dynamic_batch is the residue budget; a bin's batch holds
    budget // (the bin's right edge) rows. downsample scales the number of
    batches (the --eval_train pass over a share of the train set)."""
    if dynamic_batch:
        n_batches = int(np.ceil(ds.lens.sum() * repeat_train
                                * (downsample or 1.0) / dynamic_batch))
    else:
        n_batches = int(np.ceil(len(ds) * repeat_train
                                * (downsample or 1.0) / batch_size))
    bins_with_items = [b for b in range(len(ds.hist_bins))
                       if len(ds.bin_map.get(b, ())) > 0]
    probs = np.array([ds.bin_probs[b] for b in bins_with_items])
    probs = probs / probs.sum()
    for _ in range(n_batches):
        b = rng.choice(bins_with_items, p=probs)
        if dynamic_batch:
            this_bs = max(1, int(dynamic_batch / ds.hist_bins[b]))
        else:
            this_bs = batch_size
        yield rng.choice(ds.bin_map[b], size=this_bs)


def bucket_length(length: int, buckets: Sequence[int], max_len: int) -> int:
    """Smallest bucket >= length (clamped to max_len)."""
    length = min(length, max_len)
    for b in buckets:
        if b >= length:
            return min(b, max_len)
    return max_len


BATCH_BUCKETS = (1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def bucket_batch_size(n: int, multiple: int = 1) -> int:
    """Smallest batch bucket >= n that is a multiple of ``multiple`` (the
    'data' mesh axis size: batches shard evenly over its ranks); the rows
    beyond n are masked dummies."""
    for b in BATCH_BUCKETS:
        if b >= n and b % multiple == 0:
            return b
    return ((n + multiple - 1) // multiple) * multiple


def collate(split: ProteinSplit, indices: np.ndarray,
            length_buckets: Sequence[int],
            max_seq_len: int = MAX_SEQ_LEN, pad_batch: bool = True,
            batch_multiple: int = 1) -> Batch:
    """Assemble a static-shape masked batch (numpy) from dataset rows;
    pad_batch pads the rows to ``bucket_batch_size(n, batch_multiple)``."""
    lens = [min(int(split.lens[i]), max_seq_len) for i in indices]
    lmax = bucket_length(max(lens), length_buckets, max_seq_len)
    b = (bucket_batch_size(len(indices), batch_multiple) if pad_batch
         else len(indices))

    seq = np.full((b, lmax), VOCAB.pad_id, np.int32)
    ang = np.zeros((b, lmax, NUM_PREDICTED_ANGLES * 2), np.float32)
    ang_mask = np.zeros((b, lmax, NUM_PREDICTED_ANGLES * 2), bool)
    crd = np.zeros((b, lmax, NUM_PREDICTED_COORDS, 3), np.float32)
    crd_mask = np.zeros((b, lmax, NUM_PREDICTED_COORDS), bool)
    protein_mask = np.zeros((b,), bool)
    for row, idx in enumerate(indices):
        li = lens[row]
        seq[row, :li] = split.seq_enc[idx][:li]
        ang[row, :li] = split.angs[idx][:li]
        ang_mask[row, :li] = split.ang_masks[idx][:li]
        crd[row, :li] = split.crds[idx][: li * NUM_PREDICTED_COORDS].reshape(
            li, NUM_PREDICTED_COORDS, 3)
        crd_mask[row, :li] = split.crd_masks[idx][:li]
        protein_mask[row] = True
    return Batch(seq, ang, ang_mask, crd, crd_mask, protein_mask,
                 n_res=int(sum(lens)))


def load_reference_pt(path: str) -> dict:
    """Load a reference-schema torch .pt dataset dict."""
    return torch.load(path, weights_only=False)


def load_native(path: str) -> dict:
    """Load the native .npz shard directory (protein_transformer_tpu's
    data/convert.py layout)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = {"settings": manifest["settings"], "date": manifest.get("date")}
    for split in manifest["splits"]:
        with np.load(os.path.join(path, f"{split}.npz"),
                     allow_pickle=False) as z:
            offs = z["offsets"]
            seqs = [str(s) for s in z["seqs"]]
            ang_flat, crd_flat = z["ang"], z["crd"]
            ids = [str(s) for s in z["ids"]]
        angs = [ang_flat[offs[i]:offs[i + 1]] for i in range(len(seqs))]
        crds = [crd_flat[offs[i] * NUM_PREDICTED_COORDS:
                         offs[i + 1] * NUM_PREDICTED_COORDS]
                for i in range(len(seqs))]
        data[split] = {"seq": seqs, "ang": angs, "crd": crds, "ids": ids}
    return data


def load_dataset(path: str) -> dict:
    if os.path.isdir(path):
        return load_native(path)
    return load_reference_pt(path)


class DataModule:
    """Splits, the training sampler and collation; every batch's rows are
    padded to a multiple of ``batch_multiple``, the 'data' mesh axis
    size."""

    def __init__(self, data: dict, cfg, batch_multiple: int = 1):
        self.cfg = cfg
        self.batch_multiple = batch_multiple
        settings = data.get("settings", {})
        self.angle_means = np.asarray(
            settings.get("angle_means",
                         np.zeros(NUM_PREDICTED_ANGLES * 2)), np.float32)
        self.max_seq_len = min(int(settings.get("max_len", cfg.max_seq_len))
                               if settings.get("max_len") else cfg.max_seq_len,
                               cfg.max_seq_len)
        self.train = None
        if "train" in data:
            self.train = BinnedDataset(
                data["train"]["seq"], data["train"]["ang"],
                data["train"]["crd"], ids=data["train"].get("ids"),
                skip_missing_residues=cfg.skip_missing_res_train,
                max_seq_len=self.max_seq_len,
                bins="auto" if cfg.bins == -1 else cfg.bins)
        self.eval_splits: dict[str, ProteinSplit] = {}
        for split in ALL_SPLITS[1:]:
            if split in data:
                self.eval_splits[split] = ProteinSplit(
                    data[split]["seq"], data[split]["ang"],
                    data[split]["crd"], ids=data[split].get("ids"),
                    skip_missing_residues=cfg.skip_missing_res_train,
                    max_seq_len=self.max_seq_len)

    def train_index_batches(self,
                            rng: np.random.Generator) -> Iterator[np.ndarray]:
        """Per-batch dataset index arrays for one training epoch."""
        cfg = self.cfg
        if cfg.batching_order in ("descending", "ascending"):
            order = np.argsort(self.train.lens)
            if cfg.batching_order == "descending":
                order = order[::-1]
            for _ in range(cfg.repeat_train):
                for start in range(0, len(order), cfg.batch_size):
                    yield order[start:start + cfg.batch_size]
            return
        # The residue budget uses the MAX_SEQ_LEN constant even when the
        # dataset's own maximum length is smaller, as the JAX package and
        # the original code do: per-bin batch sizes do not shrink on
        # short-protein datasets.
        yield from binned_batch_sampler(
            self.train, cfg.batch_size,
            dynamic_batch=cfg.batch_size * MAX_SEQ_LEN,
            rng=rng, repeat_train=cfg.repeat_train)

    def train_batches(self, rng: np.random.Generator) -> Iterator[Batch]:
        for idx in self.train_index_batches(rng):
            yield collate(self.train, idx, self.cfg.bucket_sizes,
                          self.max_seq_len,
                          batch_multiple=self.batch_multiple)

    def train_eval_index_batches(
            self, rng: np.random.Generator) -> Iterator[np.ndarray]:
        """Index batches of fixed size over a downsampled train set."""
        cfg = self.cfg
        yield from binned_batch_sampler(
            self.train, cfg.batch_size, dynamic_batch=None, rng=rng,
            downsample=cfg.train_eval_downsample)

    def train_eval_batches(self, rng: np.random.Generator) -> Iterator[Batch]:
        """The --eval_train pass: fixed-size batches over a downsampled
        train set."""
        for idx in self.train_eval_index_batches(rng):
            yield collate(self.train, idx, self.cfg.bucket_sizes,
                          self.max_seq_len,
                          batch_multiple=self.batch_multiple)

    def eval_index_batches(self, split: str) -> Iterator[np.ndarray]:
        ds = self.eval_splits[split]
        order = np.argsort(-ds.lens)  # length-sorted like the reference loader
        for start in range(0, len(ds), self.cfg.batch_size):
            yield order[start:start + self.cfg.batch_size]

    def eval_batches(self, split: str) -> Iterator[Batch]:
        ds = self.eval_splits[split]
        for idx in self.eval_index_batches(split):
            yield collate(ds, idx, self.cfg.bucket_sizes, self.max_seq_len,
                          batch_multiple=self.batch_multiple)
