"""Automatic maximum-batch-size determination.

Port of protein_transformer_tpu/training/batch_probe.py. The reference forks
a child process that doubles the batch size until CUDA runs out of memory
(reference: scripts/determine_largest_batchsize.py:18-141,
train.py:532-551). As in the JAX package the probe runs in-process: one
training step at a candidate (B, L) either fits the device or raises an
out-of-memory error, which is caught; doubling, then binary search, finds
the frontier, and a safety fraction of it is kept (0.8, as in
train.py:532). Every other error propagates.

After a failed try the except block is left first (its traceback holds the
tried tensors), then ``gc.collect()`` and ``torch.cuda.empty_cache()``
return the memory before the next try.

Under a mesh every rank runs the sharded step of the try, and a try fits
only when it fits on every rank (``parallel.distributed.all_agree``), so
the ranks go on alike. The ranks are taken to run out of memory alike
(the same card and the same shapes): a rank that runs out inside a
collective that the others finish leaves them waiting.
"""
from __future__ import annotations

import gc
from typing import Callable

import numpy as np
import torch

DEFAULT_KEEP_FRACTION = 0.8

# Allocation failures that libraries surface as a plain RuntimeError rather
# than torch.cuda.OutOfMemoryError: a cuBLAS or cuDNN handle or workspace,
# and a raw CUDA out-of-memory status.
OOM_MESSAGES = ("CUBLAS_STATUS_ALLOC_FAILED", "CUDNN_STATUS_ALLOC_FAILED",
                "CUDA error: out of memory")


def _is_oom(exc: Exception) -> bool:
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and any(
        m in str(exc) for m in OOM_MESSAGES)


def _fits(try_batch: Callable[[int], None], b: int) -> bool:
    """try_batch(b): True when it returns, False when it runs out of
    memory; any other error propagates."""
    try:
        try_batch(b)
        return True
    except Exception as e:
        if not _is_oom(e):
            raise
    return False


def release_memory() -> None:
    """Return the memory of what is no longer referenced (a failed try's
    tensors, a dropped trainer): to the caching allocator, and the
    allocator's free blocks to the device."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def find_largest_batch_size(try_batch: Callable[[int], None],
                            start: int = 1, max_batch: int = 4096,
                            keep_fraction: float = DEFAULT_KEEP_FRACTION,
                            verbose: bool = True,
                            agree: Callable[[bool], bool] = bool) -> int:
    """Largest b for which try_batch(b) succeeds, scaled by keep_fraction.

    try_batch(b) must run one full training step at batch size b and raise
    on running out of memory; any other exception propagates. ``agree``
    turns this process's outcome of a try into the run's.
    """
    def attempt(b: int) -> bool:
        ok = agree(_fits(try_batch, b))
        if not ok:
            release_memory()
        if verbose:
            print(f"[batch-probe] b={b} {'fits' if ok else 'OOM'}")
        return ok

    # doubling phase
    b = start
    largest_ok = 0
    while b <= max_batch:
        if not attempt(b):
            break
        largest_ok = b
        b *= 2
    if largest_ok == 0:
        raise RuntimeError("even the starting batch size does not fit")
    # binary search between largest_ok and the first failure
    lo, hi = largest_ok, min(b, max_batch + 1)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if attempt(mid):
            lo = mid
        else:
            hi = mid
    result = max(1, int(lo * keep_fraction))
    if verbose:
        print(f"[batch-probe] max={lo}, using {result}")
    return result


def probe_trainer_batch_size(trainer, length: int | None = None,
                             **kwargs) -> int:
    """Probe the largest batch for a Trainer's configured model and loss, on
    the step its data path runs: a batch gathered from the device store
    when the store is on, a collated host batch otherwise; under a mesh the
    sharded step on every rank. Each try trains on copies of one template
    state (the step updates in place)."""
    from protein_transformer_tpu_torch.data.dataset import collate
    from protein_transformer_tpu_torch.data.device_store import plan_batch
    from protein_transformer_tpu_torch.parallel.distributed import all_agree

    length = length or trainer.dm.max_seq_len
    template = trainer.init_params(
        torch.Generator().manual_seed(trainer.cfg.seed))
    ds = trainer.dm.train

    def try_batch(b):
        idx = np.resize(np.arange(len(ds)), b)
        multiple = trainer.dm.batch_multiple
        if trainer.train_store is not None:
            batch = trainer.train_store.batch(
                plan_batch(ds, idx, (length,), length, multiple))
        else:
            batch = collate(ds, idx, (length,), length,
                            batch_multiple=multiple)
        _, out = trainer.train_step(trainer.state_from(template), batch)
        out.cpu()  # waits for the step

    return find_largest_batch_size(try_batch, agree=all_agree, **kwargs)
