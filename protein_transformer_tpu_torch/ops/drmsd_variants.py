"""Candidate rewrites of the dRMSD kernels, for the kernel-variant bench
(``tools/bench_drmsd_kernel.py`` of this package) only: the hand-written
CUDA kernels of ``csrc/drmsd_variants.cu`` and their plain versions.

They compute what ``ops/drmsd.py`` computes (S, C and dS/da over the valid
pairs i < j of each protein) by other arithmetic, the three kernel bodies of
the JAX package's ``tools/bench_drmsd_kernel.py``:

* K4a ``drmsd_stats_sqrt1_cuda`` -> (S, C) with each pair's term as
  d2a + d2b - 2 sqrt(d2a d2b), squared distances in difference form: one
  square root a pair; plain ``drmsd_stats_sqrt1_torch``;
* K4b ``drmsd_stats_mxu_cuda`` -> the same (S, C) with
  d2 = |x_i|^2 + |x_j|^2 - 2 x_i . x_j, the cross term as a matrix product;
  plain ``drmsd_stats_mxu_torch``;
* K4c ``drmsd_grad_a_mxu_cuda`` -> dS/da in that form, with
  coef = 2 w (1 - sqrt(d2b) rsqrt(d2a)), as a_i rowsum(coef) - coef a_j for
  the first atom of a pair and a_j colsum(coef) - coef^T a_i for the second;
  plain ``drmsd_grad_a_mxu_torch``.

Every squared distance is clamped at 1e-30. A kernel wrapper takes CUDA
tensors only and raises on anything else; a plain version runs on any device
over row blocks, in the dtype it is given, with its matrix products in full
precision whatever torch's TF32 setting is. Nothing but the bench reaches
this module: ``--drmsd_impl`` has no value for it.
"""
from __future__ import annotations

import contextlib

import torch

from protein_transformer_tpu_torch.ops.drmsd import (
    DIST_CLAMP, ROW_BLOCK, _check_cuda, _flatten, _launch, _lib)

LIBRARY = "drmsd_variants"


def _scratch(name: str, bsz: int, n: int, device, grad: bool):
    """Per-block partials: (S, C) per tile pair, or with grad the (3, tile)
    row and column partials of each tile pair."""
    tile = getattr(_lib(name), f"{name}_tile")()
    n_tiles = -(-n // tile)
    n_pairs = n_tiles * (n_tiles + 1) // 2
    if grad:
        return [torch.empty((bsz, n_pairs, 3, tile), dtype=torch.float32,
                            device=device) for _ in range(2)]
    return [torch.empty((bsz, n_pairs), dtype=torch.float32, device=device),
            torch.empty((bsz, n_pairs), dtype=torch.int32, device=device)]


@contextlib.contextmanager
def _full_precision_matmul():
    """float32 matrix products on a CUDA device in float32, not TF32."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _pair_mask(m, start, stop, cols):
    """(B, R, N) bool: both atoms unmasked and row index < column index."""
    return (m[:, start:stop, None] & m[:, None, :]
            & (cols[start:stop, None] < cols[None, :]))


def _d2_diff(x3, start, stop):
    """Clamped squared distances (B, R, N) of rows start:stop against all
    atoms, from the coordinate differences."""
    d2 = sum((x3[:, start:stop, None, k] - x3[:, None, :, k]) ** 2
             for k in range(3))
    return torch.clamp(d2, min=DIST_CLAMP)


def _d2_cross(x3, norms, start, stop):
    """The same from |x_i|^2 + |x_j|^2 - 2 x_i . x_j."""
    cross = torch.matmul(x3[:, start:stop], x3.transpose(1, 2))
    return torch.clamp((norms[:, start:stop, None] + norms[:, None, :])
                       - 2.0 * cross, min=DIST_CLAMP)


def _stats(a, b, mask, d2_of):
    """(S, C) with the one-root pair term, over row blocks; d2_of(x3, start,
    stop) gives the clamped squared distances of a row block."""
    a3, b3, m, lead = _flatten(a, b, mask)
    bsz, n, _ = a3.shape
    s = torch.zeros(bsz, dtype=a.dtype, device=a.device)
    c = torch.zeros(bsz, dtype=torch.int64, device=a.device)
    cols = torch.arange(n, device=a.device)
    for start in range(0, n, ROW_BLOCK):
        stop = min(start + ROW_BLOCK, n)
        pair = _pair_mask(m, start, stop, cols)
        d2a, d2b = d2_of(a3, start, stop), d2_of(b3, start, stop)
        term = (d2a + d2b) - 2.0 * torch.sqrt(d2a * d2b)
        s = s + torch.where(pair, term, 0.0).sum(dim=(1, 2))
        c = c + pair.sum(dim=(1, 2))
    return s.reshape(lead), c.reshape(lead)


def drmsd_stats_sqrt1_torch(a: torch.Tensor, b: torch.Tensor,
                            mask: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (S, C) of K4a. a, b: (..., N, 3); mask: (..., N).
    Returns S (...,) in a's dtype and C (...,) int64."""
    return _stats(a, b, mask, _d2_diff)


def drmsd_stats_mxu_torch(a: torch.Tensor, b: torch.Tensor,
                          mask: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (S, C) of K4b; shapes as ``drmsd_stats_sqrt1_torch``."""
    with _full_precision_matmul():
        return _stats(a, b, mask, lambda x3, start, stop: _d2_cross(
            x3, (x3 * x3).sum(-1), start, stop))


def drmsd_grad_a_mxu_torch(a: torch.Tensor, b: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch dS/da of K4c, of a's shape (..., N, 3)."""
    a3, b3, m, _ = _flatten(a, b, mask)
    n = a3.shape[1]
    g = torch.zeros_like(a3)
    cols = torch.arange(n, device=a.device)
    na, nb = (a3 * a3).sum(-1), (b3 * b3).sum(-1)
    with _full_precision_matmul():
        for start in range(0, n, ROW_BLOCK):
            stop = min(start + ROW_BLOCK, n)
            pair = _pair_mask(m, start, stop, cols)
            d2a = _d2_cross(a3, na, start, stop)
            d2b = _d2_cross(b3, nb, start, stop)
            coef = torch.where(
                pair, 2.0 * (1.0 - torch.sqrt(d2b) * torch.rsqrt(d2a)), 0.0)
            rows = a3[:, start:stop]
            g[:, start:stop] += (rows * coef.sum(2)[..., None]
                                 - torch.matmul(coef, a3))
            g += (a3 * coef.sum(1)[..., None]
                  - torch.matmul(coef.transpose(1, 2), rows))
    return g.reshape(a.shape)


def _stats_cuda(wrapper, fn: str, a, b, mask):
    _check_cuda(wrapper.__name__, a, b, mask)
    lead, n = a.shape[:-2], a.shape[-2]
    bsz = mask.numel() // max(n, 1)
    out_s = torch.zeros(lead, dtype=torch.float32, device=a.device)
    out_c = torch.zeros(lead, dtype=torch.int64, device=a.device)
    if bsz == 0 or n == 0:
        return out_s, out_c
    part_s, part_c = _scratch(LIBRARY, bsz, n, a.device, grad=False)
    _launch(LIBRARY, fn, a, b, mask, part_s.data_ptr(), part_c.data_ptr(),
            out_s.data_ptr(), out_c.data_ptr())
    wrapper.launches += 1
    return out_s, out_c


def drmsd_stats_sqrt1_cuda(a: torch.Tensor, b: torch.Tensor,
                           mask: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4a: (S, C) from the CUDA kernel, one launch for the whole batch.

    a, b: (..., N, 3) float32, mask (..., N) bool, contiguous, on one CUDA
    device. Raises for any other input, and if the kernel fails to build or
    launch. Adds one to ``drmsd_stats_sqrt1_cuda.launches`` per launch."""
    return _stats_cuda(drmsd_stats_sqrt1_cuda, "drmsd_fwd_sqrt1", a, b, mask)


drmsd_stats_sqrt1_cuda.launches = 0


def drmsd_stats_mxu_cuda(a: torch.Tensor, b: torch.Tensor,
                         mask: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4b: (S, C) from the CUDA kernel, the cross terms on the tensor
    cores. Takes what ``drmsd_stats_sqrt1_cuda`` takes; adds one to
    ``drmsd_stats_mxu_cuda.launches`` per launch."""
    return _stats_cuda(drmsd_stats_mxu_cuda, "drmsd_fwd_mxu", a, b, mask)


drmsd_stats_mxu_cuda.launches = 0


def drmsd_grad_a_mxu_cuda(a: torch.Tensor, b: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """K4c: dS/da from the CUDA kernel, cross terms and coef products on
    the tensor cores. Takes what ``drmsd_stats_sqrt1_cuda`` takes; adds one
    to ``drmsd_grad_a_mxu_cuda.launches`` per launch."""
    _check_cuda("drmsd_grad_a_mxu_cuda", a, b, mask)
    n = a.shape[-2]
    bsz = mask.numel() // max(n, 1)
    if bsz == 0 or n == 0:
        return torch.zeros_like(a)
    out_g = torch.empty_like(a)  # the epilogue writes every atom
    part_row, part_col = _scratch(LIBRARY, bsz, n, a.device, grad=True)
    _launch(LIBRARY, "drmsd_grad_a_mxu", a, b, mask, part_row.data_ptr(),
            part_col.data_ptr(), out_g.data_ptr())
    drmsd_grad_a_mxu_cuda.launches += 1
    return out_g


drmsd_grad_a_mxu_cuda.launches = 0
