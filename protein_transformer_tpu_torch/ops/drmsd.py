"""Masked dRMSD statistics: the hand-written CUDA kernel and its plain version.

For each protein of a batch, over the valid pairs i < j (both atoms
unmasked), the statistics are

    S = sum (|a_i - a_j| - |b_i - b_j|)^2        C = number of pairs,

with each distance taken as d2 * rsqrt(max(d2, 1e-30)), as in the TPU kernel
``protein_transformer_tpu/ops/drmsd_pallas.py::_fwd_kernel_rsqrt``.

* ``drmsd_stats_cuda`` launches ``csrc/drmsd_fwd.cu`` on a CUDA tensor, for
  the whole batch at once. It raises on anything else.
* ``drmsd_stats_torch`` is the plain PyTorch version: tiled over row blocks,
  distances in difference form, the same clamp. The CPU tests run it, and
  ``chip_smoke.py`` holds the kernel against it on the card.
* ``drmsd_stats`` picks one by ``impl``; "auto" resolves by the tensors'
  device.

Counts come back as int64 from both: fp32 counts inexactly above 2^24 pairs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from protein_transformer_tpu_torch.ops import _build

DIST_CLAMP = 1e-30
# Row-block size of the plain version (rows x N distances per step).
ROW_BLOCK = 512

IMPLS = ("auto", "cuda", "torch")


def resolve_impl(impl: str, device: torch.device) -> str:
    """'auto' -> 'cuda' for tensors on a CUDA device, else 'torch'."""
    if impl not in IMPLS:
        raise ValueError(f"unknown dRMSD impl {impl!r}; expected one of "
                         f"{IMPLS}")
    if impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return impl


def _flatten(a, b, mask):
    if a.shape != b.shape or a.shape[-1] != 3 or mask.shape != a.shape[:-1]:
        raise ValueError(f"expected a, b (..., N, 3) and mask (..., N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(mask.shape)}")
    n = a.shape[-2]
    return (a.reshape(-1, n, 3), b.reshape(-1, n, 3),
            mask.reshape(-1, n).bool(), a.shape[:-2])


def drmsd_stats_torch(a: torch.Tensor, b: torch.Tensor,
                      mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (S, C) over valid i < j pairs.

    a, b: (..., N, 3) float32; mask: (..., N). Returns S (...,) float32 and
    C (...,) int64. Works on row blocks of ROW_BLOCK atoms so the (N, N)
    matrices are never held whole."""
    a3, b3, m, lead = _flatten(a, b, mask)
    bsz, n, _ = a3.shape
    s = torch.zeros(bsz, dtype=a.dtype, device=a.device)
    c = torch.zeros(bsz, dtype=torch.int64, device=a.device)
    cols = torch.arange(n, device=a.device)

    def dist(x_blk, x):
        d2 = None
        for k in range(3):
            diff = x_blk[:, :, None, k] - x[:, None, :, k]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        d2 = torch.clamp(d2, min=DIST_CLAMP)
        return d2 * torch.rsqrt(d2)

    for start in range(0, n, ROW_BLOCK):
        stop = min(start + ROW_BLOCK, n)
        rows = cols[start:stop]
        pair = (m[:, start:stop, None] & m[:, None, :]
                & (rows[:, None] < cols[None, :]))
        diff = dist(a3[:, start:stop], a3) - dist(b3[:, start:stop], b3)
        s = s + torch.where(pair, diff * diff, 0.0).sum(dim=(1, 2))
        c = c + pair.sum(dim=(1, 2))
    return s.reshape(lead), c.reshape(lead)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared (pointers
    as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = _build.load("drmsd_fwd")
    p = ctypes.c_void_p
    lib.drmsd_fwd.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int,
                              p, p, p, p, p]
    lib.drmsd_fwd.restype = ctypes.c_int
    lib.drmsd_fwd_tile.argtypes = []
    lib.drmsd_fwd_tile.restype = ctypes.c_int
    lib.drmsd_fwd_error_string.argtypes = [ctypes.c_int]
    lib.drmsd_fwd_error_string.restype = ctypes.c_char_p
    return lib


def drmsd_stats_cuda(a: torch.Tensor, b: torch.Tensor,
                     mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, C) from the CUDA kernel, one launch for the whole batch.

    a, b: (..., N, 3) float32 on a CUDA device; mask: (..., N) on the same
    device. Raises for any other input, and if the kernel fails to build or
    launch. Adds one to ``drmsd_stats_cuda.launches`` per launch."""
    if a.device.type != "cuda" or b.device != a.device \
            or mask.device != a.device:
        raise ValueError(
            "drmsd_stats_cuda needs a, b and mask on one CUDA device; got "
            f"{a.device}, {b.device}, {mask.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"drmsd_stats_cuda takes float32; got {a.dtype}, "
                        f"{b.dtype}")
    a3, b3, m, lead = _flatten(a, b, mask)
    bsz, n, _ = a3.shape
    if bsz == 0 or n == 0:
        return (torch.zeros(lead, dtype=a.dtype, device=a.device),
                torch.zeros(lead, dtype=torch.int64, device=a.device))
    # a bool tensor is one byte per element, 0 or 1: the kernel reads it
    # as uint8 without a conversion pass
    a3, b3, m = a3.contiguous(), b3.contiguous(), m.contiguous()
    lib = _lib()
    n_tiles = -(-n // lib.drmsd_fwd_tile())
    n_pairs = n_tiles * (n_tiles + 1) // 2
    part_s = torch.empty((bsz, n_pairs), dtype=torch.float32, device=a.device)
    part_c = torch.empty((bsz, n_pairs), dtype=torch.int32, device=a.device)
    out_s = torch.empty(bsz, dtype=torch.float32, device=a.device)
    out_c = torch.empty(bsz, dtype=torch.int64, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.drmsd_fwd(a3.data_ptr(), b3.data_ptr(), m.data_ptr(), bsz,
                            n, part_s.data_ptr(), part_c.data_ptr(),
                            out_s.data_ptr(), out_c.data_ptr(), stream)
    if err:
        raise RuntimeError("drmsd_fwd kernel launch failed: "
                           + lib.drmsd_fwd_error_string(err).decode())
    drmsd_stats_cuda.launches += 1
    return out_s.reshape(lead), out_c.reshape(lead)


drmsd_stats_cuda.launches = 0


def drmsd_stats(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """(S, C) by the kernel ('cuda') or the plain version ('torch')."""
    if resolve_impl(impl, a.device) == "cuda":
        return drmsd_stats_cuda(a, b, mask)
    return drmsd_stats_torch(a, b, mask)
