"""Masked dRMSD statistics and their gradients: the hand-written CUDA kernels
and their plain versions.

For each protein of a batch, over the valid pairs i < j (both atoms
unmasked), the statistics are

    S = sum (|a_i - a_j| - |b_i - b_j|)^2        C = number of pairs,

with each distance taken as D = d2 * rsqrt(max(d2, 1e-30)), as in the TPU
kernels of ``protein_transformer_tpu/ops/drmsd_pallas.py``. Their raw
gradients are, with delta = Da - Db,

    dS/da_k = sum_{j>k} coef_kj (a_k - a_j) - sum_{i<k} coef_ik (a_i - a_k),
    coef = 2 delta / Da,

and dS/db the same with the differences of b and coef = -2 delta / Db.

Three kernels, each with its plain PyTorch version beside it:

* K1a ``drmsd_stats_cuda`` (``csrc/drmsd_fwd.cu``) -> (S, C); plain
  ``drmsd_stats_torch``;
* K1b ``drmsd_stats_grad_cuda`` (``csrc/drmsd_train.cu``) -> (S, C, dS/da)
  in one sweep, S with the same bits as K1a's; plain
  ``drmsd_stats_grad_torch``;
* K1c ``drmsd_grad_b_cuda`` (``csrc/drmsd_train.cu``) -> dS/db; plain
  ``drmsd_grad_b_torch``.

The three are instances of one kernel body (``csrc/drmsd_common.cuh``,
"K1"): each block compacts the valid atoms of its two tiles and sweeps valid
pairs only, once each. A call is two launches and no fill: the outputs are
``torch.empty`` and written in full by the kernels, and the scratch is one
uninitialised allocation.

A kernel wrapper takes CUDA tensors only and raises on anything else. The
plain versions run on any device, over row blocks of explicit formulas, so
the (N, N) matrices are never held whole; the CPU tests run them, and
``chip_smoke.py`` holds the kernels against them on the card.

``DrmsdStats`` is the differentiable (S, C), the counterpart of the JAX
package's ``custom_vjp``: K1b when a needs a gradient, else K1a; K1c in the
backward only when b needs a gradient. ``drmsd_stats`` applies it when
autograd will want a gradient and runs the forward statistics alone
otherwise; its ``impl`` is "cuda", "torch" or "auto" (by the tensors'
device).

Counts come back as int64: fp32 counts inexactly above 2^24 pairs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from protein_transformer_tpu_torch.ops import _build

DIST_CLAMP = 1e-30
# Row-block size of the plain versions (rows x N distances per step).
ROW_BLOCK = 512

# (impl, device) -> "cuda" or "torch" (``_build.resolve_impl``)
resolve_impl = functools.partial(_build.resolve_impl, what="dRMSD")


def _flatten(a, b, mask):
    if a.shape != b.shape or a.shape[-1] != 3 or mask.shape != a.shape[:-1]:
        raise ValueError(f"expected a, b (..., N, 3) and mask (..., N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(mask.shape)}")
    n = a.shape[-2]
    return (a.reshape(-1, n, 3), b.reshape(-1, n, 3),
            mask.reshape(-1, n).bool(), a.shape[:-2])


def _row_block(x3, start, stop):
    """Differences x_i - x_j (three (B, R, N) tensors), distances D and
    1/D = rsqrt(d2) for the rows start:stop against all atoms."""
    diffs = [x3[:, start:stop, None, k] - x3[:, None, :, k] for k in range(3)]
    d2 = diffs[0] * diffs[0] + diffs[1] * diffs[1] + diffs[2] * diffs[2]
    d2 = torch.clamp(d2, min=DIST_CLAMP)
    r = torch.rsqrt(d2)
    return diffs, d2 * r, r


def _sweep(a, b, mask, grad: str | None):
    """Plain (S, C) and, for grad "a" or "b", dS/da or dS/db, over row
    blocks of ROW_BLOCK atoms."""
    a3, b3, m, lead = _flatten(a, b, mask)
    bsz, n, _ = a3.shape
    s = torch.zeros(bsz, dtype=a.dtype, device=a.device)
    c = torch.zeros(bsz, dtype=torch.int64, device=a.device)
    g = torch.zeros_like(a3) if grad else None
    cols = torch.arange(n, device=a.device)
    for start in range(0, n, ROW_BLOCK):
        stop = min(start + ROW_BLOCK, n)
        rows = cols[start:stop]
        pair = (m[:, start:stop, None] & m[:, None, :]
                & (rows[:, None] < cols[None, :]))
        diffs_a, da, ra = _row_block(a3, start, stop)
        diffs_b, db, rb = _row_block(b3, start, stop)
        delta = torch.where(pair, da - db, 0.0)
        s = s + (delta * delta).sum(dim=(1, 2))
        c = c + pair.sum(dim=(1, 2))
        if grad:
            coef, diffs = ((2 * delta * ra, diffs_a) if grad == "a"
                           else (-2 * delta * rb, diffs_b))
            for k in range(3):
                gk = coef * diffs[k]
                g[:, start:stop, k] += gk.sum(dim=2)
                g[:, :, k] -= gk.sum(dim=1)
    g = g.reshape(a.shape) if grad else None
    return s.reshape(lead), c.reshape(lead), g


def drmsd_stats_torch(a: torch.Tensor, b: torch.Tensor,
                      mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (S, C) over valid i < j pairs.

    a, b: (..., N, 3) float32; mask: (..., N). Returns S (...,) float32 and
    C (...,) int64."""
    s, c, _ = _sweep(a, b, mask, None)
    return s, c


def drmsd_stats_grad_torch(a: torch.Tensor, b: torch.Tensor,
                           mask: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain PyTorch (S, C, dS/da); dS/da has a's shape (..., N, 3)."""
    return _sweep(a, b, mask, "a")


def drmsd_grad_b_torch(a: torch.Tensor, b: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch dS/db, of b's shape (..., N, 3)."""
    return _sweep(a, b, mask, "b")[2]


# Each library's launch functions, as (pointers before, pointers after) the
# (int batch, int n) pair of ``int fn(...)``; the stream is the last pointer.
_LAUNCHERS = {"drmsd_fwd": {"drmsd_fwd": (3, 4)},
              "drmsd_train": {"drmsd_fwd_grad": (3, 5),
                              "drmsd_grad_b": (3, 3)},
              # the bench's variants (ops/drmsd_variants.py)
              "drmsd_variants": {"drmsd_fwd_sqrt1": (3, 5),
                                 "drmsd_fwd_mxu": (3, 5),
                                 "drmsd_grad_a_mxu": (3, 4)}}
# K1's libraries also export ``<name>_scratch_bytes(int batch, int n)``, the
# variants' library ``<name>_tile()``.
_K1_LIBRARIES = ("drmsd_fwd", "drmsd_train")


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """The built kernel library ``name`` with its C signatures declared:
    pointers as c_void_p, so ctypes never truncates them to 32 bits."""
    lib = _build.load(name)
    p = ctypes.c_void_p
    for fn, (before, after) in _LAUNCHERS[name].items():
        f = getattr(lib, fn)
        f.argtypes = [p] * before + [ctypes.c_int, ctypes.c_int] + [p] * after
        f.restype = ctypes.c_int
    if name in _K1_LIBRARIES:
        size = getattr(lib, f"{name}_scratch_bytes")
        size.argtypes = [ctypes.c_int, ctypes.c_int]
        size.restype = ctypes.c_longlong
    else:
        tile = getattr(lib, f"{name}_tile")
        tile.argtypes, tile.restype = [], ctypes.c_int
    err_string = getattr(lib, f"{name}_error_string")
    err_string.argtypes, err_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def _check_cuda(fn: str, a, b, mask) -> None:
    """What every kernel wrapper takes: float32 a, b (..., N, 3) and a bool
    mask (..., N), contiguous, on one CUDA device."""
    if a.device.type != "cuda" or b.device != a.device \
            or mask.device != a.device:
        raise ValueError(f"{fn} needs a, b and mask on one CUDA device; got "
                         f"{a.device}, {b.device}, {mask.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32 \
            or mask.dtype != torch.bool:
        raise TypeError(f"{fn} takes float32 a, b and a bool mask; got "
                        f"{a.dtype}, {b.dtype}, {mask.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()
            and mask.is_contiguous()):
        raise ValueError(f"{fn} takes contiguous tensors")
    _flatten(a, b, mask)  # raises on mismatched shapes


def _launch(name: str, fn: str, a, b, mask, *ptrs) -> None:
    """Call ``fn`` of library ``name`` on the current stream; raise on a
    non-zero CUDA error code. A bool tensor is one byte per element, 0 or 1:
    the kernels read the mask as uint8 without a conversion pass."""
    bsz, n = mask.numel() // mask.shape[-1], mask.shape[-1]
    _build.launch(_lib(name), name, fn, a.device, a.data_ptr(), b.data_ptr(),
                  mask.data_ptr(), bsz, n, *ptrs)


def _k1_scratch(name: str, bsz: int, n: int, device) -> torch.Tensor:
    """K1's scratch, one uninitialised allocation of the size the library
    asks for: the kernels write every byte they read."""
    size = getattr(_lib(name), f"{name}_scratch_bytes")(bsz, n)
    return torch.empty(size, dtype=torch.uint8, device=device)


def drmsd_stats_cuda(a: torch.Tensor, b: torch.Tensor,
                     mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1a: (S, C) from the CUDA kernel, one launch for the whole batch.

    a, b: (..., N, 3) float32, mask (..., N) bool, contiguous, on one CUDA
    device. Raises for any other input, and if the kernel fails to build or
    launch. Adds one to ``drmsd_stats_cuda.launches`` per launch."""
    _check_cuda("drmsd_stats_cuda", a, b, mask)
    lead, n = a.shape[:-2], a.shape[-2]
    bsz = mask.numel() // max(n, 1)
    if bsz == 0 or n == 0:
        return (torch.zeros(lead, dtype=torch.float32, device=a.device),
                torch.zeros(lead, dtype=torch.int64, device=a.device))
    out_s = torch.empty(lead, dtype=torch.float32, device=a.device)
    out_c = torch.empty(lead, dtype=torch.int64, device=a.device)
    scratch = _k1_scratch("drmsd_fwd", bsz, n, a.device)
    _launch("drmsd_fwd", "drmsd_fwd", a, b, mask, scratch.data_ptr(),
            out_s.data_ptr(), out_c.data_ptr())
    drmsd_stats_cuda.launches += 1
    return out_s, out_c


drmsd_stats_cuda.launches = 0


def drmsd_stats_grad_cuda(a: torch.Tensor, b: torch.Tensor,
                          mask: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K1b: (S, C, dS/da) from the CUDA kernel in one sweep, S with the
    same bits as ``drmsd_stats_cuda``'s. Takes what ``drmsd_stats_cuda``
    takes; adds one to ``drmsd_stats_grad_cuda.launches`` per launch."""
    _check_cuda("drmsd_stats_grad_cuda", a, b, mask)
    lead, n = a.shape[:-2], a.shape[-2]
    bsz = mask.numel() // max(n, 1)
    if bsz == 0 or n == 0:
        return (torch.zeros(lead, dtype=torch.float32, device=a.device),
                torch.zeros(lead, dtype=torch.int64, device=a.device),
                torch.zeros_like(a))
    out_s = torch.empty(lead, dtype=torch.float32, device=a.device)
    out_c = torch.empty(lead, dtype=torch.int64, device=a.device)
    out_g = torch.empty_like(a)
    scratch = _k1_scratch("drmsd_train", bsz, n, a.device)
    _launch("drmsd_train", "drmsd_fwd_grad", a, b, mask, scratch.data_ptr(),
            out_s.data_ptr(), out_c.data_ptr(), out_g.data_ptr())
    drmsd_stats_grad_cuda.launches += 1
    return out_s, out_c, out_g


drmsd_stats_grad_cuda.launches = 0


def drmsd_grad_b_cuda(a: torch.Tensor, b: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """K1c: dS/db from the CUDA kernel. Takes what ``drmsd_stats_cuda``
    takes; adds one to ``drmsd_grad_b_cuda.launches`` per launch."""
    _check_cuda("drmsd_grad_b_cuda", a, b, mask)
    n = a.shape[-2]
    bsz = mask.numel() // max(n, 1)
    if bsz == 0 or n == 0:
        return torch.zeros_like(b)
    out_g = torch.empty_like(b)
    scratch = _k1_scratch("drmsd_train", bsz, n, a.device)
    _launch("drmsd_train", "drmsd_grad_b", a, b, mask, scratch.data_ptr(),
            out_g.data_ptr())
    drmsd_grad_b_cuda.launches += 1
    return out_g


drmsd_grad_b_cuda.launches = 0


class DrmsdStats(torch.autograd.Function):
    """Differentiable (S, C) of a batch: the port's counterpart of the JAX
    package's ``_drmsd_stats_p`` custom VJP.

    Forward: K1b (or its plain version) when a needs a gradient, keeping
    dS/da for the backward; otherwise K1a. Backward: grad_a = dS/da * dS;
    dS/db (K1c) is computed only when b needs a gradient, which in training
    it never does (the true coordinates). The mask, the count and ``impl``
    get no gradient."""

    @staticmethod
    def forward(ctx, a, b, mask, impl):
        cuda = resolve_impl(impl, a.device) == "cuda"
        ga = None
        if ctx.needs_input_grad[0]:
            s, c, ga = (drmsd_stats_grad_cuda if cuda
                        else drmsd_stats_grad_torch)(a, b, mask)
        else:
            s, c = (drmsd_stats_cuda if cuda else drmsd_stats_torch)(
                a, b, mask)
        ctx.cuda = cuda
        ctx.save_for_backward(a, b, mask, ga)
        ctx.mark_non_differentiable(c)
        return s, c

    @staticmethod
    def backward(ctx, ds, _dc):
        a, b, mask, ga = ctx.saved_tensors
        ds = ds[..., None, None]
        grad_a = ga * ds if ga is not None else None
        grad_b = None
        if ctx.needs_input_grad[1]:
            gb = (drmsd_grad_b_cuda if ctx.cuda else drmsd_grad_b_torch)(
                a, b, mask)
            grad_b = gb * ds
        return grad_a, grad_b, None, None


def drmsd_stats(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """(S, C), differentiable in a and b, by the kernels ('cuda') or the
    plain versions ('torch'); 'auto' picks by the tensors' device.

    Goes through ``DrmsdStats`` when autograd will want a gradient. Without
    one (grad mode off, as in the eval step, or no input requiring grad) it
    runs the forward statistics alone: inside ``DrmsdStats.forward`` grad
    mode is always off, so it cannot tell a no-grad call from a training
    one."""
    a, b, mask = a.contiguous(), b.contiguous(), mask.bool().contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return DrmsdStats.apply(a, b, mask, impl)
    if resolve_impl(impl, a.device) == "cuda":
        return drmsd_stats_cuda(a, b, mask)
    return drmsd_stats_torch(a, b, mask)
