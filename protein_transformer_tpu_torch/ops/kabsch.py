"""Superposition RMSD of a batch: the hand-written CUDA kernel.

* K5 ``kabsch_rmsd_cuda`` (``csrc/kabsch.cu``): per protein, the weighted
  Kabsch fit of a onto b and the RMSD of the fitted points, one launch for
  the batch; the 3x3 SVD in fp64 inside the kernel, so the call never waits
  for the device. Forward only: the RMSD is a scoring metric. Its plain
  version is the tensor body of ``losses.kabsch_rmsd_masked`` (impl
  "torch"), which the CPU tests run and hold against the JAX package.

The wrapper takes contiguous CUDA tensors only and raises on anything else:
no cast, no copy, no fall back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from protein_transformer_tpu_torch.ops import _build

# (impl, device) -> "cuda" or "torch" (``_build.resolve_impl``)
resolve_impl = functools.partial(_build.resolve_impl, what="Kabsch")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared: pointers as
    c_void_p, so ctypes never truncates them to 32 bits."""
    lib = _build.load("kabsch")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kabsch_rmsd_fwd.argtypes = [p, p, p, p, i, i, p]
    lib.kabsch_rmsd_fwd.restype = i
    lib.kabsch_error_string.argtypes = [i]
    lib.kabsch_error_string.restype = ctypes.c_char_p
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> None:
    """What the kernel takes: a, b (B, N, 3) float32 and w (B, N) bool,
    contiguous, on one CUDA device, none needing a gradient."""
    fn = "kabsch_rmsd_cuda"
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError(f"{fn} is forward only: call it under no_grad or "
                           "inference mode, or on tensors that need no "
                           "gradient")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn} takes float32 {name}; got {t.dtype}")
    if w.dtype != torch.bool:
        raise TypeError(f"{fn} takes a bool w (the atom mask); got {w.dtype}")
    if a.dim() != 3 or a.shape[-1] != 3 or b.shape != a.shape \
            or w.shape != a.shape[:-1]:
        raise ValueError(f"{fn} takes a, b (B, N, 3) and w (B, N); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(w.shape)}")
    if not (a.is_contiguous() and b.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{fn} takes contiguous tensors")
    if a.device.type != "cuda":
        raise ValueError(f"{fn} needs its tensors on a CUDA device; got "
                         f"{a.device}")
    for name, t in (("b", b), ("w", w)):
        if t.device != a.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not {a.device}")


def kabsch_rmsd_cuda(a: torch.Tensor, b: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """K5: the (B,) float32 RMSD of each a[p] onto b[p] after the weighted
    Kabsch fit over the points w[p] selects, from the CUDA kernel in one
    launch on the current stream, without waiting for it.

    a, b (B, N, 3) float32 and the mask w (B, N) bool, all contiguous on
    one CUDA device; an all-zero w gives 0. Raises for any
    other input, for an input that needs a gradient while grad mode is on,
    and if the kernel fails to build or launch. Adds one to
    ``kabsch_rmsd_cuda.launches`` per launch."""
    _check(a, b, w)
    bsz, n = w.shape
    out = torch.empty((bsz,), dtype=torch.float32, device=a.device)
    if bsz == 0:
        return out
    _build.launch(_lib(), "kabsch", "kabsch_rmsd_fwd", a.device,
                  a.data_ptr(), b.data_ptr(), w.data_ptr(), out.data_ptr(),
                  bsz, n)
    kabsch_rmsd_cuda.launches += 1
    return out


kabsch_rmsd_cuda.launches = 0
