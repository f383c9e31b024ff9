"""The optimizer's update over every parameter: the hand-written CUDA kernel.

* K6 ``adam_update_cuda`` (``csrc/adam.cu``): the clip by the global norm,
  the coupled weight decay, Adam's moments with their bias correction (or
  SGD) and the parameter update, as one multi-tensor pass over all the
  parameters (28 bytes a parameter for Adam), preceded by one pass that
  reads the gradients for the clip's norm (4 bytes), after an 8-byte memset
  of its ticket in a buffer of the call's own: two launches an update, one
  without a clip. Nothing waits for the device. Its plain
  version is the ``torch._foreach_*`` body of
  ``training/optim.py::Optimizer.update`` (impl "torch"), which the CPU
  tests run and hold against the JAX package.

The wrapper takes float32 CUDA tensors only and raises on anything else: no
cast, no fall back to the plain version. A gradient that is not contiguous,
as its parameter is, is copied first (``adam_update_cuda.copies``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from protein_transformer_tpu_torch.ops import _build

# (impl, device) -> "cuda" or "torch" (``_build.resolve_impl``)
resolve_impl = functools.partial(_build.resolve_impl, what="optimizer")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared: pointers as
    c_void_p, so ctypes never truncates them to 32 bits."""
    lib = _build.load("adam")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adam_norm.argtypes = [p, p, p, i, p, p, p, p, p]
    lib.adam_norm.restype = i
    lib.adam_update.argtypes = [p, p, i, p, f, f, f, f, f, f, f, f, f, i, p,
                                p]
    lib.adam_update.restype = i
    lib.adam_max_tensors.restype = i
    lib.adam_norm_blocks.restype = i
    lib.adam_error_string.argtypes = [i]
    lib.adam_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _norm_blocks(device: torch.device) -> int:
    """The most blocks a launch of the norm pass has on ``device``."""
    with torch.cuda.device(device):
        blocks = _lib().adam_norm_blocks()
    if blocks <= 0:
        raise RuntimeError(f"adam_update_cuda: no launch shape on {device}")
    return blocks


def _check(params, grads, mu, nu) -> None:
    """What the kernel takes: float32 CUDA tensors on one device, each
    gradient and moment of its parameter's shape, parameters and moments
    contiguous; mu and nu both or neither."""
    fn = "adam_update_cuda"
    if (mu is None) != (nu is None):
        raise ValueError(f"{fn} takes both moments or neither")
    n = len(params)
    lists = [("grads", grads)] + ([] if mu is None
                                  else [("mu", mu), ("nu", nu)])
    for name, ts in lists:
        if len(ts) != n:
            raise ValueError(f"{fn}: {len(ts)} {name} for {n} parameters")
    device = params[0].device if n else None
    for i, p in enumerate(params):
        for name, t in [("params", p)] + [(name, ts[i]) for name, ts in lists]:
            if t.dtype != torch.float32:
                raise TypeError(f"{fn} takes float32 {name}; got {t.dtype} "
                                f"at {i}")
            if t.device != device:
                raise ValueError(f"{fn}: {name}[{i}] is on {t.device}, not "
                                 f"{device}")
            if t.shape != p.shape:
                raise ValueError(f"{fn}: {name}[{i}] has shape "
                                 f"{tuple(t.shape)}, its parameter "
                                 f"{tuple(p.shape)}")
            if name != "grads" and not t.is_contiguous():
                raise ValueError(f"{fn} takes contiguous {name}; {i} is not")
    if device is not None and device.type != "cuda":
        raise ValueError(f"{fn} needs its tensors on a CUDA device; got "
                         f"{device}")


def adam_update_cuda(params: list, grads: list, mu: list | None,
                     nu: list | None, *, lr: float, weight_decay: float,
                     clip: float | None = None, sliced: list | None = None,
                     axis=None, b1: float = 0.9, b2: float = 0.98,
                     eps: float = 1e-9, bc1: float = 1.0,
                     bc2: float = 1.0) -> tuple:
    """K6: one update of ``params`` (and of Adam's moments ``mu``, ``nu``;
    None for SGD) in place, from ``grads``, in two launches on the current
    stream (one without a clip), without waiting for them.

    lr: the signed step (negative to descend); bc1, bc2: Adam's bias
    corrections; clip: the global norm's limit, or None; sliced[i]: grads[i]
    is a slice over the 'model' ``axis``, whose square sum the axis sums
    between the passes (``axis.all_reduce`` on a one-element device tensor).
    The gradients are read, never written. Returns the norm pass's (2,)
    float64 sums of squares, sliced and replicated, after the axis's sum, or
    None without a clip. Raises for input the kernel does not take and if it fails to
    build or launch. Adds the launches made to
    ``adam_update_cuda.launches`` and the gradients copied to their
    parameter's layout to ``adam_update_cuda.copies``."""
    params, grads = list(params), list(grads)
    _check(params, grads, mu, nu)
    n = len(params)
    device = params[0].device if n else None
    if not sum(p.numel() for p in params):
        return None
    for i, g in enumerate(grads):
        if not g.is_contiguous():
            grads[i] = g.contiguous()
            adam_update_cuda.copies += 1
    moments = (mu, nu) if mu is not None else (params, params)
    ptrs = np.array([[p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr()]
                     for p, g, m, v in zip(params, grads, *moments)],
                    dtype=np.uint64)
    numel = np.array([p.numel() for p in params], dtype=np.int64)
    lib = _lib()
    chunks = -(-n // lib.adam_max_tensors())
    rows = _norm_blocks(device) * chunks
    # partials (2 a block of the norm pass), sums (2), then the norm pass's
    # ticket, which it zeroes on the stream: a buffer of this call's own, so
    # calls on other streams share nothing
    work = torch.empty(2 * rows + 3, dtype=torch.float64, device=device)
    sums = work[2 * rows:2 * rows + 2]
    ticket = work[-1:].view(torch.int64)
    launches = ctypes.c_int(0)
    if clip:
        flags = np.array([bool(s) for s in (sliced or [False] * n)],
                         dtype=np.uint8)
        _build.launch(lib, "adam", "adam_norm", device,
                      ptrs.ctypes.data, numel.ctypes.data, flags.ctypes.data,
                      n, work.data_ptr(), sums.data_ptr(), ticket.data_ptr(),
                      ctypes.addressof(launches))
        adam_update_cuda.launches += launches.value
        if flags.any():
            axis.all_reduce(sums[:1])
    _build.launch(lib, "adam", "adam_update", device,
                  ptrs.ctypes.data, numel.ctypes.data, n, sums.data_ptr(),
                  float(clip or 0.0), lr, weight_decay, 1.0 - b1, b2,
                  1.0 - b2, bc1, bc2, eps, int(mu is not None),
                  ctypes.addressof(launches))
    adam_update_cuda.launches += launches.value
    return sums if clip else None


adam_update_cuda.launches = 0
adam_update_cuda.copies = 0
