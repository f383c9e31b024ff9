"""Flash self-attention over a key-padding mask: the hand-written CUDA
kernels and their plain version.

Counterpart of protein_transformer_tpu/ops/attention.py, whose
``flash_self_attention`` reaches the TPU flash kernels of
``jax.experimental.pallas.ops.tpu.flash_attention``. For q, k, v of shape
(B, H, L, D) and a (B, L) bool ``valid`` (True at real positions), with
s_ij = sm_scale * q_i . k_j,

    O = softmax_j(s_ij where key j is valid, else finfo(float32).min) V

without the (B, H, L, L) probabilities ever reaching device memory.

**Masking contract, shared by the kernels and the plain version.** It is the
materialised branch's (``models/transformer.py``) on every row: a masked key
gets the smallest finite fp32 score, not -inf, so it weighs exactly 0
wherever the row has a valid key; a pad query row attends to the valid keys
like any other row (the JAX flash path lets pad rows attend to each other
instead; pad rows never reach a real output, and the tests against JAX
compare valid rows only); and a batch row with **no valid key at all**, as
``collate``'s batch padding makes them, gets uniform weights 1/L over its L
keys: finite outputs, and finite gradients (zero for q and k, since a
constant score passes none; the mean of dO for v).

* K3a ``flash_attn_fwd_cuda`` (``csrc/attention.cu``) -> O and, when asked,
  the running maximum m and sum l of every query row, (B, H, L) each;
* the backward ``flash_attn_bwd_cuda`` -> (dQ, dK, dV), any of them left out
  when not wanted, in one launch from q, k, v, the mask, dO, O, m and l: the
  probabilities are recomputed tile by tile and delta = sum_d dO o O is taken
  inside; its plain version is ``flash_attn_bwd_torch``;
* the plain version of the whole Function is ``flash_self_attention_torch``
  (the materialised masked softmax in fp32) with autograd for its gradient.

The kernels address their tensors by strides, so the (B, H, L, D) views that
the model's head split makes of (B, L, H * D) memory are read in place, and
O and the gradients are written in that same memory layout: the merge of the
heads after the attention is a view, not a copy. A wrapper copies only a
tensor whose last dimension is not adjacent in memory or whose rows are not
16-byte aligned. Head dimensions 16, 32, 64 and 128.

**Two instances, by dtype.** q, k, v (and dO and O) are all float32 or all
bfloat16; anything else (float16, mixed dtypes) raises TypeError. The
bfloat16 instances compute what the TPU flash kernel computes on bf16
inputs: S = Q K^T with fp32 accumulation, the scale and the online softmax
in fp32, P = exp(s - m) rounded to bf16 before P V, O accumulated in fp32
and written in bf16; m and l stay float32. Their backward takes dP = dO V^T
from bf16 operands, dS = scale * P o (dP - delta) in fp32 with delta = sum_d
dO o O in fp32, and dV = P^T dO, dK = dS^T Q and dQ = dS K from P and dS
rounded to bf16, the gradients written in bf16. The plain versions below
take the same casts (a product of two bf16 values is exact in fp32, so the
fp32 product of the upcast operands is the bf16 product with fp32
accumulation). Each instance counts its own launches: ``launches`` of a
wrapper for float32, ``launches_bf16`` for bfloat16.

A kernel wrapper takes CUDA tensors only and raises on anything else; a
kernel that fails to build or to launch raises. ``flash_self_attention`` is
the differentiable entry point: ``impl`` is "cuda", "torch" or "auto" (by
the tensors' device).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from protein_transformer_tpu_torch.ops import _build

HEAD_DIMS = (16, 32, 64, 128)
# the dtypes of q, k, v that have a kernel instance -> the C entry points'
# suffix
DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


# (impl, device) -> "cuda" or "torch" (``_build.resolve_impl``)
resolve_impl = functools.partial(_build.resolve_impl, what="attention")


def flash_self_attention_torch(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, valid: torch.Tensor, *,
                               sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of K3a and, through autograd, of the backward:
    the materialised masked softmax in fp32, under the module's masking
    contract. q, k, v (B, H, L, D); valid (B, L) bool; returns (B, H, L, D)
    in q's dtype. For bfloat16 the scores come in fp32 from the bf16
    operands and the probabilities are cast to bf16 for P V (fp32 sums, one
    rounding of O), as the model's materialised branch computes it."""
    low = q.dtype == torch.bfloat16
    if low:
        q, k = q.float(), k.float()
    scores = torch.matmul(q, k.transpose(-2, -1)) * sm_scale
    scores = scores.masked_fill(~valid.bool()[:, None, None, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if low:
        return torch.matmul(probs.to(torch.bfloat16).float(),
                            v.float()).to(torch.bfloat16)
    return torch.matmul(probs, v)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared: pointers as
    c_void_p, so ctypes never truncates them to 32 bits."""
    lib = _build.load("attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    for suffix in DTYPES.values():
        fwd = getattr(lib, "flash_attn_fwd" + suffix)
        bwd = getattr(lib, "flash_attn_bwd" + suffix)
        fwd.argtypes = [p] * 7 + [i] * 4 + [f, strides, p]
        bwd.argtypes = [p] * 11 + [i] * 4 + [f, strides, p]
        fwd.restype = bwd.restype = ctypes.c_int
    lib.attention_error_string.argtypes = [ctypes.c_int]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def _rows_in_place(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can address it (adjacent elements along
    D, every row 16-byte aligned, no broadcast dimension: the bf16
    kernels' tensor maps take no stride of 0), else a contiguous copy."""
    per_16_bytes = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all(s % per_16_bytes == 0 and (s > 0 or n == 1)
                    for s, n in zip(t.stride()[:-1], t.shape[:-1])):
        return t
    return t.contiguous()


def _head_layout(shape, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, L, D) tensor in (B, L, H, D) memory, the
    layout of the model's head split: merging the heads is then a view."""
    bsz, n_heads, length, dim = shape
    return torch.empty((bsz, length, n_heads, dim), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _check_cuda(fn: str, valid: torch.Tensor, stats: dict,
                **tensors: torch.Tensor) -> tuple[int, int, int, int]:
    """What every kernel wrapper takes: (B, H, L, D) tensors of one shape
    and one dtype, float32 or bfloat16, on one CUDA device, D in HEAD_DIMS,
    a contiguous bool (B, L) mask and contiguous float32 (B, H, L) row
    statistics. Returns (B, H, L, D)."""
    first = next(iter(tensors.values()))
    device, shape = first.device, tuple(first.shape)
    if device.type != "cuda":
        raise ValueError(f"{fn} needs its tensors on a CUDA device; got "
                         f"{device}")
    if len(shape) != 4 or shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{fn} takes (B, H, L, D) tensors with D in "
                         f"{HEAD_DIMS}; got {shape}")
    bsz, n_heads, length, _ = shape
    if bsz * n_heads > 65535:
        raise ValueError(f"{fn}: B * H = {bsz * n_heads} exceeds the grid's "
                         "65535")
    for name, t in tensors.items():
        if t.device != device or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{fn} takes float32 or bfloat16 {name}; got "
                            f"{t.dtype}")
        if t.dtype != first.dtype:
            raise TypeError(f"{fn} takes one dtype for all of "
                            f"{', '.join(tensors)}; {name} is {t.dtype}, "
                            f"not {first.dtype}")
    if valid.device != device or valid.dtype != torch.bool \
            or tuple(valid.shape) != (bsz, length) \
            or not valid.is_contiguous():
        raise ValueError(f"{fn} takes a contiguous bool mask "
                         f"{(bsz, length)} on {device}; got {valid.dtype} "
                         f"{tuple(valid.shape)} on {valid.device}")
    for name, t in stats.items():
        if t.device != device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape[:3] or not t.is_contiguous():
            raise ValueError(f"{fn} takes contiguous float32 {name} "
                             f"{shape[:3]} on {device}")
    return shape


def _launch(fn: str, device, pointers, ints, scale, strided) -> None:
    """Call ``fn`` of the library (the instance of the ``strided`` tensors'
    dtype) on the current stream of ``device`` with the element strides
    (batch, head, row) of those tensors; raise on a non-zero CUDA error
    code."""
    flat = [s for t in strided for s in t.stride()[:3]]
    strides = (ctypes.c_longlong * len(flat))(*flat)
    _build.launch(_lib(), "attention", fn + DTYPES[strided[0].dtype], device,
                  *pointers, *ints, float(scale), strides)


def _count(wrapper, dtype) -> None:
    """One launch more of ``wrapper``'s instance for ``dtype``."""
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def flash_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor, sm_scale: float,
                        with_stats: bool = False):
    """K3a: (O, m, l) from the CUDA kernel, one launch for the whole batch.

    q, k, v: (B, H, L, D), all float32 or all bfloat16, on one CUDA device,
    D in HEAD_DIMS; valid: (B, L) bool, contiguous. O comes back (B, H, L,
    D) in q's dtype and (B, L, H, D) memory. m and l, each query row's
    running maximum and sum, (B, H, L) float32, are written only
    ``with_stats``, else both are None. Raises for any other input, and if
    the kernel fails to build or launch. Adds one per launch to
    ``flash_attn_fwd_cuda.launches`` (the float32 instance) or
    ``.launches_bf16``."""
    shape = _check_cuda("flash_attn_fwd_cuda", valid, {}, q=q, k=k, v=v)
    q, k, v = _rows_in_place(q), _rows_in_place(k), _rows_in_place(v)
    out = _head_layout(shape, q)
    m = l = None
    if with_stats:
        m = torch.empty(shape[:3], dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if q.numel() == 0:
        return out, m, l
    _launch("flash_attn_fwd", q.device,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
             out.data_ptr(), m.data_ptr() if with_stats else None,
             l.data_ptr() if with_stats else None),
            shape, sm_scale, (q, k, v, out))
    _count(flash_attn_fwd_cuda, q.dtype)
    return out, m, l


flash_attn_fwd_cuda.launches = flash_attn_fwd_cuda.launches_bf16 = 0


def flash_attn_bwd_torch(q, k, v, valid, d_out, out, m, l,
                         sm_scale: float):
    """Plain version of the backward kernel, (dQ, dK, dV): the
    probabilities recomputed from the forward's row statistics as
    exp(s - m) / l, delta = sum_d dO o O, dS zero on masked keys. For
    bfloat16 inputs every product takes its operands in bf16 and sums in
    fp32, P and dS (scaled, as the TPU kernel scales it) are rounded to bf16
    before the products that take them, and the gradients come back in
    bf16."""
    low = q.dtype == torch.bfloat16
    if low:
        q, k, v, d_out, out = (t.float() for t in (q, k, v, d_out, out))
    scores = torch.matmul(q, k.transpose(-2, -1)) * sm_scale
    key = valid.bool()[:, None, None, :]
    scores = scores.masked_fill(~key, torch.finfo(torch.float32).min)
    p = torch.exp(scores - m[..., None]) / l[..., None]
    dp = torch.matmul(d_out, v.transpose(-2, -1))
    delta = (d_out * out).sum(-1)
    ds = torch.where(key, p * (dp - delta[..., None]), 0.0)
    if not low:
        return (torch.matmul(ds, k) * sm_scale,
                torch.matmul(ds.transpose(-2, -1), q) * sm_scale,
                torch.matmul(p.transpose(-2, -1), d_out))

    def bf16(t):
        return t.to(torch.bfloat16)

    ds = bf16(ds * sm_scale).float()
    p = bf16(p).float()
    return (bf16(torch.matmul(ds, k)),
            bf16(torch.matmul(ds.transpose(-2, -1), q)),
            bf16(torch.matmul(p.transpose(-2, -1), d_out)))


def flash_attn_bwd_cuda(q, k, v, valid, d_out, out, m, l, sm_scale: float, *,
                        want_dq: bool = True, want_dkv: bool = True):
    """The backward kernel: (dQ or None, dK or None, dV or None), each
    (B, H, L, D) in (B, L, H, D) memory, from one launch.

    q, k, v, valid as ``flash_attn_fwd_cuda`` takes them; d_out the
    cotangent of O and out the forward's O, (B, H, L, D) in q's dtype; m, l
    the forward's row statistics, (B, H, L) float32, contiguous. The
    gradients come back in q's dtype. ``want_dq`` and ``want_dkv`` pick the
    gradients (at least one). Raises for any other input, and if the kernel
    fails to build or launch. Adds one per launch to
    ``flash_attn_bwd_cuda.launches`` (float32) or ``.launches_bf16``."""
    if not (want_dq or want_dkv):
        raise ValueError("flash_attn_bwd_cuda: want_dq or want_dkv must be "
                         "set")
    shape = _check_cuda("flash_attn_bwd_cuda", valid, {"m": m, "l": l}, q=q,
                        k=k, v=v, d_out=d_out, out=out)
    q, k, v, d_out, out = (_rows_in_place(t) for t in (q, k, v, d_out, out))
    d_q = _head_layout(shape, q) if want_dq else None
    d_k = _head_layout(shape, q) if want_dkv else None
    d_v = _head_layout(shape, q) if want_dkv else None
    if q.numel() == 0:
        return d_q, d_k, d_v
    grads = (d_q, d_k, d_v)
    _launch("flash_attn_bwd", q.device,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
             d_out.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
             *(None if g is None else g.data_ptr() for g in grads)),
            shape, sm_scale,
            (q, k, v, d_out, out, *(q if g is None else g for g in grads)))
    _count(flash_attn_bwd_cuda, q.dtype)
    return d_q, d_k, d_v


flash_attn_bwd_cuda.launches = flash_attn_bwd_cuda.launches_bf16 = 0


class FlashSelfAttention(torch.autograd.Function):
    """Differentiable kernel attention: the port's counterpart of the custom
    VJP around the TPU flash kernel.

    Forward: K3a with the row statistics; saves q, k, v, the mask, O, m and
    l (never the probabilities). Backward: one launch of the backward
    kernel, asking for dQ when q needs a gradient and for dK and dV when k
    or v does. The instance follows q's dtype; autograd hands the cotangent
    in O's dtype, the same."""

    @staticmethod
    def forward(ctx, q, k, v, valid, sm_scale):
        out, m, l = flash_attn_fwd_cuda(q, k, v, valid, sm_scale,
                                        with_stats=True)
        ctx.save_for_backward(q, k, v, valid, out, m, l)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, valid, out, m, l = ctx.saved_tensors
        want_dq, want_k, want_v = ctx.needs_input_grad[:3]
        d_q, d_k, d_v = flash_attn_bwd_cuda(
            q, k, v, valid, d_out, out, m, l, ctx.sm_scale, want_dq=want_dq,
            want_dkv=want_k or want_v)
        return (d_q, d_k if want_k else None, d_v if want_v else None, None,
                None)


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor, *, sm_scale: float,
                         impl: str = "auto") -> torch.Tensor:
    """Masked-softmax self-attention without the probabilities in device
    memory, differentiable in q, k and v.

    q, k, v: (B, H, L, D), all float32 or all bfloat16. valid: (B, L) bool,
    True at real positions. Returns (B, H, L, D) in q's dtype. impl "cuda"
    runs the kernels (CUDA tensors of those dtypes with D in HEAD_DIMS only:
    anything else raises; a bfloat16 tensor never goes to the float32
    instance), "torch" the plain version, "auto" picks by q's device.

    The kernel path goes through ``FlashSelfAttention`` only when autograd
    will want a gradient: inside a Function's forward grad mode is always
    off, so it cannot tell a no-grad or inference-mode call, which must save
    nothing and write no row statistics, from a training one."""
    if resolve_impl(impl, q.device) == "torch":
        return flash_self_attention_torch(q, k, v, valid, sm_scale=sm_scale)
    valid = valid.bool().contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashSelfAttention.apply(q, k, v, valid, float(sm_scale))
    return flash_attn_fwd_cuda(q, k, v, valid, sm_scale)[0]
