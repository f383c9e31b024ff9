"""The fused sidechain build: the hand-written CUDA kernels and their plain
version.

Counterpart of protein_transformer_tpu/ops/sidechain_pallas.py, batched over
(B, L) where the JAX code is vmapped per protein. Per residue a buffer of 15
points (0..3 backbone, 4..13 sidechain atoms in build order, 14 the anchor)
is filled by up to 10 chained NeRF placements; slot s takes its three frame
atoms from the buffer entries ``frame_idx[..., s, :]`` and is live while
``s < n_sc``. Dead slots are exactly zero and carry no gradient.

* K2a ``sidechain_fwd_cuda`` (``csrc/sidechain.cu``): the whole chain of
  every residue in one launch; plain ``build_sidechain_points_torch``.
* K2b ``sidechain_bwd_cuda`` (``csrc/sidechain.cu``): the reverse replay
  from the built points, giving the cotangents of the backbone, the anchor
  and the torsions; its plain version is autograd through
  ``build_sidechain_points_torch``.

A kernel wrapper takes contiguous float32 CUDA tensors only and raises on
anything else; a kernel that fails to build or to launch raises. The plain
version runs on any device; the CPU tests run it, and ``chip_smoke.py``
holds the kernels against it on the card.

``build_sidechain_points`` is the differentiable entry point: ``impl`` is
"cuda", "torch" or "auto" (by the tensors' device). Bond lengths, bond
angles, counts and indices get no gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from protein_transformer_tpu_torch.ops import _build
from protein_transformer_tpu_torch.ops.nerf import nerf

MAX_SC_ATOMS = 10
N_OUT_POINTS = 14

IMPLS = ("auto", "cuda", "torch")


def resolve_impl(impl: str, device: torch.device) -> str:
    """'auto' -> 'cuda' for tensors on a CUDA device, else 'torch'."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sidechain impl {impl!r}; expected one of "
                         f"{IMPLS}")
    if impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return impl


def build_sidechain_points_torch(bb, anchor, torsions, blen, bang, n_sc,
                                 frame_idx):
    """The slot chain in plain tensor ops (port of ``_build_sidechains_xla``,
    the JAX default): K2a's plain version, and through autograd K2b's.

    Each slot gathers its three frame atoms from the buffer and places one
    atom; slots beyond the residue's ``n_sc`` stay zero. The buffer is
    updated out of place, so autograd can run through it."""
    bsz, length = bb.shape[:2]
    frame_idx = frame_idx.long()
    buf = torch.cat([bb, torch.zeros_like(bb[:, :, :1]).expand(
        bsz, length, MAX_SC_ATOMS, 3), anchor[:, :, None]], dim=2)
    for slot in range(MAX_SC_ATOMS):
        idx = frame_idx[:, :, slot, :, None].expand(bsz, length, 3, 3)
        abc = torch.gather(buf, 2, idx)                     # (B, L, 3, 3)
        pt = nerf(abc[:, :, 0], abc[:, :, 1], abc[:, :, 2],
                  blen[..., slot], bang[..., slot], torsions[..., slot])
        pt = torch.where((slot < n_sc)[..., None], pt, 0.0)
        buf = torch.cat([buf[:, :, :4 + slot], pt[:, :, None],
                         buf[:, :, 5 + slot:]], dim=2)
    return buf[:, :, :N_OUT_POINTS]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared: pointers as
    c_void_p, so ctypes never truncates them to 32 bits."""
    lib = _build.load("sidechain")
    p = ctypes.c_void_p
    lib.sidechain_fwd.argtypes = [p] * 7 + [ctypes.c_int] + [p] * 2
    lib.sidechain_bwd.argtypes = [p] * 8 + [ctypes.c_int] + [p] * 4
    lib.sidechain_fwd.restype = lib.sidechain_bwd.restype = ctypes.c_int
    lib.sidechain_error_string.argtypes = [ctypes.c_int]
    lib.sidechain_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(fn: str, floats: dict, ints: dict, lead) -> None:
    """What the kernel wrappers take: contiguous tensors on one CUDA device,
    float32 and int32, each of shape ``lead`` + its per-residue shape."""
    device = next(iter(floats.values()))[0].device
    if device.type != "cuda":
        raise ValueError(f"{fn} needs its tensors on a CUDA device; got "
                         f"{device}")
    for kind, dtype, group in (("float32", torch.float32, floats),
                               ("int32", torch.int32, ints)):
        for name, (t, tail) in group.items():
            if t.device != device:
                raise ValueError(f"{fn}: {name} is on {t.device}, not "
                                 f"{device}")
            if t.dtype != dtype:
                raise TypeError(f"{fn} takes {kind} {name}; got {t.dtype}")
            if tuple(t.shape) != tuple(lead) + tail:
                raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                                 f"expected {tuple(lead) + tail}")
            if not t.is_contiguous():
                raise ValueError(f"{fn} takes contiguous tensors; {name} "
                                 "is not")


def _launch(fn: str, device, *args) -> None:
    """Call ``fn`` of the library on the current stream of ``device``; raise
    on a non-zero CUDA error code."""
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.sidechain_error_string(err).decode())


def _per_residue(anchor, torsions, blen, bang, n_sc, frame_idx):
    floats = {"anchor": (anchor, (3,)),
              "torsions": (torsions, (MAX_SC_ATOMS,)),
              "blen": (blen, (MAX_SC_ATOMS,)),
              "bang": (bang, (MAX_SC_ATOMS,))}
    ints = {"n_sc": (n_sc, ()), "frame_idx": (frame_idx, (MAX_SC_ATOMS, 3))}
    return floats, ints


def sidechain_fwd_cuda(bb: torch.Tensor, anchor: torch.Tensor,
                       torsions: torch.Tensor, blen: torch.Tensor,
                       bang: torch.Tensor, n_sc: torch.Tensor,
                       frame_idx: torch.Tensor) -> torch.Tensor:
    """K2a: the built points (..., 14, 3) from the CUDA kernel, one launch
    for all residues.

    bb (..., 4, 3), anchor (..., 3), torsions / blen / bang (..., 10)
    float32; n_sc (...,) and frame_idx (..., 10, 3) int32; all contiguous on
    one CUDA device. Raises for any other input, and if the kernel fails to
    build or launch. Adds one to ``sidechain_fwd_cuda.launches`` per
    launch."""
    lead = bb.shape[:-2]
    floats, ints = _per_residue(anchor, torsions, blen, bang, n_sc,
                                frame_idx)
    _check_cuda("sidechain_fwd_cuda", {"bb": (bb, (4, 3)), **floats}, ints,
                lead)
    out = torch.empty((*lead, N_OUT_POINTS, 3), dtype=torch.float32,
                      device=bb.device)
    n_res = n_sc.numel()
    if n_res == 0:
        return out
    _launch("sidechain_fwd", bb.device, bb.data_ptr(), anchor.data_ptr(),
            torsions.data_ptr(), blen.data_ptr(), bang.data_ptr(),
            n_sc.data_ptr(), frame_idx.data_ptr(), n_res, out.data_ptr())
    sidechain_fwd_cuda.launches += 1
    return out


sidechain_fwd_cuda.launches = 0


def sidechain_bwd_cuda(built: torch.Tensor, anchor: torch.Tensor,
                       torsions: torch.Tensor, blen: torch.Tensor,
                       bang: torch.Tensor, n_sc: torch.Tensor,
                       frame_idx: torch.Tensor, g_out: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2b: (g_bb (..., 4, 3), g_anchor (..., 3), g_torsions (..., 10)) from
    the CUDA kernel, given the forward's output ``built`` (..., 14, 3) and
    its cotangent ``g_out``; the other inputs as ``sidechain_fwd_cuda``
    takes them. Adds one to ``sidechain_bwd_cuda.launches`` per launch."""
    lead = built.shape[:-2]
    floats, ints = _per_residue(anchor, torsions, blen, bang, n_sc,
                                frame_idx)
    _check_cuda("sidechain_bwd_cuda",
                {"built": (built, (N_OUT_POINTS, 3)),
                 "g_out": (g_out, (N_OUT_POINTS, 3)), **floats}, ints, lead)
    f32 = dict(dtype=torch.float32, device=built.device)
    g_bb = torch.empty((*lead, 4, 3), **f32)
    g_anchor = torch.empty((*lead, 3), **f32)
    g_tor = torch.empty((*lead, MAX_SC_ATOMS), **f32)
    n_res = n_sc.numel()
    if n_res == 0:
        return g_bb, g_anchor, g_tor
    _launch("sidechain_bwd", built.device, built.data_ptr(),
            anchor.data_ptr(), torsions.data_ptr(), blen.data_ptr(),
            bang.data_ptr(), n_sc.data_ptr(), frame_idx.data_ptr(),
            g_out.data_ptr(), n_res, g_bb.data_ptr(), g_anchor.data_ptr(),
            g_tor.data_ptr())
    sidechain_bwd_cuda.launches += 1
    return g_bb, g_anchor, g_tor


sidechain_bwd_cuda.launches = 0


class SidechainBuild(torch.autograd.Function):
    """Differentiable kernel build: the port's counterpart of the JAX
    package's ``_sc_build_p`` custom VJP.

    Forward: K2a, keeping the built points (they reproduce every slot's
    frame) and the inputs the replay needs. Backward: K2b on a contiguous
    cotangent. Only bb, anchor and torsions get a gradient."""

    @staticmethod
    def forward(ctx, bb, anchor, torsions, blen, bang, n_sc, frame_idx):
        out = sidechain_fwd_cuda(bb, anchor, torsions, blen, bang, n_sc,
                                 frame_idx)
        ctx.save_for_backward(out, anchor, torsions, blen, bang, n_sc,
                              frame_idx)
        return out

    @staticmethod
    def backward(ctx, g_out):
        g_bb, g_anchor, g_tor = sidechain_bwd_cuda(*ctx.saved_tensors,
                                                   g_out.contiguous())
        return g_bb, g_anchor, g_tor, None, None, None, None


def build_sidechain_points(bb: torch.Tensor, anchor: torch.Tensor,
                           torsions: torch.Tensor, blen: torch.Tensor,
                           bang: torch.Tensor, n_sc: torch.Tensor,
                           frame_idx: torch.Tensor,
                           impl: str = "auto") -> torch.Tensor:
    """Sidechain build of a batch: (B, L, 14, 3) coordinates with dead slots
    zero, differentiable in bb, anchor and torsions.

    bb: (B, L, 4, 3) backbone N/CA/C/O. anchor: (B, L, 3) previous C (next N
    for residue 0). torsions / blen / bang: (B, L, 10) resolved internal
    coordinates. n_sc: (B, L) integer sidechain atom counts. frame_idx:
    (B, L, 10, 3) integer buffer indices of each slot's frame atoms.

    impl "cuda" runs the kernels (float32 CUDA tensors only: anything else
    raises), "torch" the plain version, "auto" picks by bb's device. The
    kernel path goes through ``SidechainBuild`` only when autograd will want
    a gradient: inside a Function's forward grad mode is always off, so it
    cannot tell a no-grad or inference-mode call, which must save nothing,
    from a training one."""
    if resolve_impl(impl, bb.device) == "torch":
        return build_sidechain_points_torch(bb, anchor, torsions, blen, bang,
                                            n_sc, frame_idx)
    args = (bb.contiguous(), anchor.contiguous(), torsions.contiguous(),
            blen.contiguous(), bang.contiguous(),
            n_sc.to(torch.int32).contiguous(),
            frame_idx.to(torch.int32).contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:3]):
        return SidechainBuild.apply(*args)
    return sidechain_fwd_cuda(*args)
