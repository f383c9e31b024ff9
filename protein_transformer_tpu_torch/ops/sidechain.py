"""The fused sidechain build: the hand-written CUDA kernels and their plain
version.

Counterpart of protein_transformer_tpu/ops/sidechain_pallas.py, batched over
(B, L) where the JAX code is vmapped per protein. Per residue a buffer of 15
points (0..3 backbone, 4..13 sidechain atoms in build order, 14 the anchor)
is filled by up to 10 chained NeRF placements; slot s takes its three frame
atoms from the buffer entries the force-field tables name and is live while
``s < n_sc``. Dead slots are exactly zero and carry no gradient.

* K2a ``sidechain_fwd_cuda`` (``csrc/sidechain.cu``): the whole build of
  every residue in one launch, from the backbone, the angles and the
  sequence; each block looks up its residues' records in the packed
  force-field table (``ff_table``) itself. Plain version:
  ``build_sidechains_torch``, i.e. ``sidechain_inputs`` (the lookups, the
  anchors and the torsions in tensor ops) and ``build_sidechain_points_torch``
  (the slot chain).
* K2b ``sidechain_bwd_cuda`` (``csrc/sidechain.cu``): the reverse replay
  from the built points, giving the cotangents of the backbone (the
  anchors' folded in) and of the angles; its plain version is autograd
  through ``build_sidechains_torch``.

A kernel wrapper takes contiguous CUDA tensors only and raises on anything
else; a kernel that fails to build or to launch raises. The plain version
runs on any device; the CPU tests run it, and ``chip_smoke.py`` holds the
kernels against it on the card.

``build_sidechains`` is the differentiable entry point: ``impl`` is "cuda",
"torch" or "auto" (by the tensors' device). The backbone and the angles get
gradients; the sequence and the tables none.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from protein_transformer_tpu_torch.ops import _build
from protein_transformer_tpu_torch.ops.nerf import device_constant, nerf
from protein_transformer_tpu_torch.protein import _ff14sb as ff
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES, SC_ANGLES_START_POS)

MAX_SC_ATOMS = 10
N_OUT_POINTS = 14
N_TYPES = ff.SC_NUM_ATOMS.shape[0]

# (impl, device) -> "cuda" or "torch" (``_build.resolve_impl``)
resolve_impl = functools.partial(_build.resolve_impl, what="sidechain")

# The packed force-field table: one record of RECORD float32 a residue type,
# field -> (offset in the record, the ``_ff14sb`` array it holds, whose rows
# are the types); integers are stored exactly. csrc/sidechain.cu reads the
# same offsets (kBondLen ... kNumAtoms).
RECORD = 96
TABLE_LAYOUT = {"bond_len": (0, ff.SC_BOND_LEN),
                "bond_ang": (10, ff.SC_BOND_ANG),
                "torsion_const": (20, ff.SC_TORSION_CONST),
                "torsion_offset": (30, ff.SC_TORSION_PI_OFFSET),
                "torsion_type": (40, ff.SC_TORSION_TYPE),
                "torsion_src": (50, ff.SC_TORSION_SRC),
                "frame": (60, ff.SC_FRAME_IDX),
                "num_atoms": (90, ff.SC_NUM_ATOMS)}


def pack_table() -> np.ndarray:
    """The ``_ff14sb`` sidechain arrays as one (24, RECORD) float32 table,
    laid out as ``TABLE_LAYOUT`` says."""
    table = np.zeros((N_TYPES, RECORD), np.float32)
    for start, arr in TABLE_LAYOUT.values():
        flat = arr.reshape(N_TYPES, -1)
        table[:, start:start + flat.shape[1]] = flat
    return table


@functools.cache
def ff_table(device: torch.device) -> torch.Tensor:
    """The packed table on ``device``, copied there once per process (a
    copy made per call would wait on the stream every time). It is made
    outside inference mode, so that any later call may save it."""
    with torch.inference_mode(False):
        return torch.from_numpy(pack_table()).to(device)


def table_field(records: torch.Tensor, name: str, dtype) -> torch.Tensor:
    """One field of gathered records (..., RECORD), as ``dtype``."""
    start, arr = TABLE_LAYOUT[name]
    shape = arr.shape[1:]
    return records[..., start:start + math.prod(shape)].reshape(
        *records.shape[:-1], *shape).to(dtype)


def sidechain_inputs(bb: torch.Tensor, angles: torch.Tensor,
                     seq: torch.Tensor) -> tuple:
    """What the slot chain takes besides the backbone, from the force-field
    tables: (anchor (B, L, 3), torsions, bond lengths, bond angles (B, L, 10),
    n_sc (B, L) int32, frame indices (B, L, 10, 3) int64)."""
    length = bb.shape[1]
    dtype = bb.dtype
    aa = torch.clamp(seq.long(), 0, N_TYPES - 1)
    records = ff_table(bb.device)[aa]                       # (B, L, RECORD)

    n_sc = table_field(records, "num_atoms", torch.int32)   # (B, L)
    blen = table_field(records, "bond_len", dtype)          # (B, L, 10)
    bang = table_field(records, "bond_ang", dtype)
    ttype = table_field(records, "torsion_type", torch.int32)
    tconst = table_field(records, "torsion_const", dtype)
    tsrc = table_field(records, "torsion_src", torch.long)
    toff = table_field(records, "torsion_offset", dtype)
    frame = table_field(records, "frame", torch.long)       # (B, L, 10, 3)

    # Residue 0's first sidechain atom is framed by (next-N, C, CA) instead
    # of (prev-C, N, CA); both use buffer slot 14 as the anchor.
    frame[:, 0, 0] = device_constant((ff.ANCHOR_IDX, 2, 1), frame.device,
                                     frame.dtype)

    # Anchor: N of residue 1 for residue 0, else C of residue i-1. A lone
    # residue (L=1) falls back to its own C so the build is defined.
    if length == 1:
        anchor = bb[:, :, 2]
    else:
        anchor = torch.cat([bb[:, 1:2, 0], bb[:, :-1, 2]], dim=1)

    # Torsions: predicted chi (indexed by source slot) or the chemical
    # constant, minus the pi offset of 'inferred' planar atoms.
    chi_idx = torch.clamp(SC_ANGLES_START_POS + tsrc, 0,
                          NUM_PREDICTED_ANGLES - 1)
    chi_vals = torch.gather(angles, -1, chi_idx)
    torsions = torch.where(ttype == ff.TORSION_PRED, chi_vals, tconst) - toff
    return anchor, torsions, blen, bang, n_sc, frame


def build_sidechain_points_torch(bb, anchor, torsions, blen, bang, n_sc,
                                 frame_idx):
    """The slot chain in plain tensor ops (port of ``_build_sidechains_xla``,
    the JAX default), from the resolved per-residue inputs that
    ``sidechain_inputs`` makes.

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


def build_sidechains_torch(bb: torch.Tensor, angles: torch.Tensor,
                           seq: torch.Tensor) -> torch.Tensor:
    """The build in plain tensor ops: K2a's plain version, and through
    autograd K2b's."""
    return build_sidechain_points_torch(bb,
                                        *sidechain_inputs(bb, angles, seq))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared: pointers as
    c_void_p, so ctypes never truncates them to 32 bits."""
    lib = _build.load("sidechain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sidechain_fwd.argtypes = [p, p, p, i, p, i, i, p, p]
    lib.sidechain_bwd.argtypes = [p, p, p, i, p, p, i, i, p, p, p]
    lib.sidechain_fwd.restype = lib.sidechain_bwd.restype = i
    lib.sidechain_error_string.argtypes = [i]
    lib.sidechain_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(fn: str, floats: dict, seq: torch.Tensor) -> None:
    """What the kernel wrappers take: contiguous tensors on one CUDA device;
    the sequence (B, L) int32 or int64, each float32 tensor of shape (B, L)
    + its per-residue shape."""
    device = next(iter(floats.values()))[0].device
    if device.type != "cuda":
        raise ValueError(f"{fn} needs its tensors on a CUDA device; got "
                         f"{device}")
    if seq.device != device:
        raise ValueError(f"{fn}: seq is on {seq.device}, not {device}")
    if seq.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{fn} takes an int32 or int64 seq; got {seq.dtype}")
    if seq.dim() != 2:
        raise ValueError(f"{fn}: seq has shape {tuple(seq.shape)}, "
                         "expected (B, L)")
    for name, (t, tail) in floats.items():
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn} takes float32 {name}; got {t.dtype}")
        if tuple(t.shape) != tuple(seq.shape) + tail:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(seq.shape) + tail}")
    if not all(t.is_contiguous() for t in (seq, *(t for t, _ in
                                                  floats.values()))):
        raise ValueError(f"{fn} takes contiguous tensors")


def _seq_args(seq: torch.Tensor) -> tuple:
    return seq.data_ptr(), int(seq.dtype == torch.int64)


def sidechain_fwd_cuda(bb: torch.Tensor, angles: torch.Tensor,
                       seq: torch.Tensor) -> torch.Tensor:
    """K2a: the built points (B, L, 14, 3) from the CUDA kernel, one launch
    for all residues.

    bb (B, L, 4, 3) and angles (B, L, 12) float32, seq (B, L) int32 or
    int64 amino-acid ids, all contiguous on one CUDA device. Raises for any
    other input, and if the kernel fails to build or launch. Adds one to
    ``sidechain_fwd_cuda.launches`` per launch."""
    _check_cuda("sidechain_fwd_cuda",
                {"bb": (bb, (4, 3)),
                 "angles": (angles, (NUM_PREDICTED_ANGLES,))}, seq)
    bsz, length = seq.shape
    out = torch.empty((bsz, length, N_OUT_POINTS, 3), dtype=torch.float32,
                      device=bb.device)
    if seq.numel() == 0:
        return out
    _build.launch(_lib(), "sidechain", "sidechain_fwd", bb.device,
                  bb.data_ptr(), angles.data_ptr(), *_seq_args(seq),
                  ff_table(bb.device).data_ptr(), bsz * length, length,
                  out.data_ptr())
    sidechain_fwd_cuda.launches += 1
    return out


sidechain_fwd_cuda.launches = 0


def sidechain_bwd_cuda(built: torch.Tensor, angles: torch.Tensor,
                       seq: torch.Tensor, g_out: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2b: (g_bb (B, L, 4, 3), g_angles (B, L, 12)) from the CUDA kernel,
    given the forward's output ``built`` (B, L, 14, 3) and its cotangent
    ``g_out``; angles and seq as ``sidechain_fwd_cuda`` takes them. g_bb
    holds the anchors' cotangents too; g_angles is zero where no torsion
    reads a column. Adds one to ``sidechain_bwd_cuda.launches`` per
    launch."""
    _check_cuda("sidechain_bwd_cuda",
                {"built": (built, (N_OUT_POINTS, 3)),
                 "g_out": (g_out, (N_OUT_POINTS, 3)),
                 "angles": (angles, (NUM_PREDICTED_ANGLES,))}, seq)
    bsz, length = seq.shape
    f32 = dict(dtype=torch.float32, device=built.device)
    g_bb = torch.empty((bsz, length, 4, 3), **f32)
    g_angles = torch.empty((bsz, length, NUM_PREDICTED_ANGLES), **f32)
    if seq.numel() == 0:
        return g_bb, g_angles
    _build.launch(_lib(), "sidechain", "sidechain_bwd", built.device,
                  built.data_ptr(), angles.data_ptr(), *_seq_args(seq),
                  ff_table(built.device).data_ptr(), g_out.data_ptr(),
                  bsz * length, length, g_bb.data_ptr(), g_angles.data_ptr())
    sidechain_bwd_cuda.launches += 1
    return g_bb, g_angles


sidechain_bwd_cuda.launches = 0


class SidechainBuild(torch.autograd.Function):
    """Differentiable kernel build: the port's counterpart of the JAX
    package's ``_sc_build_p`` custom VJP.

    Forward: K2a, keeping the built points (they reproduce every slot's
    frame), the angles and the sequence. Backward: K2b on a contiguous
    cotangent."""

    @staticmethod
    def forward(ctx, bb, angles, seq):
        out = sidechain_fwd_cuda(bb, angles, seq)
        ctx.save_for_backward(out, angles, seq)
        return out

    @staticmethod
    def backward(ctx, g_out):
        g_bb, g_angles = sidechain_bwd_cuda(*ctx.saved_tensors,
                                            g_out.contiguous())
        return g_bb, g_angles, None


def build_sidechains(bb: torch.Tensor, angles: torch.Tensor,
                     seq: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Sidechain build of a batch: (B, L, 14, 3) coordinates with dead slots
    zero, differentiable in bb and angles.

    bb: (B, L, 4, 3) backbone N/CA/C/O. angles: (B, L, 12) radians, whose
    chi columns drive the predicted torsions. seq: (B, L) integer
    amino-acid ids (clamped to the table's 24 types).

    impl "cuda" runs the kernels (float32 CUDA tensors only: anything else
    raises), "torch" the plain version, "auto" picks by bb's device. The
    kernel path goes through ``SidechainBuild`` only when autograd will want
    a gradient: inside a Function's forward grad mode is always off, so it
    cannot tell a no-grad or inference-mode call, which must save nothing,
    from a training one."""
    if resolve_impl(impl, bb.device) == "torch":
        return build_sidechains_torch(bb, angles, seq)
    args = (bb.contiguous(), angles.contiguous(), seq.contiguous())
    if torch.is_grad_enabled() and (bb.requires_grad or angles.requires_grad):
        return SidechainBuild.apply(*args)
    return sidechain_fwd_cuda(*args)
