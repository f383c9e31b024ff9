"""The port's sidechain build against the JAX package's two builds.

The same seeded numpy inputs go through the JAX ``build_coords`` on its XLA
path, through its Pallas kernel in interpret mode (as
tests/test_sidechain_kernel.py runs it) and through the port's plain version
(``sidechain_impl="torch"``). Tolerances: the sidechain builds, given one
backbone (the JAX one), within 2e-5 A on physical angles (measured at most
1.2e-5 A: three fp32 roundings of a 40 A coordinate, the builds adding their
terms in different orders), and within the project's 1e-3 A gate on full-range angles, where nearly collinear frames
amplify fp32 rounding in every build; the whole build, whose backbone scans
compose in different orders, within 1e-3 A on the real residues (the zero
angles of padding make collinear backbone frames, whose direction is
arbitrary in both packages); gradients of sum(sin(0.3 crd)) over the real
residues with respect to the angles within 1e-4 * max(1, max|g|), the gate
of tests/test_sidechain_kernel.py.

The packed force-field table is held to the ``_ff14sb`` arrays and to the
kernel source's offsets, and the plain build that reads it to the arrays
looked up one by one, bit for bit. The kernels' autograd wiring is exercised
on the CPU with the two launch functions replaced by their plain versions;
the kernels themselves, and the coordinate build without a stream
synchronisation, run in the card-only tests at the end:

    python -m pytest --noconftest -m needs_cuda tests/test_torch_sidechain.py

JAX is imported inside the tests, so that the card-only test also collects
where JAX is not installed.
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.data.synthetic import (
    OUT_OF_TABLE_IDS, sidechain_case, with_every_type)
from protein_transformer_tpu_torch.ops import sidechain as S
from protein_transformer_tpu_torch.protein import _ff14sb as ff
from protein_transformer_tpu_torch.protein import geometry as tgeo
from protein_transformer_tpu_torch.protein.constants import (
    SC_ANGLES_START_POS)

CPU = torch.device("cpu")
PAD_ID = 20
# (B, L): the sizes of tests/test_sidechain_kernel.py; L=40 with B=1 holds
# each amino acid twice
SHAPES = [(1, 37), (1, 40), (1, 50), (3, 30)]


# jitted JAX functions by (what, impl): un-jitted, the Pallas kernels in
# interpret mode run op by op and take minutes under vmap
_JITTED = {}


@pytest.fixture
def jax_builds(monkeypatch):
    """build(impl, angles, ids) and grad(impl, angles, ids) of the JAX
    package, impl "xla" or "pallas" (interpret mode), on (B, L) batches."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from protein_transformer_tpu.protein import geometry as jgeo
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))

    def loss(a, seq):
        real = (seq != PAD_ID)[:, None, None]
        return jnp.sum(real * jnp.sin(0.3 * jgeo.build_coords(a, seq)))

    def jitted(what, impl):
        # PTT_SIDECHAIN_IMPL is read when a function is traced
        monkeypatch.setenv("PTT_SIDECHAIN_IMPL", impl)
        make = {"backbone": lambda: jax.vmap(jgeo.build_backbone),
                "coords": lambda: jax.vmap(jgeo.build_coords),
                "grad": lambda: jax.grad(loss)}[what]
        if (what, impl) not in _JITTED:
            _JITTED[what, impl] = jax.jit(make())
        return _JITTED[what, impl]

    def build(impl, ang, ids):
        """(backbone (B, L, 4, 3), all atoms (B, L, 14, 3))."""
        ang, ids = jnp.asarray(ang), jnp.asarray(ids)
        return (np.array(jitted("backbone", impl)(ang)),
                np.array(jitted("coords", impl)(ang, ids)))

    def grad(impl, ang, ids):
        """Row by row, through the kernel's own VJP for "pallas"."""
        fn = jitted("grad", impl)
        return np.stack([np.asarray(fn(jnp.asarray(a), jnp.asarray(seq)))
                         for a, seq in zip(ang, ids)])

    return build, grad


def port_build(ang, ids, impl="torch"):
    return tgeo.build_coords_batch(torch.from_numpy(ang),
                                   torch.from_numpy(ids), impl)


@pytest.mark.parametrize("physical", [True, False],
                         ids=["physical", "full-range"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"B{s[0]}-L{s[1]}")
def test_forward_matches_jax_xla_and_pallas(jax_builds, shape, physical):
    build, _ = jax_builds
    ang, ids = sidechain_case(np.random.default_rng(sum(shape)), *shape,
                              physical)
    whole = port_build(ang, ids).numpy()
    assert whole.shape == (*shape, 14, 3) and np.isfinite(whole).all()
    gate = 2e-5 if physical else 1e-3
    for impl in ("xla", "pallas"):
        bb, want = build(impl, ang, ids)
        got = tgeo.build_sidechains(torch.from_numpy(bb),
                                    torch.from_numpy(ang),
                                    torch.from_numpy(ids), "torch").numpy()
        err = float(np.abs(got - want).max())
        err_whole = float(np.abs((whole - want)[ids != PAD_ID]).max())
        print(f"{shape} physical={physical} vs {impl}: sidechains on one "
              f"backbone {err:.3e} A, whole build {err_whole:.3e} A")
        assert err <= gate, (impl, err)
        assert err_whole <= 1e-3, (impl, err_whole)
    # dead slots are exactly zero, padding included
    n_sc = ff.SC_NUM_ATOMS[ids]
    dead = np.arange(10)[None, None, :] >= n_sc[..., None]
    assert (got[:, :, 4:][dead] == 0.0).all()
    if shape[0] * shape[1] >= 40:
        assert set(range(20)) <= set(ids.ravel().tolist())


@pytest.mark.parametrize("shape", [(1, 30), (3, 30)],
                         ids=lambda s: f"B{s[0]}-L{s[1]}")
def test_angle_gradients_match_jax_grad(jax_builds, shape):
    """One length for both cases: the JAX gradients compile once per
    length (~20 s for the kernel's VJP in interpret mode)."""
    _, grad = jax_builds
    ang, ids = sidechain_case(np.random.default_rng(7 + sum(shape)), *shape,
                              physical=False)
    t_ang = torch.from_numpy(ang).requires_grad_()
    t_ids = torch.from_numpy(ids)
    crd = tgeo.build_coords_batch(t_ang, t_ids, "torch")
    (torch.sin(0.3 * crd) * (t_ids != PAD_ID)[..., None, None]).sum().backward()
    got = t_ang.grad.numpy()
    assert np.isfinite(got).all()
    for impl in ("xla", "pallas"):
        want = grad(impl, ang, ids)
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), (impl, err)


def kernel_inputs(shape=(2, 12), seed=0, physical=False, every_type=False):
    """(backbone, angles, ids) of ``sidechain_case``; with ``every_type``
    the ids hold every row of the table and ids outside it."""
    rng = np.random.default_rng(seed)
    ang, ids = sidechain_case(rng, *shape, physical)
    if every_type:
        ids = with_every_type(rng, ids)
    ang, ids = torch.from_numpy(ang), torch.from_numpy(ids)
    return tgeo.build_backbone(ang), ang, ids


def tables_route(bb, ang, ids):
    """The per-residue inputs looked up in the ``_ff14sb`` arrays one by
    one, as the port did before the packed table: the yardstick of
    ``sidechain_inputs``."""
    aa = np.clip(ids.numpy().astype(np.int64), 0, ff.SC_NUM_ATOMS.shape[0] - 1)
    look = lambda arr, dtype=None: torch.as_tensor(arr[aa], dtype=dtype)
    frame = look(ff.SC_FRAME_IDX).long()
    frame[:, 0, 0] = torch.tensor([ff.ANCHOR_IDX, 2, 1])
    anchor = (bb[:, :, 2] if bb.shape[1] == 1 else
              torch.cat([bb[:, 1:2, 0], bb[:, :-1, 2]], dim=1))
    chi_idx = torch.clamp(6 + look(ff.SC_TORSION_SRC).long(), 0, 11)
    torsions = torch.where(look(ff.SC_TORSION_TYPE) == ff.TORSION_PRED,
                           torch.gather(ang, -1, chi_idx),
                           look(ff.SC_TORSION_CONST, bb.dtype)) \
        - look(ff.SC_TORSION_PI_OFFSET, bb.dtype)
    return (anchor, torsions, look(ff.SC_BOND_LEN, bb.dtype),
            look(ff.SC_BOND_ANG, bb.dtype), look(ff.SC_NUM_ATOMS), frame)


def test_resolve_impl():
    assert S.resolve_impl("auto", CPU) == "torch"
    assert S.resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert S.resolve_impl("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="unknown sidechain impl"):
        S.resolve_impl("pallas", CPU)


def test_packed_table_equals_ff14sb_arrays():
    table = S.pack_table()
    assert table.shape == (24, S.RECORD) and table.dtype == np.float32
    assert torch.equal(S.ff_table(CPU), torch.from_numpy(table))
    records = torch.from_numpy(table)
    used = np.zeros(S.RECORD, bool)
    for name, (start, arr) in S.TABLE_LAYOUT.items():
        got = S.table_field(records, name, torch.float64).numpy()
        np.testing.assert_array_equal(got, arr.astype(np.float64), name)
        assert not used[start:start + got[0].size].any(), name
        used[start:start + got[0].size] = True
    assert not table[:, ~used].any()
    sources = {"bond_len": ff.SC_BOND_LEN, "bond_ang": ff.SC_BOND_ANG,
               "torsion_const": ff.SC_TORSION_CONST,
               "torsion_offset": ff.SC_TORSION_PI_OFFSET,
               "torsion_type": ff.SC_TORSION_TYPE,
               "torsion_src": ff.SC_TORSION_SRC, "frame": ff.SC_FRAME_IDX,
               "num_atoms": ff.SC_NUM_ATOMS}
    assert set(S.TABLE_LAYOUT) == set(sources)
    for name, arr in sources.items():
        assert S.TABLE_LAYOUT[name][1] is arr, name


def test_table_layout_is_the_kernels():
    """csrc/sidechain.cu reads the records at its own constants: they must
    be TABLE_LAYOUT's offsets and RECORD."""
    src = open(os.path.join(os.path.dirname(S.__file__), "..", "csrc",
                            "sidechain.cu")).read()
    const = {m[0]: int(m[1]) for m in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    names = {"bond_len": "kBondLen", "bond_ang": "kBondAng",
             "torsion_const": "kTorConst", "torsion_offset": "kTorOffset",
             "torsion_type": "kTorType", "torsion_src": "kTorSrc",
             "frame": "kFrame", "num_atoms": "kNumAtoms"}
    assert {name: const[c] for name, c in names.items()} == {
        name: start for name, (start, _) in S.TABLE_LAYOUT.items()}
    assert const["kRecord"] == S.RECORD
    assert const["kTypes"] == S.N_TYPES
    assert const["kChi0"] == SC_ANGLES_START_POS
    assert const["kAnchor"] == ff.ANCHOR_IDX


@pytest.mark.parametrize("case", [((2, 12), False), ((3, 45), True),
                                  ((4, 1), False)],
                         ids=["B2-L12", "B3-L45-every-type", "B4-L1"])
def test_plain_build_equals_the_tables_route(case):
    """build_sidechains_torch (the packed table, one gather) equals the
    one-array-at-a-time lookups bit for bit: residue 0's frame override,
    rows of one residue, every type and ids outside the table."""
    shape, every_type = case
    bb, ang, ids = kernel_inputs(shape, seed=4, physical=True,
                                 every_type=every_type)
    if every_type:
        assert set(range(24)) | set(OUT_OF_TABLE_IDS) <= set(ids.ravel().tolist())
    got_inputs = S.sidechain_inputs(bb, ang, ids)
    want_inputs = tables_route(bb, ang, ids)
    for name, g, w in zip(("anchor", "torsions", "blen", "bang", "n_sc",
                           "frame"), got_inputs, want_inputs):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    got = S.build_sidechains_torch(bb, ang, ids)
    assert torch.equal(got, S.build_sidechain_points_torch(bb, *want_inputs))
    assert torch.equal(got, tgeo.build_sidechains(bb, ang, ids, "torch"))
    assert torch.equal(got[:, :, :4], bb)


def test_cuda_impl_on_cpu_tensors_raises_and_does_not_fall_back():
    bb, ang, ids = kernel_inputs()
    with pytest.raises(ValueError, match="CUDA device"):
        S.build_sidechains(bb, ang, ids, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        S.build_sidechains(bb.requires_grad_(), ang, ids, impl="cuda")
    ang_np, ids_np = sidechain_case(np.random.default_rng(0), 1, 8, True)
    with pytest.raises(ValueError, match="CUDA device"):
        port_build(ang_np, ids_np, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        S.sidechain_fwd_cuda(bb.detach(), ang, ids)
    with pytest.raises(ValueError, match="CUDA device"):
        S.sidechain_bwd_cuda(torch.zeros(2, 12, 14, 3), ang, ids,
                             torch.zeros(2, 12, 14, 3))


@pytest.fixture
def plain_launchers(monkeypatch):
    """The two launch functions replaced by their plain versions, with the
    device check left out: what the autograd wiring around the kernels does
    can then be followed on the CPU. Returns the call counts."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(bb, angles, seq):
        assert all(t.is_contiguous() for t in (bb, angles, seq))
        calls["fwd"] += 1
        return S.build_sidechains_torch(bb, angles, seq)

    def bwd(built, angles, seq, g_out):
        assert g_out.is_contiguous()
        calls["bwd"] += 1
        bb = built[..., :4, :].detach().clone().requires_grad_()
        angles = angles.detach().clone().requires_grad_()
        with torch.enable_grad():
            out = S.build_sidechains_torch(bb, angles, seq)
        return torch.autograd.grad(out, (bb, angles), g_out)

    monkeypatch.setattr(S, "sidechain_fwd_cuda", fwd)
    monkeypatch.setattr(S, "sidechain_bwd_cuda", bwd)
    return calls


def test_kernel_path_saves_nothing_without_grad(plain_launchers):
    """Under no_grad and inference_mode, and for inputs that need no
    gradient, the kernel path is the forward launch alone: no autograd node,
    nothing saved, although the inputs may require grad."""
    bb, ang, ids = kernel_inputs()
    bb = bb.requires_grad_()
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            out = S.build_sidechains(bb, ang, ids, impl="cuda")
        assert out.grad_fn is None and not out.requires_grad
    out = S.build_sidechains(bb.detach(), ang, ids, impl="cuda")
    assert out.grad_fn is None
    assert plain_launchers == {"fwd": 3, "bwd": 0}
    out = S.build_sidechains(bb, ang, ids, impl="cuda")
    assert out.grad_fn is not None
    assert plain_launchers == {"fwd": 4, "bwd": 0}
    out = S.build_sidechains(bb.detach(), ang.requires_grad_(), ids,
                             impl="cuda")
    assert out.grad_fn is not None
    assert plain_launchers == {"fwd": 5, "bwd": 0}


def test_kernel_path_autograd_wiring(plain_launchers):
    """SidechainBuild hands the backward kernel the built points, the angles
    and a contiguous cotangent, and returns the backbone's and the angles'
    cotangents in input order; the whole build's angle gradients (through
    the backbone and straight from the torsions) then equal the plain
    path's."""
    ang, ids = sidechain_case(np.random.default_rng(3), 2, 16, False)
    grads = {}
    for impl in ("cuda", "torch"):
        t_ang = torch.from_numpy(ang).requires_grad_()
        crd = tgeo.build_coords_batch(t_ang, torch.from_numpy(ids), impl)
        # a transposed view makes the incoming cotangent non-contiguous
        torch.sin(0.3 * crd.transpose(0, 1)).sum().backward()
        grads[impl] = t_ang.grad
    assert plain_launchers == {"fwd": 1, "bwd": 1}
    assert grads["torch"][..., 6:].abs().max() > 0  # the chi columns
    torch.testing.assert_close(grads["cuda"], grads["torch"], rtol=1e-5,
                               atol=1e-6)


def test_padded_rows_are_finite_with_finite_gradients():
    ang, ids = sidechain_case(np.random.default_rng(5), 3, 20, False)
    ang[2], ids[2] = 0.0, PAD_ID  # a row of padding only
    t_ang = torch.from_numpy(ang).requires_grad_()
    crd = port_build(t_ang.detach().numpy(), ids)
    assert torch.isfinite(crd).all() and (crd[2, :, 4:] == 0).all()
    tgeo.build_coords_batch(t_ang, torch.from_numpy(ids),
                            "torch").square().sum().backward()
    assert torch.isfinite(t_ang.grad).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def poison_allocator(cuda):
    """Leave NaNs where the caching allocator hands out the next blocks, so
    that an output entry the kernels fail to write shows."""
    torch.full((64 << 20,), float("nan"), device=cuda)
    torch.cuda.synchronize()


# (B, L), every type: the eval and train batches, the longest proteins, rows
# whose residue 0 falls inside a block (L = 37, 500), lone residues, and
# every row of the table with ids outside it
CARD_CASES = [((8, 256), False), ((16, 256), False), ((8, 500), False),
              ((3, 37), False), ((1, 1), False), ((5, 1), False),
              ((3, 45), True)]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("physical", [True, False],
                         ids=["physical", "full-range"])
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: f"B{c[0][0]}-L{c[0][1]}"
                                       + ("-every-type" if c[1] else ""))
def test_kernels_match_plain_on_card(cuda, case, physical):
    """K2a and K2b against the plain version and autograd through it, on
    outputs the allocator hands out NaN-filled; the same bits twice."""
    shape, every_type = case
    bb, ang, ids = (t.to(cuda) for t in kernel_inputs(
        shape, seed=sum(shape), physical=physical, every_type=every_type))
    plain_in = [t.clone().requires_grad_() for t in (bb, ang)]
    kern_in = [t.clone().requires_grad_() for t in (bb, ang)]
    want = S.build_sidechains(*plain_in, ids, impl="torch")
    torch.sin(0.3 * want).sum().backward()
    before = (S.sidechain_fwd_cuda.launches, S.sidechain_bwd_cuda.launches)
    poison_allocator(cuda)
    got = S.build_sidechains(*kern_in, ids, impl="cuda")
    torch.sin(0.3 * got).sum().backward()
    torch.cuda.synchronize()
    assert (S.sidechain_fwd_cuda.launches,
            S.sidechain_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, :, :4], bb)
    # the float64 plain build is the yardstick: the fp32 plain build
    # itself strays by several roundings of a large coordinate
    exact = S.build_sidechains_torch(bb.double(), ang.double(), ids)
    k_far = float((got.detach() - exact).abs().max())
    p_far = float((want.detach() - exact).abs().max())
    assert k_far <= 2 * p_far + 1e-5
    if physical:
        assert k_far <= 1e-4
        assert float((got - want).detach().abs().max()) <= 1e-4 + p_far
    n_sc = S.sidechain_inputs(bb, ang, ids)[4]
    dead = torch.arange(10, device=cuda) >= n_sc[..., None]
    assert (got[:, :, 4:][dead] == 0).all()
    for k, p in zip(kern_in, plain_in):
        assert torch.isfinite(k.grad).all()
        assert float((k.grad - p.grad).abs().max()) <= 1e-4 * max(
            1.0, float(p.grad.abs().max()))
    first = [got.detach(), *(k.grad for k in kern_in)]
    again_in = [t.detach().clone().requires_grad_() for t in (bb, ang)]
    poison_allocator(cuda)
    again = S.build_sidechains(*again_in, ids, impl="cuda")
    torch.sin(0.3 * again).sum().backward()
    for a, b in zip(first, [again.detach(), *(k.grad for k in again_in)]):
        assert torch.equal(a, b)


@pytest.mark.needs_cuda
def test_build_coords_batch_never_synchronises_on_card(cuda):
    """The whole coordinate build, forward and backward through K2a and K2b,
    at B=16 x L=256 without a single stream synchronisation: no table
    copied per call, no constant made from the host per call."""
    ang, ids = sidechain_case(np.random.default_rng(0), 16, 256, True)
    ang = torch.from_numpy(ang).to(cuda).requires_grad_()
    ids = torch.from_numpy(ids).to(cuda).long()
    before = (S.sidechain_fwd_cuda.launches, S.sidechain_bwd_cuda.launches)
    tgeo.build_coords_batch(ang, ids).sum().backward()  # the one-time tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        crd = tgeo.build_coords_batch(ang, ids)
        torch.autograd.grad(torch.sin(0.3 * crd).sum(), ang)
        with torch.no_grad():
            tgeo.build_coords_batch(ang, ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (S.sidechain_fwd_cuda.launches,
            S.sidechain_bwd_cuda.launches) == (before[0] + 3, before[1] + 2)
