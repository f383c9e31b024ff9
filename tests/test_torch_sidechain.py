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

The kernels' autograd wiring is exercised on the CPU with the two launch
functions replaced by their plain versions; the kernels themselves run in
the card-only test at the end:

    python -m pytest --noconftest -m needs_cuda tests/test_torch_sidechain.py

JAX is imported inside the tests, so that the card-only test also collects
where JAX is not installed.
"""
import functools

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.data.synthetic import sidechain_case
from protein_transformer_tpu_torch.ops import sidechain as S
from protein_transformer_tpu_torch.protein import _ff14sb as ff
from protein_transformer_tpu_torch.protein import geometry as tgeo

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


def kernel_inputs(shape=(2, 12), seed=0, physical=False):
    ang, ids = sidechain_case(np.random.default_rng(seed), *shape, physical)
    ang, ids = torch.from_numpy(ang), torch.from_numpy(ids)
    bb = tgeo.build_backbone(ang)
    return (bb, *tgeo.sidechain_inputs(bb, ang, ids))


def test_resolve_impl():
    assert S.resolve_impl("auto", CPU) == "torch"
    assert S.resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert S.resolve_impl("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="unknown sidechain impl"):
        S.resolve_impl("pallas", CPU)


def test_cuda_impl_on_cpu_tensors_raises_and_does_not_fall_back():
    args = kernel_inputs()
    with pytest.raises(ValueError, match="CUDA device"):
        S.build_sidechain_points(*args, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        S.build_sidechain_points(args[0].requires_grad_(), *args[1:],
                                 impl="cuda")
    ang, ids = sidechain_case(np.random.default_rng(0), 1, 8, True)
    with pytest.raises(ValueError, match="CUDA device"):
        port_build(ang, ids, impl="cuda")
    ints = [a.to(torch.int32) for a in args[5:]]
    with pytest.raises(ValueError, match="CUDA device"):
        S.sidechain_fwd_cuda(*args[:5], *ints)
    with pytest.raises(ValueError, match="CUDA device"):
        S.sidechain_bwd_cuda(torch.zeros(2, 12, 14, 3), *args[1:5], *ints,
                             torch.zeros(2, 12, 14, 3))


@pytest.fixture
def plain_launchers(monkeypatch):
    """The two launch functions replaced by their plain versions, with the
    device check left out: what the autograd wiring around the kernels does
    can then be followed on the CPU. Returns the call counts."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(bb, anchor, tor, blen, bang, n_sc, fidx):
        assert n_sc.dtype == fidx.dtype == torch.int32
        calls["fwd"] += 1
        return S.build_sidechain_points_torch(bb, anchor, tor, blen, bang,
                                              n_sc, fidx)

    def bwd(built, anchor, tor, blen, bang, n_sc, fidx, g_out):
        assert g_out.is_contiguous()
        calls["bwd"] += 1
        bb = built[..., :4, :].detach().clone().requires_grad_()
        anchor = anchor.detach().clone().requires_grad_()
        tor = tor.detach().clone().requires_grad_()
        with torch.enable_grad():
            out = S.build_sidechain_points_torch(bb, anchor, tor, blen, bang,
                                                 n_sc, fidx)
        return torch.autograd.grad(out, (bb, anchor, tor), g_out)

    monkeypatch.setattr(S, "sidechain_fwd_cuda", fwd)
    monkeypatch.setattr(S, "sidechain_bwd_cuda", bwd)
    return calls


def test_kernel_path_saves_nothing_without_grad(plain_launchers):
    """Under no_grad and inference_mode, and for inputs that need no
    gradient, the kernel path is the forward launch alone: no autograd node,
    nothing saved, although the inputs may require grad."""
    bb, *rest = kernel_inputs()
    bb = bb.requires_grad_()
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            out = S.build_sidechain_points(bb, *rest, impl="cuda")
        assert out.grad_fn is None and not out.requires_grad
    out = S.build_sidechain_points(bb.detach(), *rest, impl="cuda")
    assert out.grad_fn is None
    assert plain_launchers == {"fwd": 3, "bwd": 0}
    out = S.build_sidechain_points(bb, *rest, impl="cuda")
    assert out.grad_fn is not None
    assert plain_launchers == {"fwd": 4, "bwd": 0}


def test_kernel_path_autograd_wiring(plain_launchers):
    """SidechainBuild hands the backward kernel the built points and a
    contiguous cotangent, and returns its three cotangents in input order;
    the whole build's angle gradients then equal the plain path's."""
    ang, ids = sidechain_case(np.random.default_rng(3), 2, 16, False)
    grads = {}
    for impl in ("cuda", "torch"):
        t_ang = torch.from_numpy(ang).requires_grad_()
        crd = tgeo.build_coords_batch(t_ang, torch.from_numpy(ids), impl)
        # a transposed view makes the incoming cotangent non-contiguous
        torch.sin(0.3 * crd.transpose(0, 1)).sum().backward()
        grads[impl] = t_ang.grad
    assert plain_launchers == {"fwd": 1, "bwd": 1}
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


@pytest.mark.needs_cuda
@pytest.mark.parametrize("physical", [True, False],
                         ids=["physical", "full-range"])
@pytest.mark.parametrize("shape", [(8, 256), (3, 37), (1, 1)],
                         ids=lambda s: f"B{s[0]}-L{s[1]}")
def test_kernels_match_plain_on_card(cuda, shape, physical):
    """K2a and K2b against the plain version and autograd through it."""
    inputs = [t.to(cuda) for t in kernel_inputs(shape, seed=sum(shape),
                                                physical=physical)]
    plain_in = [t.clone().requires_grad_() for t in inputs[:3]]
    kern_in = [t.clone().requires_grad_() for t in inputs[:3]]
    want = S.build_sidechain_points(*plain_in, *inputs[3:], impl="torch")
    before = (S.sidechain_fwd_cuda.launches, S.sidechain_bwd_cuda.launches)
    got = S.build_sidechain_points(*kern_in, *inputs[3:], impl="cuda")
    torch.sin(0.3 * want).sum().backward()
    torch.sin(0.3 * got).sum().backward()
    torch.cuda.synchronize()
    assert (S.sidechain_fwd_cuda.launches,
            S.sidechain_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(got).all()
    # the float64 plain build is the yardstick: the fp32 plain build
    # itself strays by several roundings of a large coordinate
    exact = S.build_sidechain_points(
        *(t.double() for t in inputs[:5]), *inputs[5:], impl="torch")
    k_far = float((got.detach() - exact).abs().max())
    p_far = float((want.detach() - exact).abs().max())
    assert k_far <= 2 * p_far + 1e-5
    if physical:
        assert k_far <= 1e-4
        assert float((got - want).detach().abs().max()) <= 1e-4 + p_far
    dead = (torch.arange(10, device=cuda) >= inputs[5][..., None])
    assert (got[:, :, 4:][dead] == 0).all()
    for k, p in zip(kern_in, plain_in):
        assert torch.isfinite(k.grad).all()
        assert float((k.grad - p.grad).abs().max()) <= 1e-4 * max(
            1.0, float(p.grad.abs().max()))
    with torch.no_grad():
        again = S.build_sidechain_points(*kern_in, *inputs[3:], impl="cuda")
    assert torch.equal(again, got)
