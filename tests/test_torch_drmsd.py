"""dRMSD statistics and their gradients, PyTorch port against the JAX
package.

The port's plain versions (``ops.drmsd.drmsd_stats_torch``,
``drmsd_stats_grad_torch``, ``drmsd_grad_b_torch``) are held against the
JAX package's tiled XLA statistics (``losses._drmsd_stats``) and its Pallas
kernels (``ops.drmsd_pallas``) run in interpret mode, exactly as
tests/test_pallas_kernel.py runs them. Tolerances: dRMSD <= 1e-4 A and pair
counts exact; gradients within 1e-4 * max(1, max|g|), the gate of
tests/test_pallas_kernel.py (both sides sum fp32 in different orders).

JAX is imported inside the tests, not at the top, so that the card-only
test below also collects where JAX is not installed
(``python -m pytest --noconftest -m needs_cuda tests/test_torch_drmsd.py``).
"""
import functools

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.data.synthetic import atom_mask_case
from protein_transformer_tpu_torch.ops import _build
from protein_transformer_tpu_torch.ops import drmsd as D

CPU = torch.device("cpu")


@pytest.fixture
def jax_ref(monkeypatch):
    """The JAX reference, with pallas_call patched into interpret mode."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl

    from protein_transformer_tpu import losses as L
    from protein_transformer_tpu.ops import drmsd_pallas as dp
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return L, dp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cloud(rng, bsz, n, valid=0.7):
    a = rng.normal(0, 10, (bsz, n, 3)).astype(np.float32)
    b = rng.normal(0, 10, (bsz, n, 3)).astype(np.float32)
    m = rng.random((bsz, n)) < valid
    return a, b, m


def structured_batch(n, seed):
    """A batch of the training step's masks at n atoms (``atom_mask_case``:
    two proteins with each residue's real slots, 2% missing and a padded
    tail, then an all-masked one), then one protein with exactly one valid
    atom and one with exactly two."""
    rng = np.random.default_rng(seed)
    a, b, _ = cloud(rng, 5, n)
    m = np.zeros((5, n), bool)
    m[:3] = atom_mask_case(rng, 3, n)
    m[3, rng.integers(n)] = True
    m[4, rng.choice(n, 2, replace=False)] = True
    return a, b, m


# around the kernels' 128-atom tile edge, and past two tiles
EDGE_N = [127, 128, 129, 255, 257]


def drmsd_of(s, c):
    return float(np.sqrt(max(float(s) / max(float(c), 1.0), 1e-30)))


def port_stats(a, b, m):
    s, c = D.drmsd_stats_torch(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(m))
    return s.numpy(), c.numpy()


def test_plain_matches_xla_and_pallas_multi_tile(jax_ref):
    L, dp = jax_ref
    import jax.numpy as jnp
    a, b, m = cloud(np.random.default_rng(0), 1, 600)  # > one 512 tile
    s, c = port_stats(a, b, m)
    assert c.dtype == np.int64
    xs, xc = L._drmsd_stats(jnp.asarray(a[0]), jnp.asarray(b[0]),
                            jnp.asarray(m[0]))
    ps, pc = dp.drmsd_stats_pallas(jnp.asarray(a[0]), jnp.asarray(b[0]),
                                   jnp.asarray(m[0]))
    assert int(c[0]) == int(xc) == int(pc)
    got = drmsd_of(s[0], c[0])
    assert abs(got - drmsd_of(xs, xc)) <= 1e-4
    assert abs(got - drmsd_of(ps, pc)) <= 1e-4


def test_batch_with_different_masks_and_an_empty_protein(jax_ref):
    L, dp = jax_ref
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    a, b, m = cloud(rng, 3, 300)
    m[1] = rng.random(300) < 0.2
    m[2] = False  # all-masked protein
    s, c = port_stats(a, b, m)
    for i in range(3):
        xs, xc = L._drmsd_stats(jnp.asarray(a[i]), jnp.asarray(b[i]),
                                jnp.asarray(m[i]))
        assert int(c[i]) == int(xc)
        assert abs(drmsd_of(s[i], c[i]) - drmsd_of(xs, xc)) <= 1e-4
    ps, pc = dp.drmsd_stats_pallas(jnp.asarray(a[1]), jnp.asarray(b[1]),
                                   jnp.asarray(m[1]))
    assert int(c[1]) == int(pc)
    assert abs(drmsd_of(s[1], c[1]) - drmsd_of(ps, pc)) <= 1e-4
    assert c[2] == 0 and s[2] == 0.0 and np.isfinite(s).all()


def test_leading_dims_and_row_blocks():
    """(B, N) batches equal per-protein calls, across several row blocks."""
    a, b, m = cloud(np.random.default_rng(2), 2, D.ROW_BLOCK + 37)
    s, c = port_stats(a, b, m)
    for i in range(2):
        si, ci = port_stats(a[i], b[i], m[i])
        assert int(ci) == int(c[i])
        np.testing.assert_allclose(si, s[i], rtol=1e-6)


def test_resolve_impl():
    assert D.resolve_impl("auto", CPU) == "torch"
    assert D.resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert D.resolve_impl("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="unknown dRMSD impl"):
        D.resolve_impl("pallas", CPU)


def test_cuda_impl_on_cpu_tensors_raises():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        D.drmsd_stats(a, a, torch.ones(4, dtype=torch.bool), impl="cuda")
    for kernel in (D.drmsd_stats_cuda, D.drmsd_stats_grad_cuda,
                   D.drmsd_grad_b_cuda):
        with pytest.raises(ValueError, match="CUDA device"):
            kernel(a, a, torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA device"):
        D.drmsd_stats(a.requires_grad_(), a, torch.ones(4, dtype=torch.bool),
                      impl="cuda")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("drmsd_fwd")
    assert not (tmp_path / "build").exists()


def grad_gate(got, want):
    """The gradient gate of tests/test_pallas_kernel.py."""
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_plain_grads_match_pallas_vjp(jax_ref):
    """d dRMSD / d(a, b) of the port (DrmsdStats on its plain versions)
    against jax.grad of the Pallas kernels' custom VJP, for a padded batch:
    two tiles of 512, a sparse protein and an all-masked one."""
    _, dp = jax_ref
    import jax
    import jax.numpy as jnp
    from protein_transformer_tpu_torch import losses as TL
    rng = np.random.default_rng(3)
    a, b, m = cloud(rng, 3, 560)
    m[1] = rng.random(560) < 0.2
    m[2] = False
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    TL.drmsd_masked(ta, tb, torch.from_numpy(m)).sum().backward()
    assert torch.isfinite(ta.grad).all() and torch.isfinite(tb.grad).all()
    assert (ta.grad[2] == 0).all() and (tb.grad[2] == 0).all()
    grad = jax.jit(jax.grad(dp.drmsd_masked_pallas, argnums=(0, 1)))
    for i in range(2):
        ga, gb = grad(jnp.asarray(a[i]), jnp.asarray(b[i]),
                      jnp.asarray(m[i]))
        assert grad_gate(ta.grad[i], ga) and grad_gate(tb.grad[i], gb)


@pytest.mark.parametrize("n", EDGE_N)
def test_plain_matches_pallas_on_structured_masks(jax_ref, n):
    """The plain versions against the Pallas kernels (interpret mode) on the
    training step's masks, an all-masked protein and proteins with one and
    two valid atoms: S, C and the gradients of the dRMSD in a and b."""
    _, dp = jax_ref
    import jax
    import jax.numpy as jnp
    from protein_transformer_tpu_torch import losses as TL
    a, b, m = structured_batch(n, n)
    s, c = port_stats(a, b, m)
    assert c[2] == 0 and c[3] == 0 and c[4] == 1
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    TL.drmsd_masked(ta, tb, torch.from_numpy(m)).sum().backward()
    stats = jax.jit(dp.drmsd_stats_pallas)
    grad = jax.jit(jax.grad(dp.drmsd_masked_pallas, argnums=(0, 1)))
    for i in range(5):
        args = [jnp.asarray(x[i]) for x in (a, b, m)]
        ps, pc = stats(*args)
        assert int(c[i]) == int(pc)
        assert abs(drmsd_of(s[i], c[i]) - drmsd_of(ps, pc)) <= 1e-4
        ga, gb = grad(*args)
        assert grad_gate(ta.grad[i], ga) and grad_gate(tb.grad[i], gb)
    assert not ta.grad[2:4].any() and not tb.grad[2:4].any()


def test_bound_of_k1a_is_the_special_function_unit():
    """chip_smoke's bound at K1a's table row (B=8 x 3584 atoms, 22,218,809
    valid pairs): two rsqrt a pair over 132 SMs x 16 a clock x 1.98 GHz take
    longer than its 25 fp32 operations a pair over 67 TFLOP/s."""
    import chip_smoke
    pairs = 22_218_809
    n_bytes = 8 * 3584 * 25 + 8 * 12
    ms, by = chip_smoke.bound(
        n_bytes, chip_smoke.FLOPS_PER_PAIR["drmsd_fwd"] * pairs,
        special=chip_smoke.SPECIAL_PER_PAIR["drmsd_fwd"] * pairs)
    assert by == "special functions"
    assert ms == pytest.approx(1e3 * 2 * pairs / (132 * 16 * 1.98e9))
    assert round(ms, 4) == 0.0106
    fp32_ms, fp32_by = chip_smoke.bound(
        n_bytes, chip_smoke.FLOPS_PER_PAIR["drmsd_fwd"] * pairs)
    assert fp32_by == "operations" and fp32_ms == pytest.approx(0.00829,
                                                                 rel=1e-3)
    assert chip_smoke.bound(1e9, 1.0, special=1.0)[1] == "bytes"


def test_plain_grads_match_autograd():
    """The explicit gradient formulas against torch.autograd through the
    plain statistics, over several row blocks."""
    rng = np.random.default_rng(4)
    a, b, m = cloud(rng, 2, D.ROW_BLOCK + 90)
    m[1, ::3] = False
    ta, tb, tm = (torch.from_numpy(x) for x in (a, b, m))
    w = torch.tensor([0.5, 2.0])
    a1, b1 = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    s, c = D.drmsd_stats_torch(a1, b1, tm)
    (s * w).sum().backward()
    s2, c2, ga = D.drmsd_stats_grad_torch(ta, tb, tm)
    gb = D.drmsd_grad_b_torch(ta, tb, tm)
    assert torch.equal(c, c2)
    torch.testing.assert_close(s2, s.detach(), rtol=1e-6, atol=0)
    for got, want in ((ga * w[:, None, None], a1.grad),
                      (gb * w[:, None, None], b1.grad)):
        assert grad_gate(got, want)


def test_grad_b_runs_only_when_b_needs_grad(monkeypatch):
    """The b-side gradient (K1c's plain version here) is computed in the
    backward only when b requires grad; the a-side one comes from the
    forward sweep (K1b), and no-grad calls take the forward statistics."""
    calls = {"fwd": 0, "fwd_grad": 0, "grad_b": 0}
    for key, name in (("fwd", "drmsd_stats_torch"),
                      ("fwd_grad", "drmsd_stats_grad_torch"),
                      ("grad_b", "drmsd_grad_b_torch")):
        def counted(*args, _fn=getattr(D, name), _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(D, name, counted)
    a, b, m = (torch.from_numpy(x)
               for x in cloud(np.random.default_rng(5), 2, 40))
    a = a.requires_grad_()
    s, c = D.drmsd_stats(a, b, m)
    assert not c.requires_grad and c.dtype == torch.int64
    s.sum().backward()
    assert a.grad is not None and b.grad is None
    assert calls == {"fwd": 0, "fwd_grad": 1, "grad_b": 0}
    b = b.clone().requires_grad_()
    D.drmsd_stats(a.detach(), b, m)[0].sum().backward()
    assert b.grad is not None and calls["grad_b"] == 1
    assert calls["fwd"] == 1  # a needed no gradient: the forward sweep
    with torch.no_grad():
        D.drmsd_stats(a, b, m)
    assert calls == {"fwd": 2, "fwd_grad": 1, "grad_b": 1}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n", [1, 5, 129, 600, 768, 3584])
def test_kernel_matches_plain_on_card(cuda, n):
    rng = np.random.default_rng(n)
    a, b, m = cloud(rng, 4, n)
    m[3] = False
    ta, tb, tm = (torch.from_numpy(x).to(cuda) for x in (a, b, m))
    before = D.drmsd_stats_cuda.launches
    ks, kc = D.drmsd_stats_cuda(ta, tb, tm)
    assert D.drmsd_stats_cuda.launches == before + 1
    ps, pc = D.drmsd_stats_torch(ta, tb, tm)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc)
    assert torch.isfinite(ks).all()
    kd = torch.sqrt(torch.clamp(ks / kc.clamp(min=1), min=1e-30))
    pd = torch.sqrt(torch.clamp(ps / pc.clamp(min=1), min=1e-30))
    assert float((kd - pd).abs().max()) <= 1e-4
    # same inputs, same bits: the reduction order is fixed
    ks2, _ = D.drmsd_stats_cuda(ta, tb, tm)
    assert torch.equal(ks, ks2)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n", [1, 5, 129, 600, 768, 3584])
def test_train_kernels_match_plain_on_card(cuda, n):
    """K1b and K1c against their plain versions; K1b's S has K1a's bits."""
    rng = np.random.default_rng(n + 1)
    a, b, m = cloud(rng, 4, n)
    m[3] = False
    ta, tb, tm = (torch.from_numpy(x).to(cuda) for x in (a, b, m))
    before = (D.drmsd_stats_grad_cuda.launches, D.drmsd_grad_b_cuda.launches)
    ks, kc, kga = D.drmsd_stats_grad_cuda(ta, tb, tm)
    kgb = D.drmsd_grad_b_cuda(ta, tb, tm)
    assert (D.drmsd_stats_grad_cuda.launches,
            D.drmsd_grad_b_cuda.launches) == (before[0] + 1, before[1] + 1)
    ps, pc, pga = D.drmsd_stats_grad_torch(ta, tb, tm)
    pgb = D.drmsd_grad_b_torch(ta, tb, tm)
    fs, fc = D.drmsd_stats_cuda(ta, tb, tm)
    torch.cuda.synchronize()
    assert torch.equal(kc, pc) and torch.equal(kc, fc)
    assert torch.equal(ks, fs)
    kd = torch.sqrt(torch.clamp(ks / kc.clamp(min=1), min=1e-30))
    pd = torch.sqrt(torch.clamp(ps / pc.clamp(min=1), min=1e-30))
    assert float((kd - pd).abs().max()) <= 1e-4
    assert grad_gate(kga.cpu(), pga.cpu()) and grad_gate(kgb.cpu(), pgb.cpu())
    assert (kga[3] == 0).all() and (kgb[3] == 0).all() and ks[3] == 0
    ks2, _, kga2 = D.drmsd_stats_grad_cuda(ta, tb, tm)
    assert torch.equal(ks, ks2) and torch.equal(kga, kga2)
    assert torch.equal(kgb, D.drmsd_grad_b_cuda(ta, tb, tm))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n", EDGE_N + [3584])
def test_kernels_on_structured_masks_on_card(cuda, n):
    """K1a, K1b and K1c against their plain versions on the training step's
    masks, an all-masked protein and proteins with one and two valid atoms:
    counts equal, K1b's S has K1a's bits, the same bits on a second call,
    exact zeros where there is no pair."""
    a, b, m = structured_batch(n, n + 7)
    ta, tb, tm = (torch.from_numpy(x).to(cuda) for x in (a, b, m))
    fs, fc = D.drmsd_stats_cuda(ta, tb, tm)
    ks, kc, kga = D.drmsd_stats_grad_cuda(ta, tb, tm)
    kgb = D.drmsd_grad_b_cuda(ta, tb, tm)
    ps, pc, pga = D.drmsd_stats_grad_torch(ta, tb, tm)
    pgb = D.drmsd_grad_b_torch(ta, tb, tm)
    torch.cuda.synchronize()
    assert torch.equal(fc, pc) and torch.equal(kc, pc)
    assert torch.equal(ks, fs)
    kd = torch.sqrt(torch.clamp(fs / fc.clamp(min=1), min=1e-30))
    pd = torch.sqrt(torch.clamp(ps / pc.clamp(min=1), min=1e-30))
    assert float((kd - pd).abs().max()) <= 1e-4
    assert grad_gate(kga.cpu(), pga.cpu()) and grad_gate(kgb.cpu(), pgb.cpu())
    assert int(kc[4]) == 1
    for i in (2, 3):
        assert fs[i] == 0 and kc[i] == 0
        assert not kga[i].any() and not kgb[i].any()
    assert torch.equal(D.drmsd_stats_cuda(ta, tb, tm)[0], fs)
    ks2, _, kga2 = D.drmsd_stats_grad_cuda(ta, tb, tm)
    assert torch.equal(ks2, ks) and torch.equal(kga2, kga)
    assert torch.equal(D.drmsd_grad_b_cuda(ta, tb, tm), kgb)


@pytest.mark.needs_cuda
def test_drmsd_stats_autograd_on_card(cuda):
    """DrmsdStats on CUDA tensors runs K1b forward and K1c only for b."""
    a, b, m = (torch.from_numpy(x).to(cuda)
               for x in cloud(np.random.default_rng(9), 3, 700))
    a = a.requires_grad_()
    counts = (D.drmsd_stats_cuda.launches, D.drmsd_stats_grad_cuda.launches,
              D.drmsd_grad_b_cuda.launches)
    s, _ = D.drmsd_stats(a, b, m)
    s.sum().backward()
    assert (D.drmsd_stats_cuda.launches, D.drmsd_stats_grad_cuda.launches,
            D.drmsd_grad_b_cuda.launches) == (counts[0], counts[1] + 1,
                                              counts[2])
    _, _, ga = D.drmsd_stats_grad_torch(a.detach(), b, m)
    assert grad_gate(a.grad.cpu(), ga.cpu())
