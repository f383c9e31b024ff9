"""dRMSD statistics of the PyTorch port against the JAX package.

The port's plain version (``ops.drmsd.drmsd_stats_torch``) is held against
the JAX package's tiled XLA statistics (``losses._drmsd_stats``) and its
Pallas kernel (``ops.drmsd_pallas.drmsd_stats_pallas``) run in interpret
mode, exactly as tests/test_pallas_kernel.py runs it. Tolerance: dRMSD
<= 1e-4 A (both sides sum fp32 in different orders), pair counts exact.

JAX is imported inside the tests, not at the top, so that the card-only
test below also collects where JAX is not installed
(``python -m pytest --noconftest -m needs_cuda tests/test_torch_drmsd.py``).
"""
import functools

import numpy as np
import pytest
import torch

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
    with pytest.raises(ValueError, match="CUDA device"):
        D.drmsd_stats_cuda(a, a, torch.ones(4, dtype=torch.bool))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("drmsd_fwd")
    assert not (tmp_path / "build").exists()


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
