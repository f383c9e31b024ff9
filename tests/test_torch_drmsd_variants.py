"""The dRMSD kernel variants of the port against the JAX tool's kernels.

The plain versions of ``ops.drmsd_variants`` (sqrt1, mxu, the mxu gradient)
are held against the three Pallas kernel bodies of the JAX package's
``tools/bench_drmsd_kernel.py`` (loaded from its file; ``pl.pallas_call``
patched into interpret mode), within that tool's own gates: S within 1e-5
relative (one square root a pair loses digits that two rsqrt keep: both
sides round in fp32 in different orders), pair counts equal, the gradient
within 1e-4 * max(1, max|g|). They are also held against the port's
production plain versions, on an all-masked protein and on a single atom.
The kernels themselves run on a card only (``-m needs_cuda``).

JAX is imported inside the tests, so that the card tests also collect where
JAX is not installed
(``python -m pytest --noconftest -m needs_cuda tests/test_torch_drmsd_variants.py``).
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.data.synthetic import atom_mask_case
from protein_transformer_tpu_torch.ops import drmsd as D
from protein_transformer_tpu_torch.ops import drmsd_variants as V
from protein_transformer_tpu_torch.tools import bench_drmsd_kernel as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = {"sqrt1": (V.drmsd_stats_sqrt1_torch, V.drmsd_stats_sqrt1_cuda,
                   "_fwd_kernel_sqrt1"),
         "mxu": (V.drmsd_stats_mxu_torch, V.drmsd_stats_mxu_cuda,
                 "_fwd_kernel_mxu")}


@pytest.fixture(scope="module", autouse=True)
def first_sqrt_call():
    """One large ``torch.sqrt`` before any test. With torch 2.13.0+cpu on 8
    threads, the first ``torch.sqrt`` call of a process that has already
    run other parallel operations was seen to return one thread's share of
    the elements wrong by up to 7e-4 relative, in about one process of
    three; later calls are exact. The one-root pair term takes a difference
    of ~1 between numbers of ~1e4, so it turns that into an error of 1e-3 in
    S, where the gates here are 1e-5."""
    torch.sqrt(torch.rand(1, 512, 700) * 1e8)


@pytest.fixture
def jax_tool(monkeypatch):
    """The JAX package's bench tool as a module, its Pallas kernels in
    interpret mode."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "jax_bench_drmsd_kernel",
        os.path.join(ROOT, "tools", "bench_drmsd_kernel.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def protein(n, seed=0, masked=0.2):
    """The tool's parity case at n atoms: a ~ N(0, 30), b = a + N(0, 1)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 30, (n, 3)).astype(np.float32)
    b = (a + rng.normal(0, 1, (n, 3))).astype(np.float32)
    return a, b, rng.random(n) > masked


def tensors(*arrays, device="cpu"):
    return [torch.from_numpy(x).to(device) for x in arrays]


def drmsd_of(s, c):
    """dRMSD from (S, C): sqrt(S / C), 0 where C = 0."""
    return torch.sqrt(s.clamp(min=0) / c.clamp(min=1).to(s.dtype))


@pytest.mark.parametrize("n", [700, 333])
@pytest.mark.parametrize("name", list(STATS))
def test_plain_stats_match_the_jax_tools_kernel(jax_tool, name, n):
    """Measured on the CPU: S within 4e-6 relative of the interpreted
    kernel."""
    import jax.numpy as jnp
    plain, _, kernel = STATS[name]
    a, b, m = protein(n)
    s, c = plain(*tensors(a, b, m))
    js, jc = jax_tool._call_fwd(
        getattr(jax_tool, kernel), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(m, jnp.float32), True)
    assert c.dtype == torch.int64 and int(c) == int(jc) > 0
    assert abs(float(s) - float(js)) <= 1e-5 * abs(float(js))


@pytest.mark.parametrize("n", [127, 129])
@pytest.mark.parametrize("name", list(STATS))
def test_plain_stats_match_the_jax_tools_kernel_on_structured_masks(
        jax_tool, name, n):
    """One protein of ``structured_batch`` at a time, on either side of the
    128-atom tile edge, against the tool's kernel (jitted, interpret mode):
    counts equal, 0 and 1 included; S within 1e-5 relative, and exactly 0
    where there is no pair."""
    import jax
    import jax.numpy as jnp
    plain, _, kernel = STATS[name]
    call = jax.jit(functools.partial(
        jax_tool._call_fwd, getattr(jax_tool, kernel), interpret=True))
    a, b, m = structured_batch(n, n + 11)
    counts = []
    for i in range(len(m)):
        s, c = plain(*tensors(a[i], b[i], m[i]))
        js, jc = call(jnp.asarray(a[i]), jnp.asarray(b[i]),
                      jnp.asarray(m[i], jnp.float32))
        assert c.dtype == torch.int64 and int(c) == int(jc)
        if int(c) == 0:
            assert float(s) == 0.0 == float(js)
        else:
            assert abs(float(s) - float(js)) <= 1e-5 * abs(float(js))
        counts.append(int(c))
    assert counts[2:] == [0, 0, 1] and min(counts[:2]) > 1000


@pytest.mark.parametrize("n", [700, 333])
def test_plain_gradient_matches_the_jax_tools_kernel(jax_tool, n):
    import jax.numpy as jnp
    a, b, m = protein(n)
    g = V.drmsd_grad_a_mxu_torch(*tensors(a, b, m)).numpy()
    jg = np.asarray(jax_tool._call_bwd(
        jax_tool._bwd_kernel_mxu, jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(m, jnp.float32), True))
    assert g.shape == jg.shape == (n, 3)
    assert np.abs(g[~m]).max() == 0.0
    assert np.abs(g - jg).max() <= 1e-4 * max(1.0, np.abs(jg).max())


@pytest.mark.parametrize("n", [700, 333, D.ROW_BLOCK + 37])
def test_plain_variants_match_the_production_plain_versions(n):
    """The tool's parity gates, plain against plain, in a batch of two
    proteins with different masks (several row blocks at the last size)."""
    a0, b0, m0 = protein(n, seed=1)
    a1, b1, m1 = protein(n, seed=2, masked=0.5)
    a, b, m = tensors(np.stack([a0, a1]), np.stack([b0, b1]),
                      np.stack([m0, m1]))
    want_s, want_c, want_g = D.drmsd_stats_grad_torch(a, b, m)
    for plain, _, _ in STATS.values():
        s, c = plain(a, b, m)
        assert torch.equal(c, want_c)
        assert ((s - want_s).abs() <= 1e-5 * want_s.abs()).all()
    g = V.drmsd_grad_a_mxu_torch(a, b, m)
    assert float((g - want_g).abs().max()) <= 1e-4 * max(
        1.0, float(want_g.abs().max()))
    # a batch equals its proteins taken one by one
    for i in range(2):
        si, ci = V.drmsd_stats_mxu_torch(a[i], b[i], m[i])
        assert int(ci) == int(want_c[i])
        np.testing.assert_allclose(float(si), float(s[i]), rtol=1e-6)


@pytest.mark.parametrize("case", ["all-masked", "one-atom", "one-valid"])
def test_plain_variants_on_proteins_without_a_pair(case):
    n = {"all-masked": 50, "one-atom": 1, "one-valid": 50}[case]
    a, b, m = tensors(*protein(n, seed=3))
    m = torch.zeros_like(m)
    if case != "all-masked":
        m[n // 2] = True
    for plain, _, _ in STATS.values():
        s, c = plain(a, b, m)
        assert float(s) == 0.0 and int(c) == 0
    g = V.drmsd_grad_a_mxu_torch(a, b, m)
    assert g.shape == a.shape and not g.any()


def test_plain_versions_run_in_float64_and_keep_tf32_setting():
    a, b, m = tensors(*protein(200, seed=4))
    before = torch.backends.cuda.matmul.allow_tf32
    s64, c = V.drmsd_stats_mxu_torch(a.double(), b.double(), m)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    want, want_c = D.drmsd_stats_torch(a.double(), b.double(), m)
    assert s64.dtype == torch.float64 and int(c) == int(want_c)
    assert abs(float(s64) - float(want)) <= 1e-9 * float(want)


@pytest.mark.parametrize("wrapper", [V.drmsd_stats_sqrt1_cuda,
                                     V.drmsd_stats_mxu_cuda,
                                     V.drmsd_grad_a_mxu_cuda],
                         ids=lambda f: f.__name__)
def test_kernel_wrappers_raise_on_cpu_tensors(wrapper):
    a, b, m = tensors(*protein(8))
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(a, b, m)
    assert wrapper.launches == before == 0


def test_tool_on_the_cpu_runs_parity_and_prints_no_time(capsys):
    out = tool.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert set(out) == {"parity"} and "parity OK" in printed
    assert out["parity"]["sqrt1"] < 1e-5 and out["parity"]["mxu"] < 1e-5
    assert " ms" not in printed and "bwd mxu: maxerr=" in printed
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tool.bench(torch.device("cpu"))


def test_device_records_takes_an_empty_trace_again(monkeypatch, capsys):
    """A trace without device records is taken again, up to three traces,
    each of ``calls`` calls after the one warm-up call: the count of calls
    ``bench`` keeps in ``CALLS``, and ``chip_smoke.py`` holds the kernels'
    launches to. On the CPU no trace holds a device record."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    with pytest.raises(RuntimeError, match="no device operation"):
        tool.device_records(lambda: calls.append(torch.ones(3).sum()), 2)
    assert len(calls) == 1 + 3 * 2
    assert capsys.readouterr().out.count("taking it again") == 2


def test_compare_outputs_names_the_kernels_whose_bits_differ(capsys):
    """What ``--compare-outputs`` reports: a kernel keeps its bits only if
    every output in every case is equal, by ``torch.equal``."""
    saved = {"cur": {"x": [torch.tensor([1.0, 2.0]), torch.tensor([3])]},
             "mxu": {"x": [torch.tensor([0.5])], "y": [torch.zeros(2, 3)]}}
    mine = {"cur": {"x": [torch.tensor([1.0, 2.0]), torch.tensor([3])]},
            "mxu": {"x": [torch.tensor([0.5])],
                    "y": [torch.tensor([[0.0, 0, 0], [0, 0, 2 ** -30]])]}}
    assert tool.compare_outputs(mine, saved) == {"cur": True, "mxu": False}
    assert "mxu: other bits in 2 cases" in capsys.readouterr().out
    with pytest.raises(ValueError, match="saved outputs"):
        tool.compare_outputs({"cur": mine["cur"]}, saved)


def test_tool_without_a_gpu_raises_and_never_uses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


def test_bounds_of_k4a_and_k4b():
    """chip_smoke's bounds at the K4 rows (the bench's B=8 x 3584 atoms,
    41,475,020 valid pairs): K4b's one square root a pair over 132 SMs x 16
    a clock x 1.98 GHz takes longer than its 14 fp32 operations a pair over
    67 TFLOP/s and its products over 495 TFLOP/s; K4a's 24 fp32 operations
    a pair take longer than its one root."""
    import chip_smoke
    pairs = 41_475_020
    n_bytes = 8 * 3584 * 25 + 8 * 12

    def bound_of(name):
        flops, tensor_flops = chip_smoke.VARIANT_FLOPS_PER_PAIR[name]
        return chip_smoke.bound(
            n_bytes, flops * pairs, tensor_flops * pairs,
            special=chip_smoke.SPECIAL_PER_PAIR[name] * pairs)

    ms, by = bound_of("drmsd_fwd_mxu")
    assert by == "special functions"
    assert ms == pytest.approx(1e3 * pairs / (132 * 16 * 1.98e9))
    assert round(ms, 5) == 0.00992
    assert chip_smoke.bound(n_bytes, 14 * pairs)[0] == pytest.approx(
        0.00867, rel=1e-3)
    ms, by = bound_of("drmsd_fwd_sqrt1")
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 24 * pairs / 67e12)
    assert round(ms, 4) == 0.0149


# ------------------------------------------------------ card-only tests

@pytest.mark.needs_cuda
@pytest.mark.parametrize("bsz,n", [(8, 700), (8, 3584), (2, 129), (3, 1)])
def test_kernels_match_plain_on_the_card(cuda, bsz, n):
    rng = np.random.default_rng(5)
    a = rng.normal(0, 30, (bsz, n, 3)).astype(np.float32)
    b = (a + rng.normal(0, 1, (bsz, n, 3))).astype(np.float32)
    m = rng.random((bsz, n)) > 0.2
    m[-1] = False
    a, b, m = tensors(a, b, m, device=cuda)
    exact, _ = D.drmsd_stats_torch(a.double(), b.double(), m)
    for plain, kernel, _ in STATS.values():
        s, c = kernel(a, b, m)
        ps, pc = plain(a, b, m)
        assert torch.equal(c, pc) and int(c[-1]) == 0 and float(s[-1]) == 0.0
        assert ((s.double() - exact).abs() <= 1e-5 * exact.abs()).all()
        assert torch.equal(kernel(a, b, m)[0], s)
    g = V.drmsd_grad_a_mxu_cuda(a, b, m)
    pg = V.drmsd_grad_a_mxu_torch(a, b, m)
    assert not g[-1].any()
    assert float((g - pg).abs().max()) <= 1e-4 * max(1.0,
                                                     float(pg.abs().max()))
    assert torch.equal(V.drmsd_grad_a_mxu_cuda(a, b, m), g)


@pytest.mark.needs_cuda
def test_tool_parity_on_the_card(cuda):
    out = tool.parity(cuda)
    assert out["sqrt1"] < 1e-5 and out["mxu"] < 1e-5


def structured_batch(n, seed):
    """The training step's masks at n atoms, as the K1 card tests take
    them: two proteins with each residue's real slots, 2% missing and a
    padded tail, an all-masked one, then one protein with exactly one valid
    atom and one with exactly two; a, b ~ N(0, 10)."""
    rng = np.random.default_rng(seed)
    a, b = (rng.normal(0, 10, (5, n, 3)).astype(np.float32)
            for _ in range(2))
    m = np.zeros((5, n), bool)
    m[:3] = atom_mask_case(rng, 3, n)
    m[3, rng.integers(n)] = True
    m[4, rng.choice(n, 2, replace=False)] = True
    return a, b, m


def poison_allocator(cuda):
    """Leave NaNs where the caching allocator hands out the next blocks, so
    that an atom the kernel fails to write shows."""
    torch.full((64 << 20,), float("nan"), device=cuda)
    torch.cuda.synchronize()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n", [127, 128, 129, 255, 257, 3584])
def test_grad_kernel_on_structured_masks_on_card(cuda, n):
    """K4c on the training step's masks around the 128-atom tile edge, its
    output NaN-poisoned: within 1e-4 * max(1, max|g|) of its plain version
    and of K1b's dS/da, exact zeros for the all-masked protein and the one
    with a single valid atom, and the same bits on a second (poisoned)
    call."""
    a, b, m = tensors(*structured_batch(n, n + 11), device=cuda)
    poison_allocator(cuda)
    before = V.drmsd_grad_a_mxu_cuda.launches
    g = V.drmsd_grad_a_mxu_cuda(a, b, m)
    torch.cuda.synchronize()
    assert V.drmsd_grad_a_mxu_cuda.launches - before == 1
    pg = V.drmsd_grad_a_mxu_torch(a, b, m)
    kg = D.drmsd_stats_grad_cuda(a, b, m)[2]
    assert torch.isfinite(g).all()
    gate = 1e-4 * max(1.0, float(pg.abs().max()))
    assert float((g - pg).abs().max()) <= gate
    assert float((g - kg).abs().max()) <= gate
    assert not g[2].any() and not g[3].any()
    assert g[4].any()
    poison_allocator(cuda)
    assert torch.equal(V.drmsd_grad_a_mxu_cuda(a, b, m), g)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("n", [127, 128, 129, 255, 257, 3584])
@pytest.mark.parametrize("name", list(STATS))
def test_stats_kernels_on_structured_masks_on_card(cuda, name, n):
    """K4a and K4b on the training step's masks around the 128-atom tile
    edge, their scratch NaN-poisoned: one launch a call, counts equal to the
    plain version's and to K1a's, exact zeros for the all-masked protein and
    the one with a single valid atom, the same bits on a second (poisoned)
    call. Against float64: S within 1e-5 relative where there are many
    pairs, and every dRMSD within 1e-4 A. The protein with two valid atoms
    gets the dRMSD gate alone: its S is one pair's term, which the one-root
    form in fp32 takes as a difference of numbers ~10^3 times larger (at
    n = 257 the plain fp32 version misses 1e-5 relative on it too)."""
    plain, kernel, _ = STATS[name]
    a, b, m = tensors(*structured_batch(n, n + 11), device=cuda)
    poison_allocator(cuda)
    before = kernel.launches
    s, c = kernel(a, b, m)
    torch.cuda.synchronize()
    assert kernel.launches - before == 1
    ps, pc = plain(a, b, m)
    assert torch.equal(c, pc) and torch.equal(c, D.drmsd_stats_cuda(a, b, m)[1])
    assert int(c[2]) == int(c[3]) == 0 and int(c[4]) == 1
    assert float(s[2]) == 0.0 and float(s[3]) == 0.0
    exact = D.drmsd_stats_torch(a.double(), b.double(), m)[0]
    many = c > 1
    assert ((s.double() - exact)[many].abs()
            <= 1e-5 * exact[many].abs()).all() and many[:2].all()
    assert float((drmsd_of(s.double(), c) - drmsd_of(exact, c)).abs().max()
                 ) <= 1e-4
    poison_allocator(cuda)
    assert torch.equal(kernel(a, b, m)[0], s)
