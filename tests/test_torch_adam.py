"""The optimizer's CUDA kernel (K6, ``ops/adam.py``) and the path choice of
``training/optim.py::Optimizer.update``.

On the CPU: the choice of path, the wrapper's refusals (no fallback, no
cast), the host scalars (the signed step with the plateau scale, both bias
corrections), the norm's split into sliced and replicated square sums
against ``Optimizer.global_norm``, and the foreach path's silence on the
kernel's counter. The foreach path against the JAX package is
``tests/test_torch_train.py``.

On a card only (``needs_cuda``): the kernel against the foreach path over
three updates, to 2 ulp or 1e-6 relative on the parameters and both
moments, on a ``conv_enc_512`` parameter dict and on tensors of odd sizes
(one element, three, 4k + 1, none), views at offsets into one flat tensor
and a gradient that is not contiguous, with the clip engaged and not,
decay on and off, Adam and SGD, and sliced gradients summed by a stub
axis, and on more tensors than one launch takes (the foreach path fed the
kernel's float64 norm, ``float64_norm``); the same bits on two runs, and
on a work buffer handed out dirty; the norm pass's sums; its launches; no
stream synchronisation and the counter ``optim.fused_params``; and a
profiled update whose kernels the benchmark's categoriser files as
``optimizer``:

    python -m pytest --noconftest -m needs_cuda tests/test_torch_adam.py
"""
import functools
import math

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch import tracing
from protein_transformer_tpu_torch.ops import adam as A
from protein_transformer_tpu_torch.training import optim as O

CPU = torch.device("cpu")


class Doubling:
    """A stub 'model' axis of two ranks that hold equal slices: the sum
    over the axis doubles a tensor, in place."""

    def __init__(self):
        self.calls = 0

    def all_reduce(self, t):
        self.calls += 1
        return t.mul_(2)


def odd_tensors(seed: int, device, scale: float = 1.0):
    """(params, grads, sliced) of odd sizes and layouts: numel 1, 3,
    4k + 1 and 0, three views at offsets into one flat gradient (as the
    data-parallel sum hands them over), and a gradient that is not
    contiguous."""
    rng = np.random.default_rng(seed)
    shapes = [(1,), (3,), (4 * 1000 + 1,), (0,), (7, 5), (33,), (2, 65),
              (64, 48)]

    def t(shape, s=1.0):
        return torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)
                                ).to(device)

    params = [t(s) for s in shapes]
    grads = [t(s, scale) for s in shapes[:4]]
    flat = t((1 + 35 + 33 + 130,), scale)
    for shape, at in zip(shapes[4:7], (1, 36, 69)):
        n = math.prod(shape)
        grads.append(flat[at:at + n].view(shape))
    grads.append(t((48, 64), scale).t())
    sliced = [i % 3 == 1 for i in range(len(shapes))]
    return params, grads, sliced


def square_sums(grads: list, sliced: list) -> torch.Tensor:
    """The norm pass's result in plain PyTorch: the float64 sums of the
    squares of the gradients that are slices over the 'model' axis and of
    the others, (2,)."""
    out = torch.zeros(2, dtype=torch.float64, device=grads[0].device)
    for g, s in zip(grads, sliced):
        out[0 if s else 1] += g.double().square().sum()
    return out


def conv512_params(device):
    """The parameter dict of ``conv_enc_512`` (28.1 M parameters in 105
    tensors), seeded."""
    from protein_transformer_tpu_torch.config import TrainConfig
    from protein_transformer_tpu_torch.models.factory import make_model
    torch.manual_seed(0)
    cfg = TrainConfig(model="conv-enc|21,11,3|1,1,1", d_model=512,
                      d_ff=2048, n_heads=8, n_layers=6).finalize()
    model = make_model(cfg, [0.0] * 24)
    return {k: v.detach().to(device).clone()
            for k, v in model.named_parameters()}


# ---------------------------------------------------------------------- CPU


def test_resolve_impl_picks_by_device():
    assert A.resolve_impl("auto", CPU) == "torch"
    assert A.resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert A.resolve_impl("cuda", CPU) == "cuda"
    assert A.resolve_impl("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="unknown optimizer impl"):
        A.resolve_impl("fused", CPU)
    with pytest.raises(ValueError, match="unknown optimizer impl"):
        O.Optimizer("adam", 1e-3, True, 1.0, impl="fused")


def test_cuda_impl_on_cpu_tensors_raises_without_fallback():
    params, grads, _ = odd_tensors(0, CPU)
    named = {f"p{i}": p for i, p in enumerate(params)}
    before = [p.clone() for p in params]
    launches = A.adam_update_cuda.launches
    tx = O.Optimizer("adam", 1e-3, True, 1.0, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        tx.update(named, grads, tx.init(named))
    assert A.adam_update_cuda.launches == launches
    assert all(torch.equal(a, b) for a, b in zip(params, before))


@pytest.mark.parametrize("fault", ["float64 param", "float16 grad",
                                   "bfloat16 mu", "grad shape", "nu shape",
                                   "grad device", "mu device", "one moment",
                                   "strided mu", "missing grad"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    p = [torch.zeros(4, 3), torch.zeros(5)]
    g = [torch.ones(4, 3), torch.ones(5)]
    mu = [torch.zeros(4, 3), torch.zeros(5)]
    nu = [torch.zeros(4, 3), torch.zeros(5)]
    meta = torch.device("meta")
    err, args = {
        "float64 param": (TypeError, ([p[0].double(), p[1]], g, mu, nu)),
        "float16 grad": (TypeError, (p, [g[0], g[1].half()], mu, nu)),
        "bfloat16 mu": (TypeError, (p, g, [mu[0].bfloat16(), mu[1]], nu)),
        "grad shape": (ValueError, (p, [g[0].reshape(3, 4), g[1]], mu, nu)),
        "nu shape": (ValueError, (p, g, mu, [nu[0], torch.zeros(6)])),
        "grad device": (ValueError, (p, [g[0], g[1].to(meta)], mu, nu)),
        "mu device": (ValueError, (p, g, [mu[0].to(meta), mu[1]], nu)),
        "one moment": (ValueError, (p, g, mu, None)),
        "strided mu": (ValueError,
                       (p, g, [torch.zeros(3, 4).t(), mu[1]], nu)),
        "missing grad": (ValueError, (p, g[:1], mu, nu)),
    }[fault]
    launches = A.adam_update_cuda.launches
    with pytest.raises(err):
        A.adam_update_cuda(*args, lr=-1e-3, weight_decay=0.0)
    assert A.adam_update_cuda.launches == launches


@pytest.mark.parametrize("count", [0, 1, 10_000])
@pytest.mark.parametrize("lr_scale", [1.0, 0.01])
def test_host_scalars(count, lr_scale):
    """The signed step with the plateau scale and the two bias corrections
    of the update after ``count`` updates (t = count + 1), as optax counts
    them: host floats, the same on both paths."""
    for lr in (O.noam_schedule(512, 100), 3e-4):
        tx = O.Optimizer("adam", lr, True, 1.0)
        step, bc1, bc2 = tx.scalars(count, lr_scale)
        want = lr(count) if callable(lr) else lr
        assert step == -want * lr_scale
        assert bc1 == 1.0 - 0.9 ** (count + 1)
        assert bc2 == 1.0 - 0.98 ** (count + 1)
    first = O.Optimizer("adam", 1.0, True, 1.0).scalars(0)
    assert np.float32(first[1]) == np.float32(0.1)
    assert np.float32(first[2]) == np.float32(0.02)
    assert O.Optimizer("adam", 1.0, True, 1.0).scalars(10_000)[1:] == (
        1.0, 1.0)


@pytest.mark.parametrize("which", ["none", "some", "all"])
def test_square_sums_split_against_global_norm(which):
    """The norm pass's two sums, the sliced one summed over the axis, give
    ``Optimizer.global_norm``'s norm."""
    _, grads, sliced = odd_tensors(1, CPU)
    sliced = {"none": [False] * len(grads), "some": sliced,
              "all": [True] * len(grads)}[which]
    tx = O.Optimizer("adam", 1e-3, True, 1.0)
    tx.shard([], Doubling())
    want = tx.global_norm(grads, sliced)
    sums = square_sums(grads, sliced)
    want_sliced = sum(float((g.double() ** 2).sum())
                      for g, s in zip(grads, sliced) if s)
    assert float(sums[0]) == pytest.approx(want_sliced, rel=1e-12)
    assert float(sums.sum()) == pytest.approx(
        sum(float((g.double() ** 2).sum()) for g in grads), rel=1e-12)
    tx.axis.all_reduce(sums[:1])
    got = torch.sqrt(sums.sum())
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_torch_path_counts_no_fused_parameters(monkeypatch):
    """On the CPU the foreach path runs and the kernel's counter stays
    absent from the session."""
    monkeypatch.setenv(tracing.SWITCH, "1")
    params, grads, _ = odd_tensors(2, CPU)
    named = {f"p{i}": p for i, p in enumerate(params)}
    tx = O.Optimizer("adam", 1e-3, True, 1.0)
    launches = A.adam_update_cuda.launches
    with tracing.epoch("train.epoch"):
        with tracing.span("train.optimizer"):
            state = tx.update(named, [g.contiguous() for g in grads],
                              tx.init(named))
    assert state.count == 1
    assert A.adam_update_cuda.launches == launches
    assert "optim.fused_params" not in tracing.last_session()["counters"]


# ------------------------------------------------------------ card only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def ulp_close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Every entry within 2 ulp of float32 or 1e-6 relative."""
    got = got.detach().cpu().numpy().astype(np.float64)
    want = want.detach().cpu().numpy()
    gap = np.abs(got - want.astype(np.float64))
    ulp = np.spacing(np.abs(want)).astype(np.float64)
    ok = (gap <= 2 * ulp) | (gap <= 1e-6 * np.abs(want))
    assert ok.all(), (what, float(gap.max()), int((~ok).sum()))


def float64_norm(tx, grads, sliced):
    """The global norm as the kernel takes it: the float64 square sums
    (the sliced one summed over the axis), its root rounded to float32.
    ``Optimizer.global_norm`` sums float32 norms, whose rounding moves the
    clip's factor by up to ~1e-6 relative and the moments with it."""
    sums = square_sums(grads, sliced)
    if any(sliced):
        tx.axis.all_reduce(sums[:1])
    return torch.sqrt(sums.sum()).float()


def run(impl, params, grads_seq, optimizer="adam", clip=1.0,
        weight_decay=True, axis=None, sliced=()):
    """Updates of a copy of ``params`` (a dict) on the path ``impl``, one
    a gradient list of ``grads_seq``, handed to the kernel as they are
    (views, layouts) and to the foreach path as copies, which it scales in
    place; the foreach path takes the norm as the kernel does
    (``float64_norm``). Returns (params, state, tx)."""
    named = {k: v.clone() for k, v in params.items()}
    tx = O.Optimizer(optimizer, O.noam_schedule(512, 100), weight_decay,
                     clip, impl=impl)
    if axis is not None:
        tx.shard(sliced, axis)
    if impl == "torch":
        tx.global_norm = functools.partial(float64_norm, tx)
    state = tx.init(named)
    for grads in grads_seq:
        gs = list(grads) if impl == "cuda" else [g.clone() for g in grads]
        state = tx.update(named, gs, state, lr_scale=0.5)
    return named, state, tx


def assert_paths_agree(params, grads_seq, **kw):
    kept = [[g.clone() for g in grads] for grads in grads_seq]
    got, gstate, _ = run("cuda", params, grads_seq, **kw)
    for grads, before in zip(grads_seq, kept):
        assert all(torch.equal(g, b) for g, b in zip(grads, before))
    want, wstate, _ = run("torch", params, grads_seq, **kw)
    assert gstate.count == wstate.count == len(grads_seq)
    for k in params:
        ulp_close(got[k], want[k], f"param {k}")
    for i, (a, b) in enumerate(zip(gstate.mu + gstate.nu,
                                   wstate.mu + wstate.nu)):
        ulp_close(a, b, f"moment {i}")


@pytest.mark.needs_cuda
def test_kernel_matches_foreach_on_conv_enc_512_on_card(cuda):
    params = conv512_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    grads_seq = [[torch.randn(p.shape, device=cuda, generator=gen) * 1e-3
                  for p in params.values()] for _ in range(3)]
    assert_paths_agree(params, grads_seq)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("clip", ["engaged", "idle", "off"])
@pytest.mark.parametrize("weight_decay", [True, False])
@pytest.mark.parametrize("sharded", [False, True])
def test_kernel_matches_foreach_on_odd_tensors_on_card(
        cuda, optimizer, clip, weight_decay, sharded):
    clip_value = {"engaged": 0.5, "idle": 1e6, "off": None}[clip]
    grads_seq = []
    for step in range(3):
        params, grads, sliced = odd_tensors(10 + step, cuda, scale=3.0)
        grads_seq.append(grads)
    params, _, sliced = odd_tensors(3, cuda)
    named = {f"p{i}": p for i, p in enumerate(params)}
    names = [k for k, s in zip(named, sliced) if s] if sharded else []
    copies = A.adam_update_cuda.copies
    assert_paths_agree(named, grads_seq, optimizer=optimizer,
                       clip=clip_value, weight_decay=weight_decay,
                       axis=Doubling() if sharded else None, sliced=names)
    # the transposed gradient, once an update
    assert A.adam_update_cuda.copies == copies + 3


@pytest.mark.needs_cuda
def test_kernel_over_more_tensors_than_a_launch_takes_on_card(cuda):
    """More tensors than one launch's table holds: each pass takes one
    launch a table, the norm still folds every launch's partials."""
    lib = A._lib()
    n = 2 * lib.adam_max_tensors() + 5
    rng = np.random.default_rng(4)
    sizes = rng.integers(0, 40, n)
    params = {f"p{i}": torch.from_numpy(
        rng.normal(0, 1, k).astype(np.float32)).to(cuda)
        for i, k in enumerate(sizes)}
    grads_seq = [[torch.from_numpy(rng.normal(0, 3, k).astype(np.float32)
                                   ).to(cuda) for k in sizes]
                 for _ in range(3)]
    before = A.adam_update_cuda.launches
    assert_paths_agree(params, grads_seq, clip=0.5)
    assert A.adam_update_cuda.launches - before == 3 * 2 * 3


@pytest.mark.needs_cuda
def test_kernel_gives_the_same_bits_twice_and_its_norm_on_card(cuda):
    params = conv512_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    grads_seq = [[torch.randn(p.shape, device=cuda, generator=gen)
                  for p in params.values()] for _ in range(2)]
    first, s1, _ = run("cuda", params, grads_seq)
    second, s2, _ = run("cuda", params, grads_seq)
    for k in params:
        assert torch.equal(first[k], second[k]), k
    for a, b in zip(s1.mu + s1.nu, s2.mu + s2.nu):
        assert torch.equal(a, b)
    grads = grads_seq[0]
    sliced = [i % 2 == 0 for i in range(len(grads))]
    ps = list(params.values())
    mu = [torch.zeros_like(p) for p in ps]
    sums = A.adam_update_cuda(
        [p.clone() for p in ps], grads, mu, [m.clone() for m in mu],
        lr=-1e-3, weight_decay=0.01, clip=1.0, sliced=sliced, axis=Doubling())
    want = square_sums(grads, sliced)
    want[0] *= 2
    torch.testing.assert_close(sums, want, rtol=1e-12, atol=0)
    # the foreach path's float32 norm, within its own rounding
    tx = O.Optimizer("adam", 1e-3, True, 1.0)
    tx.shard([], Doubling())
    torch.testing.assert_close(torch.sqrt(sums.sum()).float(),
                               tx.global_norm(grads, sliced), rtol=1e-5,
                               atol=0)


@pytest.mark.needs_cuda
def test_dirty_work_buffer_changes_nothing_on_card(cuda):
    """The norm pass zeroes its ticket on the stream: an update whose work
    buffer the allocator hands out full of set bits (a stale ticket) gives
    the bits and the norm of a clean one."""
    ps = list(conv512_params(cuda).values())
    gen = torch.Generator(device=cuda).manual_seed(5)
    grads = [torch.randn(p.shape, device=cuda, generator=gen) for p in ps]
    outs = []
    for dirty in (False, True):
        p_, mu, nu = ([p.clone() for p in ps], [torch.zeros_like(p)
                      for p in ps], [torch.zeros_like(p) for p in ps])
        if dirty:  # freed blocks of set bits, where the work buffer lands
            for _ in range(4):
                torch.full((1 << 16,), -1, dtype=torch.int64, device=cuda)
        sums = A.adam_update_cuda(
            p_, grads, mu, nu, lr=-1e-3, weight_decay=0.01, clip=1.0,
            bc1=0.1, bc2=0.02)
        outs.append((p_ + mu + nu, sums.clone()))
    (clean, clean_sums), (got, got_sums) = outs
    assert all(torch.equal(a, b) for a, b in zip(clean, got))
    assert torch.equal(clean_sums, got_sums)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("clip", [1.0, None])
def test_launches_an_update_on_card(cuda, clip):
    params = conv512_params(cuda)
    grads = [torch.ones_like(p) for p in params.values()]
    tx = O.Optimizer("adam", 1e-3, True, clip)
    state = tx.init(params)
    before = A.adam_update_cuda.launches
    tx.update(params, grads, state)
    assert A.adam_update_cuda.launches - before == (2 if clip else 1)


@pytest.mark.needs_cuda
def test_update_never_synchronises_and_counts_its_parameters_on_card(
        cuda, monkeypatch):
    params = conv512_params(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    grads = [torch.randn(p.shape, device=cuda, generator=gen)
             for p in params.values()]
    tx = O.Optimizer("adam", O.noam_schedule(512, 100), True, 1.0)
    state = tx.update(params, grads, tx.init(params))  # builds, loads
    torch.cuda.synchronize()
    monkeypatch.setenv(tracing.SWITCH, "1")
    with tracing.epoch("train.epoch"):  # its end copies the counters
        torch.cuda.set_sync_debug_mode("error")
        try:
            for step in range(2):
                with tracing.span("train.optimizer", step):
                    state = tx.update(params, grads, state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counted = tracing.last_session()["counters"]["optim.fused_params"]
    n = sum(p.numel() for p in params.values())
    assert counted["steps"] == [0, 1]
    assert counted["values"] == [[float(n)], [float(n)]]


@pytest.mark.needs_cuda
def test_profiled_update_lands_in_the_optimizer_category_on_card(
        cuda, tmp_path):
    """The benchmark's frozen categoriser files a device event as
    ``optimizer`` by a launch from ``training/optim.py``: both kernels'
    launches are made there, on the calling thread."""
    from benchmark.frozen import trace as T
    params = conv512_params(cuda)
    grads = [torch.ones_like(p) for p in params.values()]
    tx = O.Optimizer("adam", 1e-3, True, 1.0)
    state = tx.update(params, grads, tx.init(params))
    prof, _ = T.traced(lambda: tx.update(params, grads, state), True,
                       with_stack=True)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = T.load_events(str(tmp_path / "trace.json"))
    devs = T.device_events(events)
    launches = T.Launches(events)
    kernels = [e for e in devs if "adam" in e["name"]]
    assert len(kernels) == 2, [e["name"] for e in devs]
    cats = {T.category_of(e["name"], launches.stack_of(e)) for e in devs}
    assert cats == {"optimizer"}, cats
