"""Flash self-attention of the PyTorch port against the JAX package's.

On the CPU the port runs its plain version. The JAX wrapper
(``protein_transformer_tpu.ops.attention.flash_self_attention``) is run as
``tests/test_attention.py`` runs it off the TPU: its kernel call replaced,
inside the test, by JAX's own exact reference (the function
``mha_reference`` evaluates, taken without that one's custom VJP, which
refuses a softmax scale other than 1, so that ``jax.grad`` goes through it).
Inputs come from a numpy seed and go through both.

Tolerances: forward 2e-5 on valid rows (fp32 sums taken in another order),
gradients 1e-4 * max(1, max|g|). Pad query rows are compared only between
the port's own paths: the JAX flash path gives them another definition.

The kernels themselves run only on a card:

    python -m pytest --noconftest -m needs_cuda tests/test_torch_attention.py

JAX is imported inside the tests, so that the card-only tests also collect
where JAX is not installed.
"""
import math

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.models import conv_encoder as tconv
from protein_transformer_tpu_torch.models import encoder_only as tenc
from protein_transformer_tpu_torch.models import transformer as ttr
from protein_transformer_tpu_torch.models.factory import (
    make_model, resolve_attention_impl)
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.ops import attention as A

B, H, D = 2, 2, 16
ATOL = 2e-5
PAD_ID = 20


def qkv(length, seed=7, bsz=B, heads=H, dim=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bsz, heads, length, dim)).astype(np.float32)
            for _ in range(3)]


def ragged_valid(length, n_valid):
    return np.arange(length)[None, :] < np.asarray(n_valid)[:, None]


def grad_close(got, want, what):
    err = float(np.abs(got - want).max())
    bound = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def port_out_and_grads(q, k, v, valid, rows, impl="auto"):
    """O and the gradients of sum(sin(O)) over the rows ``rows`` (B, L)."""
    leaves = [torch.from_numpy(x).clone().requires_grad_() for x in (q, k, v)]
    out = A.flash_self_attention(*leaves, torch.from_numpy(valid),
                                 sm_scale=1.0 / math.sqrt(q.shape[-1]),
                                 impl=impl)
    w = torch.from_numpy(rows)[:, None, :, None].to(out.dtype)
    grads = torch.autograd.grad((torch.sin(out) * w).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX wrapper with the TPU kernel replaced by JAX's exact
    reference, as tests/test_attention.py does; returns (module, jnp)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        mha_reference_no_custom_vjp)

    from protein_transformer_tpu.ops import attention as JA

    def shim(q, k, v, segment_ids=None, *, sm_scale, block_sizes):
        del block_sizes
        return mha_reference_no_custom_vjp(q, k, v, None, segment_ids,
                                           causal=False, sm_scale=sm_scale)

    monkeypatch.setattr(JA, "flash_attention", shim)
    monkeypatch.setattr(JA, "flash_available", lambda: True)
    return JA, jnp


@pytest.mark.parametrize("length", [24, 128, 200])
def test_flash_matches_jax_wrapper_on_valid_rows(jax_flash, length):
    import jax
    JA, jnp = jax_flash
    q, k, v = qkv(length)
    n_valid = [length, max(length - 9, 1)]
    valid = ragged_valid(length, n_valid)
    scale = 1.0 / math.sqrt(D)

    def loss(q, k, v):
        out = JA.flash_self_attention(q, k, v, jnp.asarray(valid),
                                      sm_scale=scale)
        return jnp.sum(jnp.sin(out) * valid[:, None, :, None]), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, (q, k, v)))
    got, got_grads = port_out_and_grads(q, k, v, valid, valid)
    assert got.shape == (B, H, length, D)
    for i, n in enumerate(n_valid):
        np.testing.assert_allclose(got[i, :, :n], np.asarray(want)[i, :, :n],
                                   atol=ATOL, rtol=ATOL)
    for name, g, w in zip("qkv", got_grads, want_grads):
        grad_close(g, np.asarray(w), f"d/d{name} at L={length}")


def materialised(q, k, v, valid):
    """The port's materialised branch, as MultiHeadedAttention writes it."""
    scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~valid[:, None, None, :],
                                torch.finfo(torch.float32).min)
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def test_plain_flash_equals_materialised_branch_on_every_row():
    length = 40
    q, k, v = (torch.from_numpy(x) for x in qkv(length, seed=3, bsz=3))
    valid = torch.from_numpy(ragged_valid(length, [length, 17, 0]))
    got = A.flash_self_attention(q, k, v, valid, sm_scale=1 / math.sqrt(D))
    want = materialised(q, k, v, valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=ATOL)


def test_all_pad_batch_row_and_pad_query_rows_are_finite():
    """A batch row with no valid key gets uniform weights: finite outputs,
    zero gradients for its q and k, the mean of dO for its v."""
    length = 24
    q, k, v = qkv(length, seed=5, bsz=3)
    valid = ragged_valid(length, [length, 10, 0])
    every_row = np.ones_like(valid)
    out, grads = port_out_and_grads(q, k, v, valid, every_row)
    assert np.isfinite(out).all()
    assert all(np.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(
        out[2], np.broadcast_to(v[2].mean(axis=1, keepdims=True), v[2].shape),
        atol=ATOL)
    assert not grads[0][2].any() and not grads[1][2].any()
    assert np.abs(grads[2][2]).max() > 0
    # masked keys of a row with valid keys get no weight and no gradient
    assert not grads[1][1, :, 10:].any() and not grads[2][1, :, 10:].any()
    # a zero cotangent gives zero gradients, not NaN
    _, zero = port_out_and_grads(q, k, v, valid, np.zeros_like(valid))
    assert all(not g.any() for g in zero)


def reference_fwd(q, k, v, valid, sm_scale, with_stats=False):
    """What K3a computes, in plain tensor operations: O and the row
    statistics m (maximum) and l (sum of exp(s - m))."""
    scores = torch.matmul(q, k.transpose(-2, -1)) * sm_scale
    scores = scores.masked_fill(~valid[:, None, None, :],
                                torch.finfo(torch.float32).min)
    m = scores.max(dim=-1).values
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    out = torch.matmul(p, v) / l[..., None]
    return (out, m, l) if with_stats else (out, None, None)


def reference_bwd(q, k, v, valid, d_out, m, l, delta, sm_scale):
    """What K3b and K3c compute from the saved statistics: probabilities
    recomputed as exp(s - m) / l, dS zero on masked keys."""
    scores = torch.matmul(q, k.transpose(-2, -1)) * sm_scale
    key = valid[:, None, None, :]
    scores = scores.masked_fill(~key, torch.finfo(torch.float32).min)
    p = torch.exp(scores - m[..., None]) / l[..., None]
    dp = torch.matmul(d_out, v.transpose(-2, -1))
    ds = torch.where(key, p * (dp - delta[..., None]), 0.0)
    return (torch.matmul(ds, k) * sm_scale,
            torch.matmul(ds.transpose(-2, -1), q) * sm_scale,
            torch.matmul(p.transpose(-2, -1), d_out))


@pytest.fixture
def plain_launchers(monkeypatch):
    """The kernel wrappers replaced by the same arithmetic in tensor
    operations, with the device check left out: the autograd wiring around
    the kernels, and the backward formulas the kernels implement, can then
    be followed on the CPU. Returns the call counts."""
    calls = {"fwd": 0, "fwd_stats": 0, "delta": 0, "dkv": 0, "dq": 0}

    def fwd(q, k, v, valid, sm_scale, with_stats=False):
        calls["fwd_stats" if with_stats else "fwd"] += 1
        assert valid.dtype == torch.bool and valid.is_contiguous()
        return reference_fwd(q, k, v, valid, sm_scale, with_stats)

    def delta(out, d_out):
        calls["delta"] += 1
        return (out * d_out).sum(-1)

    def dkv(q, k, v, valid, d_out, m, l, delta, sm_scale):
        calls["dkv"] += 1
        return reference_bwd(q, k, v, valid, d_out, m, l, delta, sm_scale)[1:]

    def dq(q, k, v, valid, d_out, m, l, delta, sm_scale):
        calls["dq"] += 1
        return reference_bwd(q, k, v, valid, d_out, m, l, delta, sm_scale)[0]

    monkeypatch.setattr(A, "flash_attn_fwd_cuda", fwd)
    monkeypatch.setattr(A, "attention_delta_cuda", delta)
    monkeypatch.setattr(A, "flash_attn_bwd_dkv_cuda", dkv)
    monkeypatch.setattr(A, "flash_attn_bwd_dq_cuda", dq)
    return calls


def test_function_wiring_and_backward_formulas(plain_launchers):
    """Through ``FlashSelfAttention`` (impl "cuda", launchers replaced): the
    saved statistics, the delta pre-pass and the two backward passes give
    autograd's gradients of the plain version, all-pad row included."""
    length = 37
    q, k, v = qkv(length, seed=9, bsz=3)
    valid = ragged_valid(length, [length, 20, 0])
    every_row = np.ones_like(valid)
    got, got_grads = port_out_and_grads(q, k, v, valid, every_row, "cuda")
    assert plain_launchers == {"fwd": 0, "fwd_stats": 1, "delta": 1,
                               "dkv": 1, "dq": 1}
    want, want_grads = port_out_and_grads(q, k, v, valid, every_row, "torch")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    for name, g, w in zip("qkv", got_grads, want_grads):
        assert np.isfinite(g).all()
        grad_close(g, w, f"d/d{name}")


def test_only_the_wanted_gradients_are_computed(plain_launchers):
    q, k, v = (torch.from_numpy(x) for x in qkv(12))
    valid = torch.ones((B, 12), dtype=torch.bool)
    q.requires_grad_()
    out = A.flash_self_attention(q, k, v, valid, sm_scale=0.25, impl="cuda")
    out.sum().backward()
    assert (plain_launchers["dq"], plain_launchers["dkv"]) == (1, 0)
    assert q.grad is not None


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_leaf"])
def test_nothing_is_saved_without_a_gradient(plain_launchers, mode):
    """The decision is made outside the Function: a no-grad call on tensors
    that require grad runs the forward alone, without the statistics."""
    q, k, v = (torch.from_numpy(x) for x in qkv(12))
    valid = torch.ones((B, 12), dtype=torch.bool)
    if mode != "no_leaf":
        q.requires_grad_()
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_leaf": torch.enable_grad}[mode]
    with ctx():
        out = A.flash_self_attention(q, k, v, valid, sm_scale=0.25,
                                     impl="cuda")
    assert out.grad_fn is None
    assert plain_launchers == {"fwd": 1, "fwd_stats": 0, "delta": 0,
                               "dkv": 0, "dq": 0}


def test_wrappers_refuse_cpu_tensors_and_unknown_impls():
    q, k, v = (torch.from_numpy(x) for x in qkv(8))
    valid = torch.ones((B, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA device"):
        A.flash_attn_fwd_cuda(q, k, v, valid, 0.25)
    with pytest.raises(ValueError, match="CUDA device"):
        A.flash_self_attention(q, k, v, valid, sm_scale=0.25, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        A.flash_self_attention(q, k, v, valid, sm_scale=0.25, impl="flash")
    assert A.resolve_impl("auto", torch.device("cpu")) == "torch"
    assert A.resolve_impl("auto", torch.device("cuda", 0)) == "cuda"
    assert not hasattr(A, "flash_available")
    assert A.flash_attn_fwd_cuda.launches == 0


def test_head_layout_makes_the_merge_a_view():
    out = A._head_layout((2, 4, 6, 16), torch.zeros(1))
    assert out.shape == (2, 4, 6, 16) and not out.is_contiguous()
    merged = out.transpose(1, 2).reshape(2, 6, 64)
    assert merged.data_ptr() == out.data_ptr()
    x = torch.zeros(2, 6, 64).reshape(2, 6, 4, 16).transpose(1, 2)
    assert A._rows_in_place(x) is x
    assert A._rows_in_place(x.transpose(-1, -2)).is_contiguous()


def tiny_model(attn_impl, dropout=0.1, n_layers=2):
    am = np.clip(np.random.default_rng(0).normal(0, 0.3, 24), -0.9, 0.9)
    return tenc.EncoderOnlyTransformer(
        n_layers=n_layers, n_heads=2, d_model=16, d_ff=32, max_len=24,
        vocab_size=22, angle_means=am, dropout=dropout, attn_impl=attn_impl)


def test_flash_dispatch_predicate(monkeypatch):
    """The flash path is taken exactly when no dropout hits the
    probabilities: eval mode yes, training with dropout > 0 no, training at
    dropout 0 yes; one call per encoder layer."""
    calls = []
    plain = A.flash_self_attention_torch

    def counting(q, k, v, valid, *, sm_scale):
        calls.append(tuple(q.shape))
        return plain(q, k, v, valid, sm_scale=sm_scale)

    monkeypatch.setattr(A, "flash_self_attention_torch", counting)
    ids = torch.from_numpy(np.random.default_rng(13).integers(0, 20, (2, 24)))
    model = tiny_model("flash")
    ttr.set_dropout_generator(model, torch.Generator().manual_seed(0))

    model.eval()(ids)
    assert calls == [(2, 2, 24, 8)] * 2
    calls.clear()
    model.train()(ids)
    assert calls == []
    model0 = tiny_model("flash", dropout=0.0, n_layers=1)
    model0.train()(ids)
    assert len(calls) == 1
    calls.clear()
    tiny_model("xla").eval()(ids)
    assert calls == []
    # a mask that is not a key-padding mask, or cross-attention, keeps the
    # materialised branch
    attn = ttr.MultiHeadedAttention(16, 2, impl="flash").eval()
    x, y = torch.randn(2, 5, 16), torch.randn(2, 5, 16)
    key_mask = torch.ones(2, 1, 1, 5, dtype=torch.bool)
    attn(x, x, x, torch.ones(2, 1, 5, 5, dtype=torch.bool))
    attn(x, y, y, key_mask)
    attn(x, x, x, None)
    assert calls == []
    attn(x, x, x, key_mask)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="unknown attention impl"):
        ttr.MultiHeadedAttention(16, 2, impl="auto")


def test_resolve_attention_impl_and_factory():
    assert resolve_attention_impl("auto") == "xla"
    assert resolve_attention_impl("flash") == "flash"
    assert resolve_attention_impl("xla") == "xla"
    am = np.zeros(24, np.float32)
    kw = dict(d_model=16, d_ff=32, n_heads=2, n_layers=1, max_seq_len=24)
    for model_name in ("enc-only", "conv-enc|5,3|2,2"):
        for impl, want in (("auto", "xla"), ("flash", "flash")):
            cfg = TrainConfig(model=model_name, attention_impl=impl,
                              **kw).finalize()
            model = make_model(cfg, am)
            attns = [m for m in model.modules()
                     if isinstance(m, ttr.MultiHeadedAttention)]
            assert attns and all(a.impl == want for a in attns)
    cfg = TrainConfig(attention_impl="flash")
    assert TrainConfig.from_dict(
        {**cfg.to_dict(), "prng_impl": "auto"}).attention_impl == "flash"


def model_pair(name, attn_impl):
    from protein_transformer_tpu.models import conv_encoder as jconv
    from protein_transformer_tpu.models import encoder_only as jenc
    am = np.random.default_rng(1).uniform(-0.5, 0.5, 24).astype(np.float32)
    common = dict(n_layers=2, n_heads=2, d_model=32, d_ff=64, max_len=24,
                  vocab_size=22, angle_means=am, dropout=0.1, pad_id=PAD_ID,
                  attn_impl=attn_impl, use_tanh_out=True)
    if name == "enc-only":
        return (jenc.EncoderOnlyTransformer(**common),
                tenc.EncoderOnlyTransformer(**common))
    conv = dict(conv_kernel_sizes=(5, 3), conv_dim_reductions=(2.0, 2.0),
                use_embedding=True)
    return (jconv.ConvEncoderOnlyTransformer(**common, **conv),
            tconv.ConvEncoderOnlyTransformer(**common, **conv))


@pytest.mark.parametrize("name", ["enc-only", "conv-enc"])
def test_flash_model_matches_jax_flash_model(jax_flash, name):
    """Both packages with attn_impl="flash" (JAX through the shim, with its
    availability check patched to True), the same weights through the flax
    bridge: valid rows within 2e-5; and the port's flash model within 2e-5
    of its own materialised one."""
    import jax
    from protein_transformer_tpu.ops import attention as JA
    from protein_transformer_tpu_torch.models.flax_import import (
        load_flax_params)
    _, jnp = jax_flash
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 20, (3, 24)).astype(np.int32)
    n_valid = [24, 17, 9]
    for i, n in enumerate(n_valid):
        ids[i, n:] = PAD_ID
    fmodel, tmodel = model_pair(name, "flash")
    params = jax.tree_util.tree_map(
        np.asarray, fmodel.init(jax.random.PRNGKey(4), jnp.asarray(ids)))
    head = params["params"]["AngleProjection_0"]["output_projection"]
    head["kernel"] = rng.normal(0, 0.3, head["kernel"].shape).astype(
        np.float32)
    kernel_calls = []
    shim = JA.flash_attention

    def counting(*args, **kw):
        kernel_calls.append(1)
        return shim(*args, **kw)

    JA.flash_attention = counting  # the fixture's monkeypatch restores it
    want = np.asarray(fmodel.apply(params, jnp.asarray(ids),
                                   deterministic=True))
    assert len(kernel_calls) == 2  # the JAX model took its flash path
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(ids)).numpy()
    for i, n in enumerate(n_valid):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=ATOL,
                                   rtol=1e-4)
    _, xla_model = model_pair(name, "xla")
    load_flax_params(xla_model, params)
    with torch.no_grad():
        xla = xla_model.eval()(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=1e-4)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_case(shape, seed, cuda):
    bsz, heads, length, dim = shape
    rng = np.random.default_rng(seed)
    # the model's head split: (B, H, L, D) views of (B, L, H * D) memory
    q, k, v = (torch.from_numpy(rng.normal(size=(bsz, length, heads * dim))
                                .astype(np.float32)).to(cuda)
               .reshape(bsz, length, heads, dim).transpose(1, 2)
               for _ in range(3))
    n_valid = rng.integers(1, length + 1, bsz)
    n_valid[0] = length
    if bsz > 1:
        n_valid[-1] = 0  # a batch row with no valid key
    valid = torch.from_numpy(ragged_valid(length, n_valid)).to(cuda)
    return q, k, v, valid


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", [(8, 8, 256, 64), (3, 2, 37, 16),
                                   (2, 3, 130, 32), (2, 2, 70, 128),
                                   (1, 1, 1, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_plain_on_card(cuda, shape):
    """K3a, K3b and K3c against the plain version and autograd through it,
    on every row, the all-pad batch row included."""
    q, k, v, valid = card_case(shape, seed=sum(shape), cuda=cuda)
    scale = 1.0 / math.sqrt(shape[-1])
    d_out = torch.randn(shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
    before = (A.flash_attn_fwd_cuda.launches,
              A.flash_attn_bwd_dkv_cuda.launches,
              A.flash_attn_bwd_dq_cuda.launches)
    results = {}
    for impl in ("cuda", "torch"):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = A.flash_self_attention(*leaves, valid, sm_scale=scale,
                                     impl=impl)
        grads = torch.autograd.grad(out, leaves, d_out)
        results[impl] = (out.detach(), grads)
    torch.cuda.synchronize()
    after = (A.flash_attn_fwd_cuda.launches,
             A.flash_attn_bwd_dkv_cuda.launches,
             A.flash_attn_bwd_dq_cuda.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    (got, got_grads), (want, want_grads) = results["cuda"], results["torch"]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL, rtol=ATOL)
    for name, g, w in zip("qkv", got_grads, want_grads):
        assert torch.isfinite(g).all()
        grad_close(g.cpu().numpy(), w.cpu().numpy(), f"d/d{name} at {shape}")
    with torch.no_grad():
        again = A.flash_self_attention(q, k, v, valid, sm_scale=scale)
    assert torch.equal(again, got)  # the same bits, with or without stats


@pytest.mark.needs_cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v, valid = card_case((2, 2, 8, 16), 0, cuda)
    with pytest.raises(ValueError, match="D in"):
        A.flash_attn_fwd_cuda(q[..., :8], k[..., :8], v[..., :8], valid, 1.0)
    with pytest.raises(TypeError, match="float32"):
        A.flash_attn_fwd_cuda(q.double(), k.double(), v.double(), valid, 1.0)
    with pytest.raises(ValueError, match="bool mask"):
        A.flash_attn_fwd_cuda(q, k, v, valid[:, :4], 1.0)
    # a layout the kernel cannot address in place is copied, not refused
    t = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    out, _, _ = A.flash_attn_fwd_cuda(t, k, v, valid, 0.25)
    want = A.flash_self_attention_torch(q, k, v, valid, sm_scale=0.25)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL, rtol=ATOL)
