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


@pytest.fixture
def plain_launchers(monkeypatch):
    """The kernel wrappers replaced by the same arithmetic in tensor
    operations (``flash_attn_bwd_torch`` for the backward), with the device
    check left out: the autograd wiring around the kernels, and the
    backward formulas the kernel implements, can then be followed on the
    CPU. Returns the calls: counts of the forward, and (want_dq, want_dkv)
    of each backward."""
    calls = {"fwd": 0, "fwd_stats": 0, "bwd": []}

    def fwd(q, k, v, valid, sm_scale, with_stats=False):
        calls["fwd_stats" if with_stats else "fwd"] += 1
        assert valid.dtype == torch.bool and valid.is_contiguous()
        return reference_fwd(q, k, v, valid, sm_scale, with_stats)

    def bwd(q, k, v, valid, d_out, out, m, l, sm_scale, *, want_dq,
            want_dkv):
        calls["bwd"].append((want_dq, want_dkv))
        assert want_dq or want_dkv
        d_q, d_k, d_v = A.flash_attn_bwd_torch(q, k, v, valid, d_out, out, m,
                                               l, sm_scale)
        return (d_q if want_dq else None, d_k if want_dkv else None,
                d_v if want_dkv else None)

    monkeypatch.setattr(A, "flash_attn_fwd_cuda", fwd)
    monkeypatch.setattr(A, "flash_attn_bwd_cuda", bwd)
    return calls


def test_function_wiring_and_backward_formulas(plain_launchers):
    """Through ``FlashSelfAttention`` (impl "cuda", launchers replaced): the
    saved statistics and the one backward call give autograd's gradients of
    the plain version, all-pad row included."""
    length = 37
    q, k, v = qkv(length, seed=9, bsz=3)
    valid = ragged_valid(length, [length, 20, 0])
    every_row = np.ones_like(valid)
    got, got_grads = port_out_and_grads(q, k, v, valid, every_row, "cuda")
    assert plain_launchers == {"fwd": 0, "fwd_stats": 1,
                               "bwd": [(True, True)]}
    want, want_grads = port_out_and_grads(q, k, v, valid, every_row, "torch")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    for name, g, w in zip("qkv", got_grads, want_grads):
        assert np.isfinite(g).all()
        grad_close(g, w, f"d/d{name}")


@pytest.mark.parametrize("wanted", ["q", "kv", "qkv"])
def test_only_the_wanted_gradients_are_computed(plain_launchers, wanted):
    """One backward call, asking for dQ only when q needs it and for dK and
    dV only when k or v does."""
    tensors = dict(zip("qkv", (torch.from_numpy(x) for x in qkv(12))))
    valid = torch.ones((B, 12), dtype=torch.bool)
    for name in wanted:
        tensors[name].requires_grad_()
    out = A.flash_self_attention(*tensors.values(), valid, sm_scale=0.25,
                                 impl="cuda")
    out.sum().backward()
    assert plain_launchers["bwd"] == [("q" in wanted, "k" in wanted)]
    for name, t in tensors.items():
        assert (t.grad is not None) == (name in wanted)


def test_plain_backward_equals_autograd_through_plain():
    """``flash_attn_bwd_torch`` from the forward's row statistics gives
    autograd's gradients through ``flash_self_attention_torch``, the all-pad
    row included."""
    length = 37
    q, k, v = (torch.from_numpy(x) for x in qkv(length, seed=4, bsz=3))
    valid = torch.from_numpy(ragged_valid(length, [length, 20, 0]))
    scale = 1.0 / math.sqrt(D)
    d_out = torch.from_numpy(np.random.default_rng(8).normal(
        size=q.shape).astype(np.float32))
    out, m, l = reference_fwd(q, k, v, valid, scale, with_stats=True)
    got = A.flash_attn_bwd_torch(q, k, v, valid, d_out, out, m, l, scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        A.flash_self_attention_torch(*leaves, valid, sm_scale=scale),
        leaves, d_out)
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g).all()
        grad_close(g.numpy(), w.numpy(), f"d/d{name}")
    assert not got[0][2].any() and not got[1][2].any()


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` in numpy: x rounded to 10 explicit mantissa
    bits, ties away from zero (the sign bit stands apart, so adding half an
    ulp of TF32 to the bits rounds the magnitude)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def mma_sums(terms, depth):
    """Products summed as mma.sync m16n8k8 sums them: every 8-deep product
    of TF32 values exact, added to an fp32 accumulator, the terms of each
    k-step in the order given."""
    acc = np.zeros((terms[0][0].shape[0], terms[0][1].shape[0]), np.float32)
    for k0 in range(0, depth, 8):
        for a, b in terms:
            part = (a[:, k0:k0 + 8].astype(np.float64)
                    @ b[:, k0:k0 + 8].T.astype(np.float64))
            acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def test_split_tf32_products_hold_fp32_accuracy():
    """Why the backward splits its operands: on the scores of phase 8 of
    chip_smoke.py (64-deep, q of standard deviation 3, k of 1), three TF32
    products (rest x head, head x rest, head x head) land within 1e-6 of the
    largest score from float64, where one TF32 product misses by more than
    1e-4 (~3e-4)."""
    assert tf32_rna(np.float32(1 + 2 ** -11)) == np.float32(1 + 2 ** -10)
    assert tf32_rna(np.float32(-(1 + 2 ** -11))) == np.float32(-(1 + 2 ** -10))
    assert tf32_rna(np.float32(1 + 2 ** -12)) == np.float32(1.0)
    rng = np.random.default_rng(0)
    q = rng.normal(0, 3, (64, 64)).astype(np.float32)
    k = rng.normal(0, 1, (64, 64)).astype(np.float32)
    exact = q.astype(np.float64) @ k.T.astype(np.float64)
    heads = [tf32_rna(x) for x in (q, k)]
    rests = [tf32_rna(x - h) for x, h in zip((q, k), heads)]
    three = mma_sums([(rests[0], heads[1]), (heads[0], rests[1]),
                      (heads[0], heads[1])], 64)
    one = mma_sums([(heads[0], heads[1])], 64)
    top = np.abs(exact).max()
    assert np.abs(three - exact).max() <= 1e-6 * top
    assert np.abs(one - exact).max() >= 1e-4 * top


def test_bound_of_k3a_is_bytes():
    """chip_smoke's bound of K3a since its products moved to the tensor
    cores: q, k, v and O (and m and l where they are written) and the mask
    over 3.35 TB/s take longer than the two 2 D-deep products a pair over
    495 TFLOP/s TF32 and one exp a pair, at (8, 8, 256, 64) (16.78 MB, 5.0
    us) and at (16, 8, 256, 64) with m and l (33.8 MB, 10.1 us), whatever
    the share of valid keys; with the products counted as fp32 FMAs on the
    CUDA cores (4 D operations a pair over 67 TFLOP/s) the ragged rows of
    phase 8 at (8, 8, 256, 64), 3,063,808 weighted pairs, would be bound at
    11.7 us."""
    import chip_smoke
    full = 8 * 8 * 256 * 256
    n_bytes = 4 * 4 * 8 * 8 * 256 * 64 + 8 * 256
    ms, by = chip_smoke.attention_bound("flash_attn_fwd", (8, 8, 256, 64),
                                        full)
    assert by == "bytes" and n_bytes == 16_779_264
    assert ms == pytest.approx(1e3 * n_bytes / 3.35e12)
    assert round(ms, 4) == 0.0050
    tensor_ms = 1e3 * 4 * 64 * full / 495e12
    assert tensor_ms == pytest.approx(0.00217, rel=1e-2) and tensor_ms < ms
    ms16, by16 = chip_smoke.attention_bound(
        "flash_attn_fwd", (16, 8, 256, 64), 2 * full, with_stats=True)
    n_bytes16 = 4 * 4 * 16 * 8 * 256 * 64 + 2 * 4 * 16 * 8 * 256 + 16 * 256
    assert by16 == "bytes" and n_bytes16 == 33_820_672
    assert ms16 == pytest.approx(1e3 * n_bytes16 / 3.35e12)
    assert round(ms16, 4) == 0.0101
    assert chip_smoke.attention_bound("flash_attn_fwd", (16, 8, 256, 64),
                                      2 * full)[0] < ms16
    old_ms, old_by = chip_smoke.bound(n_bytes, 4 * 64 * 3_063_808)
    assert old_by == "operations" and round(old_ms, 5) == 0.01171


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
    assert plain_launchers == {"fwd": 1, "fwd_stats": 0, "bwd": []}


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


def test_bench_tool_inputs_and_refusal_without_a_card(monkeypatch):
    """``tools/bench_attention.py`` draws phase 8's kind of inputs (head-split
    views, the first batch row full, the last with no valid key) and
    refuses to time anything without a CUDA device."""
    from protein_transformer_tpu_torch.tools import bench_attention
    q, k, v, d_out, valid = bench_attention.attention_inputs(
        torch.device("cpu"), (3, 2, 40, 16), seed=1)
    assert all(t.shape == (3, 2, 40, 16) and not t.is_contiguous()
               and A._rows_in_place(t) is t for t in (q, k, v, d_out))
    n_valid = valid.sum(1).tolist()
    assert n_valid[0] == 40 and n_valid[-1] == 0
    assert torch.equal(valid, torch.arange(40)[None, :]
                       < valid.sum(1, keepdim=True))  # valid prefixes
    assert 2.0 < float(q.std() / k.std()) < 4.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_attention.main([])


def test_mma_probe_tool_refuses_without_a_card(monkeypatch):
    """The probe of the tensor-core product (``tools/bench_mma.py``) times
    a CUDA kernel and raises where there is no card, without building."""
    from protein_transformer_tpu_torch.tools import bench_mma
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_mma, "_lib", lambda: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_mma.main([])
    assert bench_mma.FLOPS_PER_MMA == 2 * 16 * 8 * 8


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


@pytest.mark.parametrize("impl", ["Flash", "pallas"])
def test_factory_refuses_an_unknown_attention_setting(impl):
    """A setting that is neither xla nor flash (nor auto) is refused when the
    model is built, never run as the materialised branch without a word."""
    cfg = TrainConfig(model="conv-enc|5,3|2,2", d_model=16, d_ff=32,
                      n_heads=2, n_layers=1, max_seq_len=24,
                      attention_impl=impl).finalize()
    with pytest.raises(ValueError, match="unknown attention impl"):
        make_model(cfg, np.zeros(24, np.float32))


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
    """K3a and the backward against the plain version and autograd through
    it, on every row, the all-pad batch row included: one launch each."""
    q, k, v, valid = card_case(shape, seed=sum(shape), cuda=cuda)
    scale = 1.0 / math.sqrt(shape[-1])
    d_out = torch.randn(shape, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
    before = (A.flash_attn_fwd_cuda.launches, A.flash_attn_bwd_cuda.launches)
    results = {}
    for impl in ("cuda", "torch"):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = A.flash_self_attention(*leaves, valid, sm_scale=scale,
                                     impl=impl)
        grads = torch.autograd.grad(out, leaves, d_out)
        results[impl] = (out.detach(), grads)
    torch.cuda.synchronize()
    after = (A.flash_attn_fwd_cuda.launches, A.flash_attn_bwd_cuda.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1)
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


def backward_case(shape, n_valid, cuda, seed=0):
    """q, k, v (head-split views; q three times wider, as phase 8 of
    chip_smoke.py draws them), the mask of ``n_valid`` keys per batch row,
    dO, and the forward's O, m and l from K3a."""
    bsz, heads, length, dim = shape
    rng = np.random.default_rng(seed)
    q, k, v, d_out = (
        torch.from_numpy(rng.normal(0, gain, (bsz, length, heads * dim))
                         .astype(np.float32)).to(cuda)
        .reshape(bsz, length, heads, dim).transpose(1, 2)
        for gain in (3.0, 1.0, 1.0, 1.0))
    valid = torch.from_numpy(ragged_valid(length, n_valid)).to(cuda)
    scale = 1.0 / math.sqrt(dim)
    out, m, l = A.flash_attn_fwd_cuda(q, k, v, valid, scale, with_stats=True)
    return (q, k, v, valid, d_out, out, m, l), scale


def poison_allocator(cuda):
    """Leave NaNs where the caching allocator hands out the next blocks, so
    that an output row the kernel fails to write shows."""
    torch.full((64 << 20,), float("nan"), device=cuda)
    torch.cuda.synchronize()


def hold_backward(got, want, what):
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g).all(), f"d/d{name} finite, {what}"
        grad_close(g.cpu().numpy(), w.cpu().numpy(), f"d/d{name}, {what}")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", [(8, 8, 256, 64), (16, 8, 256, 64),
                                   (8, 8, 500, 64), (3, 2, 37, 16),
                                   (1, 1, 1, 16), (2, 3, 130, 32),
                                   (2, 2, 70, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_kernel_matches_plain_on_card(cuda, shape):
    """The backward kernel against ``flash_attn_bwd_torch`` on the same
    inputs (ragged lengths, one batch row with no valid key), one launch;
    the same bits on a second call."""
    bsz, _, length, _ = shape
    n_valid = np.random.default_rng(sum(shape)).integers(1, length + 1, bsz)
    n_valid[0] = length
    if bsz > 1:
        n_valid[-1] = 0
    args, scale = backward_case(shape, n_valid, cuda)
    poison_allocator(cuda)
    before = A.flash_attn_bwd_cuda.launches
    got = A.flash_attn_bwd_cuda(*args, scale)
    torch.cuda.synchronize()
    assert A.flash_attn_bwd_cuda.launches - before == 1
    hold_backward(got, A.flash_attn_bwd_torch(*args, scale), f"{shape}")
    again = A.flash_attn_bwd_cuda(*args, scale)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("last_valid", [63, 64, 65, 128, 255])
def test_backward_skips_key_tiles_without_a_valid_key(cuda, last_valid):
    """Valid keys ending at the edges of the 64-key tiles: every gradient
    within the gate of plain, dK = dV = 0 exactly on every masked key of a
    row that has a valid key (the skipped tiles, written though the outputs
    start as NaN), dQ = dK = 0 and dV the mean of dO in the all-pad row; q
    alone and k, v alone give the same bits as all three."""
    shape = (3, 4, 256, 64)
    n_valid = [last_valid, 256, 0]
    args, scale = backward_case(shape, n_valid, cuda, seed=last_valid)
    poison_allocator(cuda)
    d_q, d_k, d_v = A.flash_attn_bwd_cuda(*args, scale)
    torch.cuda.synchronize()
    hold_backward((d_q, d_k, d_v), A.flash_attn_bwd_torch(*args, scale),
                  f"keys valid up to {last_valid}")
    assert not d_k[0, :, last_valid:].any()
    assert not d_v[0, :, last_valid:].any()
    assert not d_q[2].any() and not d_k[2].any()
    d_out = args[4]
    mean = d_out[2].mean(dim=1, keepdim=True).expand_as(d_v[2])
    np.testing.assert_allclose(d_v[2].cpu().numpy(), mean.cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    poison_allocator(cuda)
    only_q = A.flash_attn_bwd_cuda(*args, scale, want_dkv=False)
    only_kv = A.flash_attn_bwd_cuda(*args, scale, want_dq=False)
    assert only_q[1] is None and only_q[2] is None and only_kv[0] is None
    assert torch.equal(only_q[0], d_q)
    assert torch.equal(only_kv[1], d_k) and torch.equal(only_kv[2], d_v)


@pytest.mark.needs_cuda
def test_backward_reads_strided_views_and_copies_what_it_must(cuda):
    """Head-split views are read in place; a tensor whose rows are not
    adjacent along D is copied and gives the same bits; the wrapper refuses
    what the kernel does not take."""
    shape = (2, 2, 70, 32)
    args, scale = backward_case(shape, [70, 33], cuda, seed=3)
    q, k, v, valid, d_out, out, m, l = args
    assert not q.is_contiguous() and A._rows_in_place(q) is q
    got = A.flash_attn_bwd_cuda(*args, scale)
    contiguous = A.flash_attn_bwd_cuda(
        *(t.contiguous() for t in (q, k, v)), valid, d_out.contiguous(),
        out.contiguous(), m, l, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, contiguous))
    d_moved = d_out.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert A._rows_in_place(d_moved) is not d_moved
    copied = A.flash_attn_bwd_cuda(q, k, v, valid, d_moved, out, m, l, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, copied))
    with pytest.raises(ValueError, match="want_dq or want_dkv"):
        A.flash_attn_bwd_cuda(*args, scale, want_dq=False, want_dkv=False)
    with pytest.raises(ValueError, match="contiguous float32 m"):
        A.flash_attn_bwd_cuda(q, k, v, valid, d_out, out, m.transpose(1, 2)
                              .contiguous().transpose(1, 2), l, scale)
    with pytest.raises(ValueError, match="CUDA device"):
        A.flash_attn_bwd_cuda(*(t.cpu() for t in args), scale)


def forward_case(length, dim, last_valid, cuda, seed):
    """Head-split q, k, v (q three times wider) of shape (5, 3, length,
    dim) and a mask of five batch rows: valid keys up to ``last_valid``, a
    row whose valid keys all lie in its last key tile (the tiles before
    that one hold none), a full row, a row with no valid key and one with a
    single valid key in the middle."""
    bsz, heads = 5, 3
    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.from_numpy(rng.normal(0, gain, (bsz, length, heads * dim))
                         .astype(np.float32)).to(cuda)
        .reshape(bsz, length, heads, dim).transpose(1, 2)
        for gain in (3.0, 1.0, 1.0))
    valid = np.zeros((bsz, length), bool)
    valid[0, :last_valid + 1] = True
    valid[1, (length - 1) // 64 * 64:] = True
    valid[2] = True
    valid[4, length // 2] = True
    return q, k, v, torch.from_numpy(valid).to(cuda)


def plain_row_statistics(q, k, valid, scale):
    """m and l of the plain masked softmax: each row's largest score
    (masked keys at finfo(float32).min) and sum of exp(score - m)."""
    scores = torch.matmul(q, k.transpose(-2, -1)) * scale
    scores = scores.masked_fill(~valid[:, None, None, :],
                                torch.finfo(torch.float32).min)
    m = scores.max(-1).values
    return m, torch.exp(scores - m[..., None]).sum(-1)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("length,dim,last_valid",
                         [(256, 64, 63), (256, 64, 64), (256, 64, 127),
                          (256, 64, 255), (256, 128, 127), (1, 16, 0),
                          (37, 32, 20), (500, 64, 499), (500, 64, 130)],
                         ids=lambda x: str(x))
def test_forward_skips_key_tiles_without_a_valid_key(cuda, length, dim,
                                                     last_valid):
    """K3a against the plain version on every row with outputs NaN-poisoned:
    valid keys ending at and around the edges of the 64-key tiles, a row
    whose first tiles hold no valid key (skipped), a full row, a row with
    no valid key (uniform 1/L) and one with a single valid key. m and l
    against the plain row statistics (exactly -FLT_MAX and L in the row
    without a valid key); the same O without them; the same bits on a
    second call and from contiguous copies of the head-split views."""
    q, k, v, valid = forward_case(length, dim, last_valid, cuda,
                                  seed=length + dim + last_valid)
    scale = 1.0 / math.sqrt(dim)
    assert A._rows_in_place(q) is q and q.is_contiguous() == (length == 1)
    poison_allocator(cuda)
    before = A.flash_attn_fwd_cuda.launches
    out, m, l = A.flash_attn_fwd_cuda(q, k, v, valid, scale, with_stats=True)
    poison_allocator(cuda)
    bare, no_m, no_l = A.flash_attn_fwd_cuda(q, k, v, valid, scale)
    torch.cuda.synchronize()
    assert A.flash_attn_fwd_cuda.launches - before == 2
    assert no_m is None and no_l is None
    want = A.flash_self_attention_torch(q, k, v, valid, sm_scale=scale)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL, rtol=ATOL)
    assert torch.equal(bare, out)
    want_m, want_l = plain_row_statistics(q, k, valid, scale)
    np.testing.assert_allclose(m.cpu().numpy(), want_m.cpu().numpy(),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(l.cpu().numpy(), want_l.cpu().numpy(),
                               rtol=ATOL)
    assert (m[3] == torch.finfo(torch.float32).min).all()
    assert (l[3] == length).all()
    again = A.flash_attn_fwd_cuda(q, k, v, valid, scale, with_stats=True)
    copies = A.flash_attn_fwd_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), valid, scale,
                                   with_stats=True)
    for other in (again, copies):
        assert all(torch.equal(a, b) for a, b in zip(other, (out, m, l)))
