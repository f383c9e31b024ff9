"""bfloat16 compute (``--compute_dtype bfloat16``) of the PyTorch port
against the JAX package's.

* the three model families in bf16 against the JAX bf16 models from the
  same float32 weights (``models.flax_import``): encoder-only with a linear
  output and a perturbed head, conv-enc, and the encoder-decoder teacher
  forced, valid rows held against bf16's own error (``hold_to_jax_bf16``:
  where every rounding falls alike, the two agree to ~1e-7 of the largest
  output, the casts sitting where flax puts them);
* the JAX package's own bf16 gates (tests/test_models.py), mirrored on the
  port: parameters and outputs float32, the bf16 trunk within 1e-2 (zero
  head) and 6e-2 (perturbed head) of the fp32 trunk and not bit-identical;
  one training step at dropout 0 whose loss is finite and within 1e-4
  relative of the JAX bf16 step's; an epoch through the CLI;
* the plain bf16 flash forward and backward against the JAX bf16
  materialised branch (its ``MultiHeadedAttention`` with identity
  projections, ``jax.vjp``) on valid rows, and against
  ``mha_reference_no_custom_vjp`` run in fp32 on the same bf16 values,
  within the bf16 bound 1e-2 x the largest reference entry;
* on a card only (``needs_cuda``): both bf16 kernel instances against their
  plain versions, their launch counters, and the dtypes they refuse:

    python -m pytest --noconftest -m needs_cuda tests/test_torch_bf16.py

The port side runs on the CPU and never imports JAX: only this file does,
inside the tests, so that the card-only tests collect without JAX.
"""
import math

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data import synthetic as tsyn
from protein_transformer_tpu_torch.data.dataset import collate
from protein_transformer_tpu_torch.models import conv_encoder as tconv
from protein_transformer_tpu_torch.models import enc_dec as ted
from protein_transformer_tpu_torch.models import encoder_only as tenc
from protein_transformer_tpu_torch.models import transformer as ttr
from protein_transformer_tpu_torch.models.factory import make_model
from protein_transformer_tpu_torch.models.flax_import import (
    flax_to_state_dict, load_flax_params)
from protein_transformer_tpu_torch.ops import attention as A
from protein_transformer_tpu_torch.training import cli as tcli
from protein_transformer_tpu_torch.training.trainer import Trainer

BF16 = torch.bfloat16
PAD_ID = 20
B, L, DM, DFF, NH, NL = 3, 40, 32, 64, 2, 2
# a bf16 result against a reference, of the reference's largest entry:
# eight bits of mantissa are 4e-3 relative, and a few roundings add up
BF16_TOL = 1e-2
CPU = torch.device("cpu")


def angle_means():
    return np.clip(np.random.default_rng(0).normal(0, 0.3, 24), -0.9, 0.9)


def padded_ids(seed=0, bsz=B, length=L, n_valid=(L, 31, 20)):
    ids = np.random.default_rng(seed).integers(0, 20, (bsz, length))
    for i, n in enumerate(n_valid):
        ids[i, n:] = PAD_ID
    return ids.astype(np.int32)


def as_numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(params, path, seed=5, std=0.2):
    """params with the kernel at ``path`` set to N(0, std) draws, so that
    the trunk reaches the outputs (the heads start at zero or near it), and
    every other bias and layer-norm scale drawn too (flax starts them at 0
    and 1, where the bias adds and the scales round nothing)."""
    import jax
    rng = np.random.default_rng(seed + 1)

    def draw(key_path, leaf):
        name = key_path[-1].key
        if name == "bias":
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1 + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(draw, params)
    node = params["params"]
    for key in path:
        node = node[key]
    node["kernel"] = np.random.default_rng(seed).normal(
        0, std, node["kernel"].shape).astype(np.float32)
    return params


def model_pairs(family, dtype):
    """(JAX model, port model, the path of the JAX model's output head) of
    one family at compute dtype ``dtype``."""
    import jax.numpy as jnp
    from protein_transformer_tpu.models import conv_encoder as jconv
    from protein_transformer_tpu.models import enc_dec as jed
    from protein_transformer_tpu.models import encoder_only as jenc
    jdt = jnp.dtype(dtype)
    tdt = None if dtype == "float32" else BF16
    am = angle_means()
    common = dict(n_heads=NH, d_model=DM, d_ff=DFF, max_len=L,
                  vocab_size=22, dropout=0.0, pad_id=PAD_ID)
    if family == "enc-dec":
        enc_dec = dict(n_enc_layers=NL, n_dec_layers=NL, **common)
        return (jed.Transformer(angle_means=tuple(am), dtype=jdt, **enc_dec),
                ted.Transformer(angle_means=am, dtype=tdt, **enc_dec),
                ("output_projection",))
    common.update(n_layers=NL, angle_means=tuple(am))
    if family == "enc-only-linear-out":
        return (jenc.EncoderOnlyTransformer(use_tanh_out=False, dtype=jdt,
                                            **common),
                tenc.EncoderOnlyTransformer(use_tanh_out=False, dtype=tdt,
                                            **common),
                ("AngleProjection_0", "output_projection"))
    conv = dict(conv_kernel_sizes=(5, 3), conv_dim_reductions=(2.0, 2.0))
    return (jconv.ConvEncoderOnlyTransformer(dtype=jdt, **conv, **common),
            tconv.ConvEncoderOnlyTransformer(dtype=tdt, **conv, **common),
            ("AngleProjection_0", "output_projection"))


def targets(seed=1):
    """(B, L, 24) sin/cos targets with a missing (NaN) residue."""
    ang = np.random.default_rng(seed).uniform(-1, 1, (B, L, 24))
    ang[0, 5] = np.nan
    return ang.astype(np.float32)


def hold_to_jax_bf16(got, want, fp32, valid):
    """The port's bf16 outputs ``got`` against the JAX bf16 model's
    ``want`` on valid rows, measured against bf16's own error, the distance
    of ``want`` from the fp32 model's ``fp32``: the root mean square of the
    difference at most half of it, and the largest at most its largest.
    Where every rounding falls the same way the two agree to ~1e-7 of the
    largest output (measured on the CPU); the layer norm's fp32 arithmetic
    runs in another order than flax's, so now and then a bf16 rounding
    falls the other way, and random weights carry that one ulp to the
    outputs (measured on the CPU over three draws of the weights for each
    family: twice, with an RMS 0.04 and 0.36 of bf16's own)."""
    got, want, fp32 = got[valid], want[valid], fp32[valid]
    rms = lambda x: float(np.sqrt(np.mean(np.square(x))))  # noqa: E731
    assert rms(got - want) <= 0.5 * rms(want - fp32), (
        rms(got - want), rms(want - fp32))
    assert np.abs(got - want).max() <= np.abs(want - fp32).max()


@pytest.mark.parametrize("family", ["enc-only-linear-out", "conv-enc",
                                    "enc-dec"])
def test_bf16_model_matches_the_jax_bf16_model(family):
    """Same float32 weights through the bridge (biases and layer-norm
    scales drawn, the head perturbed), bf16 compute in both packages:
    parameters and outputs float32, the port's bf16 outputs held to the JAX
    bf16 model's by ``hold_to_jax_bf16``."""
    import jax
    import jax.numpy as jnp
    jmodel, tmodel, head = model_pairs(family, "bfloat16")
    ids = padded_ids()
    args = (jnp.asarray(ids),)
    targs = (torch.from_numpy(ids),)
    if family == "enc-dec":
        ang = targets()
        args += (jnp.asarray(ang),)
        targs += (torch.from_numpy(ang),)
    params = perturbed(as_numpy(jax.jit(jmodel.init)(jax.random.PRNGKey(4),
                                                     *args)), head)
    leaf_dtypes = {a.dtype for a in jax.tree_util.tree_leaves(params)}
    assert leaf_dtypes == {np.dtype(np.float32)}
    # op by op, as the flax modules cast: under jit XLA's fusions keep
    # some bf16 intermediates in fp32 (~4e-3 of the largest output here)
    want = np.asarray(jmodel.apply(params, *args))
    load_flax_params(tmodel, params)
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    with torch.no_grad():
        got = tmodel.eval()(*targs)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    _, fp32_model, _ = model_pairs(family, "float32")
    load_flax_params(fp32_model, params)
    with torch.no_grad():
        fp32 = fp32_model.eval()(*targs).numpy()
    hold_to_jax_bf16(got.numpy(), want, fp32, ids != PAD_ID)


def port_outputs(model_kw, ids, head_seed=None):
    """{dtype: the port model's output} from the same fresh weights:
    fan-in scaled normal trunk weights, the head as built (zero weight)
    unless ``head_seed`` draws it."""
    outs = {}
    state = None
    for dtype in ("float32", "bfloat16"):
        model = (make_model(TConfig(compute_dtype=dtype, **model_kw)
                            .finalize(), angle_means())
                 if "model" in model_kw else
                 tenc.EncoderOnlyTransformer(
                     dtype=None if dtype == "float32" else BF16,
                     angle_means=angle_means(), **model_kw))
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        if state is None:
            torch.manual_seed(3)
            state = {k: torch.randn_like(v) * (v[0].numel() ** -0.5)
                     if v.dim() > 1 and not k.startswith("head.") else v
                     for k, v in model.state_dict().items()}
            if head_seed is not None:
                w = "head.output_projection.weight"
                state[w] = 0.2 * torch.randn(
                    state[w].shape,
                    generator=torch.Generator().manual_seed(head_seed))
        model.load_state_dict(state)
        with torch.no_grad():
            out = model.eval()(torch.from_numpy(ids))
        assert out.dtype == torch.float32
        outs[dtype] = out.numpy()
    return outs


def test_bf16_trunk_gates_of_the_jax_package_hold_on_the_port():
    """tests/test_models.py::test_bfloat16_trunk_matches_float32 on the
    port: a conv-enc model from the factory (zero head: within 1e-2), and an
    encoder-only linear-out model with a perturbed head (within 6e-2, and
    not bit-identical, so the dtype is plumbed)."""
    ids = padded_ids(seed=11)
    outs = port_outputs(dict(model="conv-enc|11|1", d_model=32, d_ff=64,
                             n_heads=4, n_layers=2, max_seq_len=L,
                             dropout=0.0), ids)
    np.testing.assert_allclose(outs["bfloat16"], outs["float32"], atol=1e-2)
    outs = port_outputs(dict(n_layers=2, n_heads=4, d_model=32, d_ff=64,
                             max_len=L, vocab_size=22, use_tanh_out=False),
                        ids, head_seed=5)
    np.testing.assert_allclose(outs["bfloat16"], outs["float32"], atol=6e-2,
                               rtol=0)
    assert np.abs(outs["bfloat16"] - outs["float32"]).max() > 0


def test_bf16_modules_cast_where_flax_does():
    """The embedding's scale is sqrt(dim) rounded to bf16 (22.625 at 512);
    the layer norm's statistics are fp32 and only its result is bf16; the
    materialised attention's scores are fp32; the output heads compute in
    float32; an unknown compute dtype is refused by the config."""
    assert ttr.Embeddings(22, 512, BF16).scale == 22.625
    assert ttr.Embeddings(22, 512).scale == math.sqrt(512)
    norm = ttr.LayerNorm(8, BF16)
    x = torch.tensor([[1e3, 1e3 + 8, 1e3 - 8, 1e3, 1e3, 1e3, 1e3, 1e3]],
                     dtype=BF16)
    want = torch.nn.functional.layer_norm(x.float(), (8,), eps=1e-6)
    assert norm(x).dtype == BF16
    assert torch.equal(norm(x), want.to(BF16))
    attn = ttr.MultiHeadedAttention(16, 2, dropout=0.0, dtype=BF16)
    seen = []
    attn.dropout.register_forward_hook(
        lambda _m, inputs, _out: seen.append(inputs[0].dtype))
    y = attn(*[torch.randn(2, 5, 16, dtype=BF16)] * 3,
             torch.ones(2, 1, 1, 5, dtype=torch.bool))
    assert y.dtype == BF16 and seen == [torch.float32]
    head = tenc.AngleProjection(16, angle_means())
    assert head(torch.randn(2, 5, 16, dtype=BF16)).dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        TConfig(compute_dtype="float16").finalize()


@pytest.fixture(scope="module")
def data():
    return tsyn.make_dataset(n_train=4, n_eval=2, min_len=8, max_len=24,
                             seed=3)


SLICE = dict(model="enc-only", d_model=16, d_ff=32, n_heads=2, n_layers=1,
             batch_size=4, loss="mse", optimizer="adam",
             lr_scheduling="noam", bucket_sizes=(24,), max_seq_len=24,
             dropout=0.0, train_only=True, compute_dtype="bfloat16",
             log_structure_step=0, log_val_struct_step=0)


def test_bf16_training_step_matches_the_jax_bf16_step(data, tmp_path):
    """tests/test_models.py::test_bfloat16_training_step_finite, held
    against JAX: from the same weights on the same batch, the port's bf16
    MSE loss is finite and within 1e-4 relative of the JAX package's bf16
    loss (measured 2.7e-5 on the CPU, where the fp32 loss of the same
    weights lies 2.1e-4 away: a bf16 rounding that falls the other way
    here and there), and one update keeps the parameters float32 and moves
    them."""
    import jax
    from protein_transformer_tpu.config import TrainConfig as JConfig
    from protein_transformer_tpu.data.dataset import collate as jcollate
    from protein_transformer_tpu.training.trainer import (
        Trainer as JTrainer, compute_losses as jcompute_losses)
    from test_torch_train import device_batch, flax_params

    jtr = JTrainer(JConfig(**SLICE, name="j", out_dir=str(tmp_path)),
                   data=data, use_mesh=False)
    assert jtr.cfg.compute_dtype == "bfloat16"
    jbatch = jcollate(jtr.dm.train, np.arange(4), jtr.cfg.bucket_sizes,
                      jtr.dm.max_seq_len)
    params = flax_params(jtr, jbatch)
    want = float(jax.jit(lambda p: jcompute_losses(
        jtr.model, p, device_batch(jbatch), jtr.cfg)[0])(params))

    tr = Trainer(TConfig(**SLICE, name="t", out_dir=str(tmp_path)),
                 device=CPU, data=data)
    batch = collate(tr.dm.train, np.arange(4), tr.cfg.bucket_sizes,
                    tr.dm.max_seq_len)
    state = tr.state_from(flax_to_state_dict(as_numpy(params), tr.model))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, out = tr.train_step(state, batch)
    loss = float(out[0])
    assert np.isfinite(loss) and abs(loss - want) <= 1e-4 * abs(want), (
        loss, want)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert not torch.equal(before["encoder.layers.0.ff.w_1.weight"],
                           state.params["encoder.layers.0.ff.w_1.weight"])


def test_bf16_trains_through_the_cli(data, tmp_path):
    """--compute_dtype bfloat16 is a setting of the CLI: an epoch trains,
    its metrics are finite, and config.json keeps the dtype."""
    import json
    path = tmp_path / "data.pt"
    torch.save(data, path)
    tcli.main(["--data", str(path), "--name", "bf", "--out_dir",
               str(tmp_path), "-m", "enc-only", "-dm", "16", "-dih", "32",
               "-nh", "2", "-nl", "1", "-e", "1", "-b", "4", "-l",
               "combined", "--train_only", "--compute_dtype", "bfloat16",
               "--log_structure_step", "0", "--device", "cpu"])
    with open(tmp_path / "bf" / "config.json") as f:
        assert json.load(f)["config"]["compute_dtype"] == "bfloat16"
    with open(tmp_path / "bf" / "bf.train") as f:
        rows = f.read().splitlines()
    assert len(rows) >= 2 and "nan" not in rows[-1].lower()


# ------------------------------------------------------- flash attention

def head_inputs(length, heads=2, dim=16, seed=7, bsz=3):
    """bf16-valued (B, L, H * D) q, k, v and cotangent as float32 numpy
    arrays (q three times wider, as chip_smoke.py draws them), a mask with
    ragged lengths and a batch row with no valid key, and the lengths."""
    rng = np.random.default_rng(seed)
    arrays = [torch.from_numpy(rng.normal(0, gain, (bsz, length, heads * dim))
                               .astype(np.float32)).to(BF16).float().numpy()
              for gain in (3.0, 1.0, 1.0, 1.0)]
    n_valid = [length, max(length - 9, 1), 0][:bsz]
    valid = np.arange(length)[None, :] < np.asarray(n_valid)[:, None]
    # no cotangent on pad query rows: the fp32 reference lets them attend
    # to pad keys only, the port and the materialised branch to valid keys
    arrays[3] *= valid[:, :, None]
    return arrays, valid, n_valid


def split_heads(x, heads):
    bsz, length, width = x.shape
    return x.reshape(bsz, length, heads, width // heads).transpose(1, 2)


def jax_materialised(arrays, valid, heads):
    """The JAX bf16 materialised branch (its MultiHeadedAttention, bf16, the
    projections set to the identity so that q, k and v are the inputs) and
    its vjp for the cotangent: (O, (dq, dk, dv)), (B, L, H * D) float32."""
    import jax
    import jax.numpy as jnp
    from protein_transformer_tpu.models import transformer as jtr
    q, k, v, d_out = (jnp.asarray(x, jnp.bfloat16) for x in arrays)
    width = q.shape[-1]
    attn = jtr.MultiHeadedAttention(width, heads, dropout=0.0,
                                    dtype=jnp.bfloat16, impl="xla")
    mask = jnp.asarray(valid)[:, None, None, :]
    eye = {"kernel": jnp.eye(width), "bias": jnp.zeros(width)}
    params = {"params": {n: eye for n in ("wq", "wk", "wv", "wo")}}
    @jax.jit
    def out_and_grads(q, k, v, d_out):
        out, vjp = jax.vjp(lambda a, b, c: attn.apply(params, a, b, c, mask),
                           q, k, v)
        return out, vjp(d_out)

    out, grads = out_and_grads(q, k, v, d_out)
    return (np.asarray(out, np.float32),
            [np.asarray(g, np.float32) for g in grads])


def fp32_reference(arrays, valid, heads, scale):
    """``mha_reference_no_custom_vjp`` in fp32 on the same bf16 values,
    every batch row with a valid key given one segment and pads another
    (the JAX flash path's masking; the all-pad row is left out by the
    callers), with its gradients by jax.vjp: (O, (dq, dk, dv)) in
    (B, H, L, D)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference_no_custom_vjp)
    q, k, v, d_out = (jnp.asarray(split_heads(torch.from_numpy(x), heads)
                                  .numpy()) for x in arrays)
    seg = jnp.asarray(np.where(valid, 0, 1), jnp.int32)

    def ref(a, b, c):
        return mha_reference_no_custom_vjp(
            a, b, c, None, SegmentIds(q=seg, kv=seg), causal=False,
            sm_scale=scale)

    @jax.jit
    def out_and_grads(q, k, v, d_out):
        out, vjp = jax.vjp(ref, q, k, v)
        return out, vjp(d_out)

    out, grads = out_and_grads(q, k, v, d_out)
    return np.asarray(out), [np.asarray(g) for g in grads]


def bf16_close(got, want, what, rows=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    err = float(np.abs(got - want).max())
    bound = BF16_TOL * float(np.abs(want).max())
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def test_plain_bf16_flash_matches_the_jax_bf16_materialised_branch():
    """The bf16 plain forward (and autograd through it) and the bf16 plain
    backward from the forward's statistics, against the JAX bf16
    materialised branch on valid rows of batch rows with a valid key, and
    against the fp32 reference on the same bf16 values; O and the
    gradients come back bf16."""
    length, heads, dim = 40, 2, 16
    arrays, valid, n_valid = head_inputs(length, heads, dim)
    scale = 1.0 / math.sqrt(dim)
    j_out, j_grads = jax_materialised(arrays, valid, heads)
    r_out, r_grads = fp32_reference(arrays, valid, heads, scale)

    q, k, v, d_out = (split_heads(torch.from_numpy(x).to(BF16), heads)
                      for x in arrays)
    valid_t = torch.from_numpy(valid)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = A.flash_self_attention(*leaves, valid_t, sm_scale=scale)
    grads = torch.autograd.grad(out, leaves, d_out)
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    # the backward's plain version, from the forward's row statistics
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale
    s = s.masked_fill(~valid_t[:, None, None, :],
                      torch.finfo(torch.float32).min)
    m = s.max(-1).values
    l = torch.exp(s - m[..., None]).sum(-1)
    b_grads = A.flash_attn_bwd_torch(q, k, v, valid_t, d_out, out.detach(),
                                     m, l, scale)
    assert all(g.dtype == BF16 for g in b_grads)

    def merged(t):  # (B, H, L, D) -> (B, L, H * D)
        return t.float().transpose(1, 2).reshape(t.shape[0], length, -1)

    for i, n in enumerate(n_valid[:2]):
        rows = (i, slice(0, n))
        bf16_close(merged(out.detach())[rows], j_out[rows], f"O row {i}")
        bf16_close(out.detach().float()[i, :, :n], r_out[i, :, :n],
                   f"O row {i} against fp32")
        for name, g, bg, jg, rg in zip("qkv", grads, b_grads, j_grads,
                                       r_grads):
            for label, mine in (("autograd", g), ("backward", bg)):
                bf16_close(merged(mine)[rows], jg[rows],
                           f"{label} d/d{name} row {i}")
                bf16_close(mine.float()[i, :, :n], rg[i, :, :n],
                           f"{label} d/d{name} row {i} against fp32")
    assert torch.isfinite(out).all() and all(
        torch.isfinite(g).all() for g in (*grads, *b_grads))


def test_bf16_flash_model_equals_its_materialised_branch():
    """On the CPU the flash path of a bf16 model runs the plain version,
    whose casts are the materialised branch's: the same outputs."""
    ids = padded_ids(seed=2)
    outs = {}
    for impl in ("xla", "flash"):
        model = make_model(TConfig(model="conv-enc|5,3|1,1", d_model=32,
                                   d_ff=64, n_heads=2, n_layers=2,
                                   max_seq_len=L, attention_impl=impl,
                                   compute_dtype="bfloat16").finalize(),
                           angle_means())
        torch.manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0, p.shape[-1] ** -0.5)
            outs[impl] = model.eval()(torch.from_numpy(ids))
    valid = torch.from_numpy(ids != PAD_ID)
    torch.testing.assert_close(outs["flash"][valid], outs["xla"][valid],
                               rtol=0, atol=1e-6)


def test_bounds_of_the_bf16_instances():
    """chip_smoke's bound of the bf16 instances: two bytes an element of q,
    k, v, O (and dQ, dK, dV, dO), m and l still four, the products at 989
    TFLOP/s, one a pair-term. K3a-bf16 at (8, 8, 256, 64): 8.39 MB -> 2.50
    us by bytes, its products 1.07 GFLOP -> 1.09 us; the backward at (16, 8,
    256, 64) with m and l: 33.8 MB -> 10.1 us."""
    import chip_smoke
    full = 8 * 8 * 256 * 256
    ms, by = chip_smoke.attention_bound("flash_attn_fwd", (8, 8, 256, 64),
                                        full, elem=2)
    assert by == "bytes" and round(ms, 5) == 0.0025
    assert ms == pytest.approx(1e3 * (4 * 2 * 8 * 8 * 256 * 64 + 8 * 256)
                               / 3.35e12)
    products = 4 * 64 * full
    assert round(products / 1e9, 2) == 1.07
    assert round(1e6 * products / 989e12, 2) == 1.09
    ms, by = chip_smoke.attention_bound("flash_attn_bwd", (16, 8, 256, 64),
                                        2 * full, elem=2)
    n_bytes = 8 * 2 * 16 * 8 * 256 * 64 + 2 * 4 * 16 * 8 * 256 + 16 * 256
    assert by == "bytes" and round(n_bytes / 1e6, 1) == 33.8
    assert ms == pytest.approx(1e3 * n_bytes / 3.35e12)
    assert round(ms, 4) == 0.0101


PTXAS_ENTRY = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers
"""


def test_ptxas_report_names_every_bf16_kernel():
    """chip_smoke's phase 2 reads registers and spills of each bf16 kernel
    at each D from ptxas -v (anonymous-namespace names as nvcc mangles
    them), and nothing of the fp32 instances."""
    import chip_smoke
    entries = [("_ZN45_GLOBAL__N__7e880f4c_12_attention_cu_12ea445126flash_"
                "attn_bwd_bf16_kernelILi64EEEvNS_11BwdBf16ArgsE", 8, 168),
               ("_ZN45_GLOBAL__N__7e880f4c_12_attention_cu_12ea445126flash_"
                "attn_fwd_bf16_kernelILi16EEEvPK13__nv_bfloat16", 0, 69),
               ("_ZN45_GLOBAL__N__7e880f4c_12_attention_cu_12ea445121flash_"
                "attn_bwd_kernelILi64EEEvNS_7BwdArgsE", 0, 230)]
    log = "ptxas info    : 0 bytes gmem\n" + "".join(
        PTXAS_ENTRY.format(name=n, spill=sp, regs=r) for n, sp, r in entries)
    assert chip_smoke.kernel_resources(log, chip_smoke.BF16_KERNELS) == {
        ("flash_attn_bwd_bf16_kernel", 64): (168, 8, 8),
        ("flash_attn_fwd_bf16_kernel", 16): (69, 0, 0)}


def test_wrappers_copy_a_broadcast_view():
    """A tensor map takes no stride of 0: a view broadcast along a
    dimension of more than one element is copied before a launch, one of
    size one is not, and head-split views stay in place."""
    row = torch.zeros(6, 16, dtype=BF16)
    shared = row.expand(2, 4, 6, 16)
    assert shared.stride()[:2] == (0, 0)
    assert A._rows_in_place(shared).is_contiguous()
    single = torch.as_strided(row, (1, 1, 6, 16), (0, 0, 16, 1))
    assert A._rows_in_place(single) is single
    split = torch.zeros(2, 6, 64, dtype=BF16).reshape(2, 6, 4, 16)
    assert A._rows_in_place(split.transpose(1, 2)).data_ptr() \
        == split.data_ptr()


def test_build_keeps_what_ptxas_said(monkeypatch, tmp_path):
    """ops/_build.py builds with -Xptxas -v and keeps its report beside the
    library: ptxas_log gives it back, and a rebuilt source gets its own."""
    from protein_transformer_tpu_torch.ops import _build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\n"
                    "echo \"ptxas info    : Used 7 registers ($*)\" >&2\n")
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// one\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    (tmp_path / "cuda" / "bin").mkdir(parents=True)
    (tmp_path / "cuda" / "bin" / "nvcc").symlink_to(nvcc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert "-Xptxas" in _build.NVCC_FLAGS and "-v" in _build.NVCC_FLAGS
    lib = _build.build("k")
    assert lib.is_file() and _build.ptxas_log("k").startswith(
        "ptxas info    : Used 7 registers")
    (csrc / "k.cu").write_text("// two\n")
    assert _build.build("k") != lib
    assert len(list((tmp_path / "build").glob("*.ptxas.txt"))) == 2


def test_bench_tool_takes_the_bf16_instances(monkeypatch):
    """``tools/bench_attention.py --dtype bfloat16`` draws bf16 head-split
    views that the kernels read in place, and refuses without a card."""
    from protein_transformer_tpu_torch.tools import bench_attention
    q, k, v, d_out, valid = bench_attention.attention_inputs(
        CPU, (3, 2, 40, 16), seed=1, dtype=BF16)
    assert all(t.dtype == BF16 and t.shape == (3, 2, 40, 16)
               and A._rows_in_place(t) is t for t in (q, k, v, d_out))
    assert valid.sum(1).tolist()[-1] == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_attention.main(["--dtype", "bfloat16"])


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_inputs(shape, cuda, seed=0):
    """bf16 head-split views (q three times wider), the cotangent, and a
    mask with ragged lengths and a batch row with no valid key; with four
    rows or more, row 1 has its first 64 keys masked (half its keys at L <=
    64) and a valid key after them: a key tile without a valid key, before
    the first valid one, in a row that has one."""
    bsz, heads, length, dim = shape
    rng = np.random.default_rng(seed)
    q, k, v, d_out = (
        torch.from_numpy(rng.normal(0, gain, (bsz, length, heads * dim))
                         .astype(np.float32)).to(cuda, BF16)
        .reshape(bsz, length, heads, dim).transpose(1, 2)
        for gain in (3.0, 1.0, 1.0, 1.0))
    n_valid = rng.integers(1, length + 1, bsz)
    n_valid[0] = length
    if bsz > 1:
        n_valid[-1] = 0
    keys = np.arange(length)
    valid = keys[None, :] < n_valid[:, None]
    if bsz > 3:
        hole = 64 if length > 64 else length // 2
        valid[1] = (keys >= hole) & (keys <= rng.integers(hole, length))
    return q, k, v, d_out, torch.from_numpy(valid).to(cuda)


def poison_allocator(cuda):
    """Leave NaNs where the caching allocator hands out the next blocks, so
    that an output row a kernel fails to write shows."""
    torch.full((64 << 20,), float("nan"), device=cuda)
    torch.cuda.synchronize()


def card_close(got, want, what):
    err = float((got.float() - want.float()).abs().max())
    bound = BF16_TOL * max(float(want.float().abs().max()), 1e-30)
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


# (B, H, L, D) of the card checks, the cases of chip_smoke.py's
# BF16_ATTENTION_CASES: the predict and training batches, the longest
# proteins and the small sizes of the fp32 kernels' checks, then every head
# dimension the kernels take at lengths that end inside a tile of 64 and of
# 32 keys (1, 70, 130, 500) or on one (256), with a masked first tile in
# row 1 (card_inputs).
CARD_CASES = [(8, 8, 256, 64), (16, 8, 256, 64), (8, 8, 500, 64),
              (3, 2, 37, 16), (1, 1, 1, 16), (2, 3, 130, 32),
              (2, 2, 70, 128)] + [(4, 2, length, dim)
                                  for dim in (16, 32, 64, 128)
                                  for length in (1, 70, 130, 256, 500)]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", CARD_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_kernels_match_plain_on_card(cuda, shape):
    """K3a-bf16 and the bf16 backward against their plain versions and the
    fp32 plain run on the same bf16 values, every row, on head-split views
    with outputs handed out NaN-filled: one launch each of the bf16
    instances and none of the fp32 ones; the same bits twice."""
    q, k, v, d_out, valid = card_inputs(shape, cuda, seed=sum(shape))
    scale = 1.0 / math.sqrt(shape[-1])
    counts = lambda: (A.flash_attn_fwd_cuda.launches,  # noqa: E731
                      A.flash_attn_fwd_cuda.launches_bf16,
                      A.flash_attn_bwd_cuda.launches,
                      A.flash_attn_bwd_cuda.launches_bf16)
    before = counts()
    poison_allocator(cuda)
    out, m, l = A.flash_attn_fwd_cuda(q, k, v, valid, scale, with_stats=True)
    poison_allocator(cuda)
    grads = A.flash_attn_bwd_cuda(q, k, v, valid, d_out, out, m, l, scale)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 1, 0, 1)
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    assert m.dtype == l.dtype == torch.float32
    plain = A.flash_self_attention_torch(q, k, v, valid, sm_scale=scale)
    fp32 = A.flash_self_attention_torch(q.float(), k.float(), v.float(),
                                        valid, sm_scale=scale)
    card_close(out, plain, f"O against plain, {shape}")
    card_close(out, fp32, f"O against fp32, {shape}")
    p_grads = A.flash_attn_bwd_torch(q, k, v, valid, d_out, out, m, l, scale)
    f_grads = A.flash_attn_bwd_torch(q.float(), k.float(), v.float(), valid,
                                     d_out.float(), out.float(), m, l, scale)
    assert torch.isfinite(out).all() and torch.isfinite(m).all() \
        and torch.isfinite(l).all()
    for name, g, p, f in zip("qkv", grads, p_grads, f_grads):
        assert torch.isfinite(g).all()
        if shape[2] == 1 and shape[0] == 4 and name != "v":
            # one key: P = 1, so dS = P (dP - delta) and with it dQ and dK
            # are zero, and every version returns the rounding residue of
            # dP - delta (the plain ones too); the largest entry has no
            # scale, so in the cases of the grid the residue is held to that
            # of the cancelled term, scale dP K (for dQ) or scale dP Q (for
            # dK). (1, 1, 1, 16) keeps the largest entry, which it meets.
            d_p = (d_out.float() * v.float()).sum(-1, keepdim=True)
            other = k if name == "q" else q
            term = float((scale * d_p * other.float()).abs().max())
            assert float(g.float().abs().max()) <= BF16_TOL * term, (
                f"d/d{name} at one key, {shape}")
            continue
        card_close(g, p, f"d/d{name} against plain, {shape}")
        card_close(g, f, f"d/d{name} against fp32, {shape}")
    again = A.flash_attn_fwd_cuda(q, k, v, valid, scale, with_stats=True)
    assert torch.equal(again[0], out) and torch.equal(again[1], m)
    assert all(torch.equal(a, b) for a, b in zip(
        A.flash_attn_bwd_cuda(q, k, v, valid, d_out, out, m, l, scale),
        grads))


@pytest.mark.needs_cuda
def test_bf16_kernels_launch_from_a_fresh_thread(cuda):
    """The bf16 launchers make their tensor maps after a runtime call, so a
    thread that has made no CUDA call yet (as the autograd engine's may be
    at its first backward) launches them too, with the main thread's
    bits."""
    import threading
    q, k, v, d_out, valid = card_inputs((4, 2, 130, 64), cuda, seed=5)
    out, m, l = A.flash_attn_fwd_cuda(q, k, v, valid, 0.125, with_stats=True)
    grads = A.flash_attn_bwd_cuda(q, k, v, valid, d_out, out, m, l, 0.125)
    got = {}

    def run():
        got["fwd"] = A.flash_attn_fwd_cuda(q, k, v, valid, 0.125,
                                           with_stats=True)
        got["bwd"] = A.flash_attn_bwd_cuda(q, k, v, valid, d_out, out, m, l,
                                           0.125)
        torch.cuda.synchronize()

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert torch.equal(got["fwd"][0], out)
    assert all(torch.equal(a, b) for a, b in zip(got["bwd"], grads))


@pytest.mark.needs_cuda
def test_bf16_wrappers_refuse_float16_and_mixed_dtypes(cuda):
    q, k, v, d_out, valid = card_inputs((2, 2, 8, 16), cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.flash_attn_fwd_cuda(q.half(), k.half(), v.half(), valid, 1.0)
    with pytest.raises(TypeError, match="one dtype"):
        A.flash_attn_fwd_cuda(q, k.float(), v, valid, 1.0)
    out, m, l = A.flash_attn_fwd_cuda(q, k, v, valid, 1.0, with_stats=True)
    with pytest.raises(TypeError, match="one dtype"):
        A.flash_attn_bwd_cuda(q, k, v, valid, d_out.float(), out, m, l, 1.0)
    with pytest.raises(ValueError, match="float32"):
        A.flash_attn_bwd_cuda(q, k, v, valid, d_out, out, m.to(BF16), l, 1.0)
