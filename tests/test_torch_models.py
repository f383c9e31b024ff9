"""Models of the PyTorch port against the JAX (flax) modules.

Weights go from flax to the port through the weights bridge
(``models.flax_import``), so each test also checks the bridge. Gate: the
repo's model-forward bound, atol 2e-5 with rtol 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from protein_transformer_tpu.models import conv_encoder as jconv
from protein_transformer_tpu.models import encoder_only as jenc
from protein_transformer_tpu.models import transformer as jtr
from protein_transformer_tpu.protein.vocab import VOCAB
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.models import conv_encoder as tconv
from protein_transformer_tpu_torch.models import encoder_only as tenc
from protein_transformer_tpu_torch.models import transformer as ttr
from protein_transformer_tpu_torch.models.factory import (
    make_model, parse_conv_kernel_info_from_model_name)
from protein_transformer_tpu_torch.models.flax_import import (
    flax_to_state_dict, load_flax_params, params_from_flat_keys)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
B, L, DM, DFF, NH, NL = 2, 12, 32, 64, 2, 2
ATOL, RTOL = 2e-5, 1e-4


def ids_with_padding(seed=0, bsz=B, length=L):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 20, (bsz, length)).astype(np.int32)
    ids[0, -3:] = VOCAB.pad_id
    return ids


def angle_means(seed=1):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, 24).astype(
        np.float32)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port(module, flax_params):
    load_flax_params(module, to_numpy(flax_params))
    return module.eval()


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_embeddings_and_positional_encoding():
    ids = ids_with_padding()
    emb = jtr.Embeddings(len(VOCAB), DM)
    p = emb.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    x = emb.apply(p, jnp.asarray(ids))
    want = x + jtr.PositionalEncoding(DM, L).apply({}, x)
    temb = port(ttr.Embeddings(len(VOCAB), DM), p["params"])
    tpe = ttr.PositionalEncoding(DM, L).eval()
    tx = temb(torch.from_numpy(ids))
    close(tx + tpe(tx), want)


def test_attention_with_padded_keys():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, L, DM)).astype(np.float32)
    mask = (ids_with_padding() != VOCAB.pad_id)[:, None, None, :]
    attn = jtr.MultiHeadedAttention(DM, NH)
    p = attn.init(jax.random.PRNGKey(1), x, x, x, mask)
    want = attn.apply(p, x, x, x, mask)
    tattn = port(ttr.MultiHeadedAttention(DM, NH), p["params"])
    tx = torch.from_numpy(x)
    close(tattn(tx, tx, tx, torch.from_numpy(mask)), want)


@pytest.mark.parametrize("prenorm", [True, False])
def test_encoder_layer(prenorm):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, L, DM)).astype(np.float32)
    mask = (ids_with_padding() != VOCAB.pad_id)[:, None, None, :]
    layer = jtr.EncoderLayer(DM, DFF, NH, prenorm=prenorm)
    p = layer.init(jax.random.PRNGKey(2), x, mask)
    want = layer.apply(p, x, mask)
    tlayer = port(ttr.EncoderLayer(DM, DFF, NH, prenorm=prenorm), p["params"])
    close(tlayer(torch.from_numpy(x), torch.from_numpy(mask)), want)


def test_conv_stack():
    """flax NLC 'SAME' convs vs Conv1d on NCL with padding k//2."""
    import flax.linen as fnn

    class Stack(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Conv(16, (5,), padding="SAME")(x)
            return fnn.Conv(DM, (3,), padding="SAME")(x)

    x = np.random.default_rng(4).normal(size=(B, L, DM)).astype(np.float32)
    p = Stack().init(jax.random.PRNGKey(3), x)
    want = Stack().apply(p, x)
    dims = tconv.conv_layer_dims(DM, 22, True, (5, 3), (2.0, 2.0), True)
    assert dims == [(5, DM, 16), (3, 16, DM)]
    stack = nn.Module()
    stack.convs = nn.ModuleList([nn.Conv1d(i, o, k, padding=k // 2)
                                 for k, i, o in dims])
    port(stack, p["params"])
    y = torch.from_numpy(x).transpose(1, 2)
    for conv in stack.convs:
        y = conv(y)
    close(y.transpose(1, 2), want)


def model_pair(name):
    am = angle_means()
    common = dict(n_layers=NL, n_heads=NH, d_model=DM, d_ff=DFF, max_len=L,
                  vocab_size=len(VOCAB), angle_means=am, dropout=0.1,
                  pad_id=VOCAB.pad_id)
    if name == "enc-only":
        return (jenc.EncoderOnlyTransformer(**common, use_tanh_out=True),
                tenc.EncoderOnlyTransformer(**common, use_tanh_out=True))
    conv = dict(conv_kernel_sizes=(5, 3), conv_dim_reductions=(2.0, 2.0),
                use_tanh_out=True, use_embedding=True)
    if name == "conv-enc-noemb":
        conv = dict(conv_kernel_sizes=(3,), conv_dim_reductions=(0.5,),
                    use_tanh_out=False, use_embedding=False)
    return (jconv.ConvEncoderOnlyTransformer(**common, **conv),
            tconv.ConvEncoderOnlyTransformer(**common, **conv))


@pytest.mark.parametrize("name", ["enc-only", "conv-enc", "conv-enc-noemb"])
def test_model_matches_frozen_golden(name):
    z = np.load(os.path.join(GOLDEN_DIR, f"model_parity_{name}.npz"))
    _, model = model_pair(name)
    port(model, params_from_flat_keys(z))
    with torch.no_grad():
        close(model(torch.from_numpy(z["ids"])), z["expected"])


@pytest.mark.parametrize("name", ["enc-only", "conv-enc", "conv-enc-noemb"])
def test_model_matches_jax_on_fresh_params(name):
    """Freshly initialised flax params, with a random output head: the
    zero-initialised head would hide every fault in the trunk."""
    fmodel, tmodel = model_pair(name)
    ids = ids_with_padding(seed=5)
    params = to_numpy(fmodel.init(jax.random.PRNGKey(4), jnp.asarray(ids)))
    head = params["params"]["AngleProjection_0"]["output_projection"]
    head["kernel"] = np.random.default_rng(6).normal(
        0, 0.3, head["kernel"].shape).astype(np.float32)
    want = fmodel.apply(params, jnp.asarray(ids), deterministic=True)
    port(tmodel, params)
    with torch.no_grad():
        close(tmodel(torch.from_numpy(ids)), want)


def test_bridge_rejects_unmatched_and_misshaped_params():
    fmodel, tmodel = model_pair("enc-only")
    params = to_numpy(fmodel.init(jax.random.PRNGKey(0),
                                  jnp.asarray(ids_with_padding())))
    flax_to_state_dict(params, tmodel)  # complete tree maps cleanly
    inner = params["params"]["Encoder_0"]
    dropped = dict(params["params"], Encoder_0={
        k: v for k, v in inner.items() if k != "EncoderLayer_1"})
    with pytest.raises(KeyError, match="no flax counterpart"):
        flax_to_state_dict(dropped, tmodel)
    extra = dict(params["params"], Extra_0={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="Extra_0"):
        flax_to_state_dict(extra, tmodel)
    bad = to_numpy(params)
    bad["params"]["AngleProjection_0"]["output_projection"]["kernel"] = \
        np.zeros((DM + 1, 24), np.float32)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(bad, tmodel)


def test_factory_and_conv_name_parsing():
    assert parse_conv_kernel_info_from_model_name("conv-enc|21,11,3|1,1,1") \
        == ([21, 11, 3], [1.0, 1.0, 1.0])
    assert parse_conv_kernel_info_from_model_name("conv-enc") == ([], [])
    cfg = TrainConfig(model="conv-enc|5,3|2,2", d_model=DM, d_ff=DFF,
                      n_heads=NH, n_layers=1, max_seq_len=L).finalize()
    assert (cfg.model, cfg.conv1_size, cfg.conv2_reduc) == ("conv-enc", 5, 2.0)
    model = make_model(cfg, angle_means())
    assert [c.kernel_size[0] for c in model.convs] == [5, 3]
    lin = make_model(TrainConfig(model="enc-only-linear-out", d_model=DM,
                                 n_heads=NH, max_seq_len=L), angle_means())
    assert not lin.head.use_tanh_out
    enc_dec = make_model(TrainConfig(model="enc-dec", d_model=DM, d_ff=DFF,
                                     n_heads=NH, n_layers=2, max_seq_len=L),
                         angle_means())
    assert len(enc_dec.encoder.layers) == len(enc_dec.decoder.layers) == 2
    with pytest.raises(ValueError, match="Unknown model architecture"):
        make_model(TrainConfig(model="dec-only"), angle_means())
