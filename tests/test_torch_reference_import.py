"""The port's import of the original reference's checkpoints
(``models/torch_import.py``) against the JAX package's (same name).

The reference state_dicts are made here from flax parameters with the JAX
module's own names (``_torch_key_for``) and the inverse of its layouts, so
the JAX function is the independent source of the names. Each holds one
entry the models do not own, a positional-encoding buffer, as a reference
checkpoint does. Gate: the model-forward bound, atol 2e-5 with rtol 1e-4.
The encoder goldens' output heads are zero, so their forwards cannot see
the trunk: the fresh parameters at asymmetric widths, with a random head,
are what hold every trunk weight's name and layout.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_transformer_tpu.models import conv_encoder as jconv
from protein_transformer_tpu.models import enc_dec as jed
from protein_transformer_tpu.models import encoder_only as jenc
from protein_transformer_tpu.models import torch_import as jti
from protein_transformer_tpu.protein.vocab import VOCAB
from protein_transformer_tpu_torch.models import conv_encoder as tconv
from protein_transformer_tpu_torch.models import enc_dec as ted
from protein_transformer_tpu_torch.models import encoder_only as tenc
from protein_transformer_tpu_torch.models import torch_import as tti
from protein_transformer_tpu_torch.models.flax_import import (
    params_from_flat_keys)

from test_torch_models import angle_means, ids_with_padding
from test_torch_models import model_pair as encoder_pair

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FAMILIES = ["enc-only", "conv-enc", "conv-enc-noemb", "enc-dec"]
B, L, DM, DFF, NH, NL = 2, 12, 32, 64, 2, 2
ATOL, RTOL = 2e-5, 1e-4
PE_BUFFER = "encoder.pos_enc.pe"


def enc_dec_pair(d_model=DM, d_ff=DFF, n_heads=NH, n_layers=NL, length=L):
    common = dict(n_enc_layers=n_layers, n_dec_layers=n_layers,
                  n_heads=n_heads, d_model=d_model, d_ff=d_ff, max_len=length,
                  vocab_size=len(VOCAB), pad_id=VOCAB.pad_id, dropout=0.1)
    am = angle_means()
    return (jed.Transformer(angle_means=tuple(am), **common),
            ted.Transformer(angle_means=am, **common))


def model_pair(name):
    return enc_dec_pair() if name == "enc-dec" else encoder_pair(name)


def reference_state_dict(params) -> dict:
    """A reference state_dict of a flax params tree: the JAX module's keys,
    its layouts inverted (Dense (in, out) -> Linear (out, in), Conv (k, in,
    out) -> Conv1d (out, in, k)), and a positional-encoding buffer that no
    model here owns."""
    sd = {}

    def put(path, leaf):
        key, transpose = jti._torch_key_for(path)
        arr = np.asarray(leaf, np.float32)
        if transpose == "conv" and arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        elif transpose and arr.ndim == 2:
            arr = arr.T
        sd[key] = torch.from_numpy(np.array(arr))

    jax.tree_util.tree_map_with_path(put, {"params": params})
    sd[PE_BUFFER] = torch.randn(1, L, DM)
    return sd


@functools.lru_cache(maxsize=None)
def golden(name):
    """(the golden's arrays, its flax params), read once per family."""
    with np.load(os.path.join(GOLDEN_DIR,
                              f"model_parity_{name}.npz")) as f:
        z = dict(f)
    return z, params_from_flat_keys(z)["params"]


@functools.lru_cache(maxsize=None)
def golden_state_dict(name):
    """The reference state_dict of a golden's params, built once per family
    (the tests only read it)."""
    return reference_state_dict(golden(name)[1])


def forward(name, model, ids, ang):
    with torch.no_grad():
        if name == "enc-dec":
            return model.eval()(torch.from_numpy(ids).long(),
                                torch.from_numpy(ang))
        return model.eval()(torch.from_numpy(ids))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_golden_loads_through_the_reference_route(name):
    z, _ = golden(name)
    sd = golden_state_dict(name)
    _, model = model_pair(name)
    assert tti.state_dict_to_port(sd, model) is model
    close(forward(name, model, z["ids"], z["ang"]), z["expected"])


@pytest.mark.parametrize("name", FAMILIES)
def test_jax_importer_gives_back_the_golden_params(name):
    _, params = golden(name)
    sd = golden_state_dict(name)
    back = jti.state_dict_to_flax(sd, {"params": params})["params"]
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        assert np.array_equal(leaf, flat_want[path]), path


@pytest.mark.parametrize("name", FAMILIES)
def test_every_port_parameter_has_the_jax_modules_key(name):
    """The port's map (flax_names composed with its copy of the rules) gives
    each parameter the key the JAX module gives its flax path, and the
    reference keys of a state_dict are exactly those plus the buffer."""
    sd = golden_state_dict(name)
    _, model = model_pair(name)
    keys = tti.reference_names(model)
    assert set(keys) == {n for n, _ in model.named_parameters()}
    assert set(keys.values()) == set(sd) - {PE_BUFFER}


def asymmetric_case(name, seed=4):
    """(port module, fresh flax params, ids, angles, the flax forward) at
    d_model 24, d_ff 40, three heads and a random output head: every Linear
    and Conv1d weight but the attention's is not square."""
    dm, dff, nh = 24, 40, 3
    if name == "enc-dec":
        fmodel, tmodel = enc_dec_pair(dm, dff, nh)
    else:
        common = dict(n_layers=NL, n_heads=nh, d_model=dm, d_ff=dff,
                      max_len=L, vocab_size=len(VOCAB),
                      angle_means=angle_means(), dropout=0.1,
                      pad_id=VOCAB.pad_id)
        if name == "enc-only":
            fmodel = jenc.EncoderOnlyTransformer(**common)
            tmodel = tenc.EncoderOnlyTransformer(**common)
        else:
            conv = dict(conv_kernel_sizes=(5, 3),
                        conv_dim_reductions=(1.5, 0.75), use_embedding=True)
            if name == "conv-enc-noemb":
                conv = dict(conv_kernel_sizes=(3,),
                            conv_dim_reductions=(0.5,), use_embedding=False)
            fmodel = jconv.ConvEncoderOnlyTransformer(**common, **conv)
            tmodel = tconv.ConvEncoderOnlyTransformer(**common, **conv)
    ids = ids_with_padding(seed=seed)
    ang = np.random.default_rng(seed).uniform(-0.9, 0.9, (B, L, 24)).astype(
        np.float32)
    args = (jnp.asarray(ids),) + ((jnp.asarray(ang),) if name == "enc-dec"
                                  else ())
    params = jax.tree_util.tree_map(np.asarray, fmodel.init(
        {k: jax.random.PRNGKey(i) for i, k in
         enumerate(("params", "dropout", "sampling"))}, *args))["params"]
    head = (params["output_projection"] if name == "enc-dec"
            else params["AngleProjection_0"]["output_projection"])
    head["kernel"] = np.random.default_rng(seed + 1).normal(
        0, 0.05, head["kernel"].shape).astype(np.float32)
    want = fmodel.apply({"params": params}, *args, deterministic=True)
    return tmodel, params, ids, ang, want


@pytest.mark.parametrize("name", FAMILIES)
def test_asymmetric_widths_match_the_jax_forward(name):
    tmodel, params, ids, ang, want = asymmetric_case(name)
    tti.state_dict_to_port(reference_state_dict(params), tmodel)
    close(forward(name, tmodel, ids, ang), want)


def test_missing_and_misshaped_tensors_raise():
    _, model = model_pair("enc-only")
    sd = golden_state_dict("enc-only")
    missing = {k: v for k, v in sd.items()
               if k != "encoder.enc_layers.1.pwff.layer2.weight"}
    with pytest.raises(KeyError, match=r"encoder\.enc_layers\.1\.pwff\."
                       r"layer2\.weight.*encoder\.layers\.1\.ff\.w_2\."
                       r"weight"):
        tti.state_dict_to_port(missing, model)
    # a transposed (in, out) weight, as a flax kernel would be laid out
    bad = dict(sd)
    bad["encoder.enc_layers.0.pwff.layer1.weight"] = \
        sd["encoder.enc_layers.0.pwff.layer1.weight"].T
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        tti.state_dict_to_port(bad, model)
    # nothing is written before every tensor has been checked
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())


@pytest.mark.parametrize("payload", ["checkpoint", "bare"])
def test_file_route(tmp_path, payload):
    z, _ = golden("conv-enc")
    sd = golden_state_dict("conv-enc")
    path = tmp_path / "model.chkpt"
    # the reference's train.py payload, or a bare state_dict
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {},
                "epoch": 3, "loss": 1.5} if payload == "checkpoint" else sd,
               path)
    _, model = model_pair("conv-enc")
    assert tti.load_reference_checkpoint(str(path), model) is model
    close(forward("conv-enc", model, z["ids"], z["ang"]), z["expected"])
