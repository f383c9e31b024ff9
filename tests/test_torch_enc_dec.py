"""The port's encoder-decoder model family against the JAX package's.

* the frozen golden ``model_parity_enc-dec.npz`` through the flax bridge
  (the repo's model-forward gate: atol 2e-5 with rtol 1e-4);
* teacher forcing, ``predict()`` and the scheduled-sampling path with both
  fractions 0 (every step feeds the prediction back, so no draw matters)
  against the JAX model from the same weights, with padded ids and missing
  (NaN) targets, same gate;
* causality, the decoder's attention staying off the flash path, where the
  sampling draws come from, and the factory;
* one training step's loss and gradients against the JAX trainer at dropout
  0, under the MSE and the combined loss, with the gates of
  tests/test_torch_train.py;
* the slice as a whole: the JAX CLI trains a tiny enc-dec run on the CPU,
  the run is exported and imported, and both ``predict`` entry points write
  the same structures (coordinates within 2e-3 A, as
  tests/test_torch_predict.py holds the encoder models).

The port side runs on the CPU and never imports JAX: only this file does.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_transformer_tpu.config import TrainConfig as JConfig
from protein_transformer_tpu.data.dataset import collate as jcollate
from protein_transformer_tpu.models import enc_dec as jed
from protein_transformer_tpu.protein.vocab import VOCAB
from protein_transformer_tpu.training.trainer import (
    Trainer as JTrainer, compute_losses as jcompute_losses)
from protein_transformer_tpu_torch import predict as tpredict
from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data import synthetic as tsyn
from protein_transformer_tpu_torch.data.dataset import collate
from protein_transformer_tpu_torch.models import enc_dec as ted
from protein_transformer_tpu_torch.models import transformer as ttr
from protein_transformer_tpu_torch.models.factory import (
    make_model, model_args)
from protein_transformer_tpu_torch.models.flax_import import (
    flax_to_state_dict, load_flax_params, params_from_flat_keys)
from protein_transformer_tpu_torch.ops import attention as A
from protein_transformer_tpu_torch.protein import pdb as tpdb
from protein_transformer_tpu_torch.training import checkpoint as tckpt
from protein_transformer_tpu_torch.training import cli as tcli
from protein_transformer_tpu_torch.training.trainer import Trainer

from test_torch_train import NOISE_ONLY, device_batch, first_rows, flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "model_parity_enc-dec.npz")
CPU = torch.device("cpu")
B, L, DM, DFF, NH, NL = 2, 12, 32, 64, 2, 2
ATOL, RTOL = 2e-5, 1e-4
SLICE = dict(model="enc-dec", d_model=32, d_ff=64, n_heads=2, n_layers=2,
             batch_size=4, dropout=0.0, bucket_sizes=(48,), max_seq_len=48,
             optimizer="adam", lr_scheduling="noam", n_warmup_steps=20,
             log_structure_step=0, log_val_struct_step=0)


def angle_means(seed=1):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, 24).astype(
        np.float32)


def model_pair(**kw):
    common = dict(n_enc_layers=NL, n_dec_layers=NL, n_heads=NH, d_model=DM,
                  d_ff=DFF, max_len=L, vocab_size=len(VOCAB),
                  pad_id=VOCAB.pad_id, **{"dropout": 0.1, **kw})
    am = angle_means()
    return (jed.Transformer(angle_means=tuple(am), **common),
            ted.Transformer(angle_means=am, **common))


def inputs(seed=0):
    """Ids with padding in one row, and targets with a missing residue."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 20, (B, L)).astype(np.int32)
    ids[0, -3:] = VOCAB.pad_id
    tgt = rng.uniform(-0.9, 0.9, (B, L, 24)).astype(np.float32)
    tgt[1, 4] = np.nan
    return ids, tgt


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def fresh():
    """Freshly initialised flax params with a random output projection (the
    tiny-gain one would hide the trunk), loaded into both models. Its
    standard deviation of 0.05 keeps the tanh out of saturation: the
    autoregressive paths feed outputs back L - 1 times, and a loop through
    saturated units multiplies the packages' fp32 differences step by step
    (1.8e-4 at a standard deviation of 0.3)."""
    fmodel, tmodel = model_pair()
    ids, tgt = inputs()
    params = jax.tree_util.tree_map(np.asarray, fmodel.init(
        {k: jax.random.PRNGKey(i) for i, k in
         enumerate(("params", "dropout", "sampling"))},
        jnp.asarray(ids), jnp.asarray(np.nan_to_num(tgt))))
    head = params["params"]["output_projection"]
    assert np.abs(head["kernel"]).max() < 1e-4  # the tiny-gain Xavier weight
    head["kernel"] = np.random.default_rng(6).normal(
        0, 0.05, head["kernel"].shape).astype(np.float32)
    load_flax_params(tmodel, params)
    return fmodel, tmodel.eval(), params


def test_model_matches_frozen_golden():
    z = np.load(GOLDEN)
    _, model = model_pair()
    load_flax_params(model, params_from_flat_keys(z))
    with torch.no_grad():
        close(model.eval()(torch.from_numpy(z["ids"]).long(),
                           torch.from_numpy(z["ang"])), z["expected"])


def test_teacher_forcing_matches_jax(fresh):
    fmodel, tmodel, params = fresh
    ids, tgt = inputs(seed=5)
    want = fmodel.apply(params, jnp.asarray(ids), jnp.asarray(tgt))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(tgt))
        again = tmodel.forward_tf(torch.from_numpy(ids).long(),
                                  torch.from_numpy(tgt))
    assert got.shape == (B, L, 24) and torch.equal(got, again)
    close(got, want)


def test_predict_matches_jax(fresh):
    fmodel, tmodel, params = fresh
    ids, _ = inputs(seed=7)
    want = jax.jit(lambda p, i: fmodel.apply(
        p, i, method=fmodel.predict))(params, jnp.asarray(ids))
    tmodel.train()
    got = tmodel.predict(torch.from_numpy(ids).long())
    assert tmodel.training and not got.requires_grad
    tmodel.eval()
    close(got, want)


def test_fully_sampled_path_matches_jax(fresh):
    """Both fractions 0: full teacher forcing is never chosen, and every
    timestep feeds the model's prediction back, whatever is drawn. Train
    mode (the sampled path's), at dropout 0."""
    _, _, params = fresh
    fmodel, tmodel = model_pair(fraction_complete_tf=0.0,
                                fraction_subseq_tf=0.0, dropout=0.0)
    load_flax_params(tmodel, params)
    tmodel.train().sampling_generator = torch.Generator().manual_seed(3)
    ids, tgt = inputs(seed=8)
    want = jax.jit(lambda p, i, t: fmodel.apply(
        p, i, t, deterministic=False,
        rngs={"sampling": jax.random.PRNGKey(0),
              "dropout": jax.random.PRNGKey(1)}))(
            params, jnp.asarray(ids), jnp.asarray(tgt))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(tgt))
    close(got, want)
    # the first position sees only the start row; later ones differ from
    # teacher forcing, since they see predictions and not targets
    with torch.no_grad():
        forced = tmodel.forward_tf(torch.from_numpy(ids).long(),
                                   torch.from_numpy(tgt))
    assert torch.allclose(got[:, 0], forced[:, 0], atol=1e-6)
    assert float((got[:, 2:] - forced[:, 2:]).abs().max()) > 1e-3


def test_output_does_not_see_targets_at_or_after_its_position(fresh):
    _, tmodel, _ = fresh
    ids, tgt = inputs(seed=9)
    tgt = np.nan_to_num(tgt)
    tgt2 = tgt.copy()
    tgt2[:, 7:] = 0.123
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(tgt))
        out2 = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(tgt2))
    # the input is shifted right: output t sees targets < t
    np.testing.assert_allclose(out[:, :8].numpy(), out2[:, :8].numpy(),
                               atol=1e-6)
    assert float((out[:, 8:] - out2[:, 8:]).abs().max()) > 1e-4


def test_flash_reaches_the_encoder_only(fresh, monkeypatch):
    """Causal and cross attention materialise their probabilities; with
    attn_impl flash the encoder's layers, and only they, go through
    ops/attention.py, and the output is the xla model's."""
    _, tmodel, params = fresh
    _, flash = model_pair(attn_impl="flash")
    load_flax_params(flash, params)
    calls = []
    plain = A.flash_self_attention_torch
    monkeypatch.setattr(A, "flash_self_attention_torch",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    ids, tgt = inputs(seed=10)
    with torch.no_grad():
        got = flash.eval()(torch.from_numpy(ids).long(),
                           torch.from_numpy(tgt))
        want = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(tgt))
    assert len(calls) == NL
    assert all(isinstance(m, ttr.MultiHeadedAttention) and m.impl == "xla"
               for layer in flash.decoder.layers
               for m in (layer.attn, layer.cross_attn))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_sampling_draws_come_from_the_models_generator(fresh):
    _, _, params = fresh
    _, tmodel = model_pair(fraction_complete_tf=0.5, fraction_subseq_tf=0.5,
                           dropout=0.0)
    load_flax_params(tmodel, params)
    ids, tgt = (torch.from_numpy(x) for x in inputs(seed=11))
    ids = ids.long()
    with torch.no_grad():
        forced = tmodel.forward_tf(ids, tgt)
        # eval mode is teacher forcing, and draws nothing
        assert torch.equal(tmodel.eval()(ids, tgt), forced)
    tmodel.train()
    with pytest.raises(RuntimeError, match="needs a generator"):
        tmodel(ids, tgt)

    def outputs(seed, n=6):
        tmodel.sampling_generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return [tmodel(ids, tgt) for _ in range(n)]

    torch.manual_seed(123)
    global_state = torch.random.get_rng_state()
    first = outputs(0)
    assert torch.equal(torch.random.get_rng_state(), global_state)
    assert all(torch.equal(a, b) for a, b in zip(first, outputs(0)))
    # over six calls both branches are drawn: full teacher forcing, and a
    # sampled pass that differs from it
    same = [torch.equal(out, forced) for out in first]
    assert any(same) and not all(same)
    # gradients flow through the fed predictions
    tmodel.fraction_complete_tf = 0.0
    tmodel.sampling_generator = torch.Generator().manual_seed(1)
    out = tmodel(ids, tgt)
    out.sum().backward()
    assert float(tmodel.decoder.embed.weight.grad.abs().max()) > 0


def test_factory_config_and_trainer_wiring(tmp_path):
    cfg = TConfig(model="enc-dec", d_model=DM, d_ff=DFF, n_heads=NH,
                  n_layers=3, max_seq_len=L, fraction_complete_tf=0.25,
                  fraction_subseq_tf=0.75).finalize()
    assert cfg.add_sos_eos and not TConfig().finalize().add_sos_eos
    jcfg = JConfig(model="enc-dec").finalize()
    assert jcfg.add_sos_eos
    model = make_model(cfg, angle_means())
    assert isinstance(model, ted.Transformer)
    assert len(model.encoder.layers) == len(model.decoder.layers) == 3
    assert (model.fraction_complete_tf, model.fraction_subseq_tf) == (0.25,
                                                                      0.75)
    np.testing.assert_array_equal(
        model.output_projection.bias.detach().numpy(), angle_means())
    assert 0 < float(model.output_projection.weight.detach().abs().max()) \
        < 1e-4
    seq, ang = object(), object()
    assert model_args(model, seq, ang) == (seq, ang)
    assert model_args(make_model(TConfig(d_model=DM, n_heads=NH,
                                         max_seq_len=L), angle_means()),
                      seq, ang) == (seq,)
    # the trainer owns the sampling generator, seeded apart from dropout's
    data = tsyn.make_dataset(n_train=4, n_eval=1, min_len=20, max_len=30,
                             seed=0)
    tr = Trainer(TConfig(**{**SLICE, "out_dir": str(tmp_path), "name": "w",
                            "seed": 5}), device=CPU, data=data)
    assert tr.model.sampling_generator is tr.sampling_generator
    assert tr.sampling_generator is not tr.dropout_generator
    assert tr.sampling_generator.initial_seed() \
        != tr.dropout_generator.initial_seed() == 5
    params = tr.init_params(torch.Generator().manual_seed(0))
    assert 0 < float(params["output_projection.weight"].abs().max()) < 1e-4
    assert torch.equal(params["output_projection.bias"],
                       tr.model.output_projection.bias.detach())
    assert not params["decoder.embed.bias"].any()
    assert float(params["decoder.embed.weight"].abs().max()) > 0.1


# ------------------------------------------------- one training step

@pytest.fixture(scope="module")
def data():
    return tsyn.make_dataset(n_train=8, n_eval=2, min_len=30, max_len=44,
                             seed=0)


@pytest.fixture(scope="module", params=["mse", "combined"])
def ab(request, data, tmp_path_factory):
    """The JAX package's loss and gradients on one batch from random
    weights, and the port's trainer with the same weights."""
    loss = request.param
    out = tmp_path_factory.mktemp("ab")
    jtr = JTrainer(JConfig(**SLICE, loss=loss, name="j", out_dir=str(out)),
                   data=data, use_mesh=False)
    jbatch = first_rows(jtr.dm, jcollate)
    params = flax_params(jtr, jbatch)
    head = params["params"]["output_projection"]
    head["kernel"] = np.random.default_rng(1).normal(
        0, 0.3, head["kernel"].shape).astype(np.float32)
    dev = device_batch(jbatch)
    want_loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jcompute_losses(jtr.model, p, dev, jtr.cfg)[0]))(params)
    tr = Trainer(TConfig(**SLICE, loss=loss, name="t", out_dir=str(out)),
                 device=CPU, data=data)
    as_port = lambda tree: flax_to_state_dict(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), tr.model)
    return dict(trainer=tr, params=as_port(params), loss=float(want_loss),
                grads=as_port(grads), jbatch=jbatch)


def test_one_step_loss_and_gradients_match_jax(ab):
    """The gates of tests/test_torch_train.py: loss within 1e-5 relative;
    each parameter's gradient within 1e-3 of its largest JAX entry, the
    attention key biases (exact gradient zero, fp32 noise on both sides)
    within 1e-6 of the model's largest gradient."""
    tr = ab["trainer"]
    batch = first_rows(tr.dm, collate)
    np.testing.assert_array_equal(batch.ang, ab["jbatch"].ang)
    state = tr.state_from(ab["params"])
    loss, _, grads = tr.loss_and_grads(state.params, batch.to(CPU))
    assert abs(float(loss.detach()) - ab["loss"]) <= 1e-5 * abs(ab["loss"])
    top = max(float(g.abs().max()) for g in ab["grads"].values())
    assert any(name.startswith("decoder.") for name in state.params)
    for name, g in zip(state.params, grads):
        want = ab["grads"][name]
        scale = (1e-3 * top if name.endswith(NOISE_ONLY)
                 else float(want.abs().max()))
        assert float((g - want).abs().max()) <= 1e-3 * scale, name
    # the optimizer then moves every parameter of the decoder
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, out = tr.train_step(state, batch)
    assert np.isfinite(float(out[0])) and state.step == 1
    assert not torch.equal(before["decoder.layers.1.cross_attn.wq.weight"],
                           state.params["decoder.layers.1.cross_attn"
                                        ".wq.weight"].detach())


# ---------------------------------------------------------- the slice

MODEL_ARGS = ["-m", "enc-dec", "-dm", "32", "-dih", "64", "-nh", "2", "-nl",
              "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX enc-dec run trained by the JAX CLI, its export, and the JAX
    predict's files for the test split."""
    from protein_transformer_tpu import predict as jpredict
    from protein_transformer_tpu.training import cli as jcli
    root = tmp_path_factory.mktemp("encdec")
    data_path = str(root / "data.pt")
    torch.save(tsyn.make_dataset(n_train=12, n_eval=5, min_len=20,
                                 max_len=48, seed=3), data_path)
    jcli.main(["--data", data_path, "--name", "jrun", "--out_dir", str(root),
               *MODEL_ARGS, "-e", "2", "-b", "4", "-l", "mse", "-opt",
               "adam", "-lr", "0.01", "--train_only", "--log_structure_step",
               "0", "-lvs", "0", "--cluster", "True"])
    spec = importlib.util.spec_from_file_location(
        "export_checkpoint_npz",
        os.path.join(ROOT, "ptt_scripts", "export_checkpoint_npz.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    exported = str(root / "exported")
    export.main([str(root / "jrun"), exported])
    jax_out = str(root / "jax_preds")
    jpredict.main([str(root / "jrun"), "--data", data_path, "--split",
                   "test", "--n", "5", "--out", jax_out, "--batch", "4"])
    jax_files = sorted(os.path.join(jax_out, f) for f in os.listdir(jax_out))
    return {"root": root, "data": data_path, "exported": exported,
            "jax_files": jax_files}


def test_predict_matches_jax_predict_from_an_exported_enc_dec_run(runs):
    run_dir = tckpt.import_run(runs["exported"], str(runs["root"] / "port"))
    cfg, model = tpredict.load_run(run_dir, device="cpu")
    assert cfg.model == "enc-dec" and isinstance(model, ted.Transformer)
    assert not model.training
    out = str(runs["root"] / "preds")
    paths = tpredict.main([run_dir, "--data", runs["data"], "--split", "test",
                           "--n", "5", "--out", out, "--batch", "4",
                           "--device", "cpu"])
    assert sorted(map(os.path.basename, paths)) \
        == sorted(map(os.path.basename, runs["jax_files"]))
    worst = 0.0
    for path in runs["jax_files"]:
        name = os.path.basename(path)
        ours = tpdb.parse_pdb_atoms(os.path.join(out, name))
        theirs = tpdb.parse_pdb_atoms(path)
        assert ours[:3] == theirs[:3], name
        if name.endswith("_true.pdb"):
            assert np.array_equal(ours[3], theirs[3])
        else:
            assert len(ours[3]) > 20 * 4
            worst = max(worst, float(np.abs(ours[3] - theirs[3]).max()))
    assert worst <= 2e-3, f"pred coordinates differ by {worst:.3e} A"


def test_cli_trains_an_enc_dec_run_with_scheduled_sampling(runs, tmp_path):
    """The port's own CLI on the CPU: one epoch of teacher forcing, then a
    resumed epoch with scheduled sampling, then predict from the run."""
    argv = ["--data", runs["data"], "--name", "trun", "--out_dir",
            str(tmp_path), *MODEL_ARGS, "-b", "4", "-l", "combined", "-opt",
            "adam", "--lr_scheduling", "noam", "-do", "0.1", "--cluster",
            "True", "--log_structure_step", "0", "-lvs", "0", "--device",
            "cpu"]
    state = tcli.main(argv + ["-e", "1"])
    assert state.step > 0
    resumed = tcli.main(argv + ["-e", "2", "-fctf", "0.5", "-fsstf", "0.5"])
    assert resumed.step == 2 * state.step
    run_dir = str(tmp_path / "trun")
    paths = tpredict.predict_structures(run_dir, runs["data"], "valid-10",
                                        n=2, out_dir=str(tmp_path / "p"),
                                        batch_size=2, device="cpu")
    assert len(paths) == 4
    for path in paths:
        xyz = tpdb.parse_pdb_atoms(path)[3]
        assert len(xyz) > 20 and np.isfinite(xyz).all()
