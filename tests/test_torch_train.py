"""The port's training slice against the JAX package and the frozen goldens.

* optimizer: ``noam_schedule`` and ``make_optimizer`` reproduce
  tests/golden/optim_trajectory.npz (120 steps of an encoder-only d32
  model, the set-up of tests/test_optim_trajectory.py) within that test's
  atol 1e-5, rtol 1e-4;
* dRMSD trajectory: 30 steps under ``grad_semantics="reference"`` reproduce
  tests/golden/drmsd_trajectory.npz within 1e-4;
* one step and five steps of the conv-enc slice against the JAX trainer,
  from the same weights on the same batch, under both gradient semantics
  (tolerances at the tests);
* the binned sampler draws the JAX package's index batches;
* dropout masks come from the trainer's generator; the NaN watchdog raises.

The port side runs on the CPU with the dRMSD kernels' plain versions, and
never imports JAX: only this test file does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from protein_transformer_tpu.config import TrainConfig as JConfig
from protein_transformer_tpu.data.dataset import (
    DataModule as JDataModule, collate as jcollate)
from protein_transformer_tpu.protein.vocab import VOCAB
from protein_transformer_tpu.training import optim as joptim
from protein_transformer_tpu.training.trainer import (
    Trainer as JTrainer, compute_losses as jcompute_losses)
from protein_transformer_tpu_torch import losses as TL
from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data import synthetic as tsyn
from protein_transformer_tpu_torch.data.dataset import (
    BinnedDataset, DataModule, collate)
from protein_transformer_tpu_torch.models.encoder_only import (
    EncoderOnlyTransformer)
from protein_transformer_tpu_torch.models.flax_import import (
    flax_to_state_dict, params_from_flat_keys)
from protein_transformer_tpu_torch.training import optim as toptim
from protein_transformer_tpu_torch.training.trainer import (
    Trainer, compute_losses)

from test_optim_trajectory import (
    B as TRAJ_B, CASES, CLIP, DM, DFF, DRMSD_CASES, GOLDEN, GOLDEN_DRMSD,
    LR, N_STEPS, N_STEPS_D, N_WARMUP, NH, NL, SEQ_LEN, _DLEN, angle_means,
    make_stream)

CPU = torch.device("cpu")
SLICE = dict(model="conv-enc|5,3|1,1", d_model=32, d_ff=64, n_heads=2,
             n_layers=2, batch_size=4, loss="combined", dropout=0.0,
             bucket_sizes=(48,), max_seq_len=48, optimizer="adam",
             lr_scheduling="noam", n_warmup_steps=20)


@pytest.fixture(scope="module")
def data():
    return tsyn.make_dataset(n_train=8, n_eval=2, min_len=30, max_len=44,
                             seed=0)


def encoder_only(max_len):
    return EncoderOnlyTransformer(
        n_layers=NL, n_heads=NH, d_model=DM, d_ff=DFF, max_len=max_len,
        vocab_size=len(VOCAB), angle_means=angle_means(), dropout=0.0,
        pad_id=VOCAB.pad_id)


def golden_params(path, model):
    return {k: v.requires_grad_() for k, v in flax_to_state_dict(
        params_from_flat_keys(np.load(path)), model).items()}


def train_steps(model, params, tx, loss_of, batches):
    """The port's update loop on explicit batches; the per-step losses."""
    state = tx.init(params)
    losses = []
    for batch in batches:
        loss = loss_of(model, params, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        state = tx.update(params, grads, state)
        losses.append(float(loss.detach()))
    return np.array(losses)


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_matches_frozen_golden(name):
    """Measured largest gap on the CPU: 2.7e-7 (adam_noam), 3.9e-7
    (sgd_plateau)."""
    case = CASES[name]
    model = encoder_only(SEQ_LEN)
    params = golden_params(GOLDEN, model)
    lr = (toptim.noam_schedule(DM, N_WARMUP) if case["scheduling"] == "noam"
          else LR)
    tx = toptim.make_optimizer(case["optimizer"], lr, case["weight_decay"],
                               CLIP)
    ids, ang = make_stream()

    def loss_of(model, params, i):
        pred = functional_call(model, params, (torch.from_numpy(ids[i]),))
        tgt = torch.from_numpy(ang[i])
        return TL.mse_over_angles(pred, tgt, torch.ones_like(tgt,
                                                             dtype=bool))

    ours = train_steps(model, params, tx, loss_of, range(N_STEPS))
    np.testing.assert_allclose(ours, np.load(GOLDEN)[f"loss_{name}"],
                               atol=1e-5, rtol=1e-4)


def drmsd_stream(min_len, max_len):
    """tests/test_optim_trajectory.make_drmsd_stream with the port's own
    synthetic data and collation."""
    tr = tsyn.make_dataset(n_train=TRAJ_B * N_STEPS_D, n_eval=1,
                           min_len=min_len, max_len=max_len, seed=5)["train"]
    split = BinnedDataset(tr["seq"], tr["ang"], tr["crd"],
                          max_seq_len=max_len)
    return [collate(split, np.arange(TRAJ_B * i, TRAJ_B * (i + 1)),
                    (max_len,), max_len).to(CPU) for i in range(N_STEPS_D)]


@pytest.mark.parametrize("name", list(DRMSD_CASES))
def test_drmsd_trajectory_matches_frozen_golden(name):
    """30 steps of the stitched (reference-semantics) dRMSD gradients with
    Adam, Noam, weight decay and clip, on the port's own synthetic data.
    Measured largest gap to the golden on the CPU: 5.8e-5 (lndrmsd),
    9.5e-5 (combined), 5.4e-7 (mse_padded)."""
    case = DRMSD_CASES[name]
    model = encoder_only(_DLEN)
    params = golden_params(GOLDEN_DRMSD, model)
    cfg = TConfig(loss=case["loss"], grad_semantics="reference", clip=CLIP,
                  optimizer="adam", lr_scheduling="noam",
                  n_warmup_steps=N_WARMUP, d_model=DM).finalize()
    tx = toptim.make_optimizer("adam", toptim.noam_schedule(DM, N_WARMUP),
                               True, CLIP)
    batches = drmsd_stream(case.get("min_len", _DLEN),
                           case.get("max_len", _DLEN))

    def loss_of(model, params, batch):
        return compute_losses(model, params, batch, cfg, impl="torch")[0]

    ours = train_steps(model, params, tx, loss_of, batches)
    np.testing.assert_allclose(ours, np.load(GOLDEN_DRMSD)[f"loss_{name}"],
                               atol=1e-4, rtol=1e-4)


def test_schedules_and_host_state_machines_match_jax():
    sched, jsched = toptim.noam_schedule(512, 100), joptim.noam_schedule(
        512, 100)
    for count in (0, 1, 50, 99, 100, 5000):
        assert sched(count) == jsched(count)
    plateau = toptim.PlateauState(patience=1, threshold=0.01)
    jplateau = joptim.PlateauState(patience=1, threshold=0.01)
    stop = toptim.EarlyStopping(patience=2, threshold=0.01)
    jstop = joptim.EarlyStopping(patience=2, threshold=0.01)
    for epoch, metric in enumerate((5.0, 4.0, 4.0, 3.99, 4.1, 4.2, 1.0)):
        assert plateau.step(metric) == jplateau.step(metric)
        assert stop.update(epoch, metric) == jstop.update(epoch, metric)
    assert plateau.state_dict() == jplateau.state_dict()
    assert stop.state_dict() == jstop.state_dict()
    for field in ("learning_rate", "n_warmup_steps", "clip", "lr_scheduling",
                  "patience", "early_stopping_threshold", "optimizer",
                  "seed", "grad_semantics", "weight_decay", "repeat_train",
                  "bins", "batching_order"):
        assert getattr(TConfig(), field) == getattr(JConfig(), field), field


def test_clip_is_optax_form():
    """Global-norm clip scales by clip / norm (no +1e-6), and only above
    the clip."""
    p = {"w": torch.zeros(4)}
    tx = toptim.make_optimizer("sgd", 1.0, False, 1.0)
    tx.update(p, [torch.tensor([3.0, 4.0, 0.0, 0.0])], tx.init(p))
    torch.testing.assert_close(p["w"], torch.tensor([-0.6, -0.8, 0, 0]),
                               rtol=0, atol=1e-7)
    p = {"w": torch.zeros(2)}
    tx.update(p, [torch.tensor([0.3, 0.4])], tx.init(p))
    assert torch.equal(p["w"], torch.tensor([-0.3, -0.4]))


@pytest.mark.parametrize("order,repeat", [("binned-random", 1),
                                          ("binned-random", 3),
                                          ("descending", 2)])
def test_sampler_matches_jax(data, order, repeat):
    kw = dict(batch_size=2, batching_order=order, repeat_train=repeat,
              bucket_sizes=(32, 48), max_seq_len=48)
    ours = DataModule(data, TConfig(**kw).finalize())
    theirs = JDataModule(data, JConfig(**kw).finalize())
    got = list(ours.train_index_batches(np.random.default_rng(7)))
    want = list(theirs.train_index_batches(np.random.default_rng(7)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    batch = next(ours.train_batches(np.random.default_rng(7)))
    jbatch = next(theirs.train_batches(np.random.default_rng(7)))
    for field in ("seq", "ang", "crd_mask", "protein_mask", "n_res"):
        np.testing.assert_array_equal(getattr(batch, field),
                                      getattr(jbatch, field))


def small_trainer(data, **kw):
    return Trainer(TConfig(**{**SLICE, **kw}), device=CPU, data=data)


def first_rows(dm, collate_fn, n=4):
    """A B=4 batch of the first training proteins (the residue-budget
    sampler would make B=64 batches at these lengths)."""
    return collate_fn(dm.train, np.arange(n), dm.cfg.bucket_sizes,
                      dm.max_seq_len)


def two_step_losses(trainer, batch):
    state = trainer.init_state(torch.Generator().manual_seed(0))
    head = state.params["head.output_projection.weight"]
    with torch.no_grad():
        head.normal_(0, 0.3, generator=torch.Generator().manual_seed(1))
    losses = []
    for _ in range(2):
        state, out = trainer.train_step(state, batch)
        losses.append(float(out[0]))
    return losses


def test_dropout_draws_from_the_trainers_generator(data):
    tr = small_trainer(data, dropout=0.3, seed=5)
    batch = first_rows(tr.dm, collate)
    torch.manual_seed(123)
    global_state = torch.random.get_rng_state()
    first = two_step_losses(tr, batch)
    assert torch.equal(torch.random.get_rng_state(), global_state)
    assert two_step_losses(small_trainer(data, dropout=0.3, seed=5),
                           batch) == first
    other = two_step_losses(small_trainer(data, dropout=0.3, seed=6), batch)
    assert other[0] != first[0]
    # dropout 0: the train-mode forward is the eval-mode forward
    tr0 = small_trainer(data, dropout=0.0)
    params = tr0.init_params(torch.Generator().manual_seed(0))
    seq = batch.to(CPU).seq
    train_out = functional_call(tr0.model.train(), params, (seq,))
    assert torch.equal(train_out,
                       functional_call(tr0.model.eval(), params, (seq,)))


def test_train_epoch_with_the_flagship_settings(data):
    """Combined loss, Adam, Noam, coupled decay and clip, dropout on, at
    small width: the epoch runs its batches, records them in windows, and
    the eval step afterwards puts the model back in eval mode."""
    tr = small_trainer(data, dropout=0.1, batch_size=1, repeat_train=5)
    tr.FLUSH_EVERY = 2
    state = tr.init_state(torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    n_batches = len(list(tr.dm.train_index_batches(
        np.random.default_rng(tr.cfg.seed))))
    assert n_batches >= 3
    state = tr.train_epoch(state)
    assert state.step == n_batches == tr.metrics["n_batches"]
    m = tr.metrics["train"]
    for key in ("epoch-combined-full", "epoch-drmsd-full", "epoch-mse-full"):
        assert np.isfinite(m[key]) and m[key] > 0, key
    assert tr.metrics["history-lr"][1:] == [tr.current_lr(i)
                                            for i in range(n_batches)]
    assert all(not torch.equal(before[k], state.params[k].detach())
               for k in ("convs.0.weight", "layers.1.ff.w_2.weight"))
    assert tr.model.training
    tr.eval_epoch(state.params, "test")
    assert not tr.model.training
    assert np.isfinite(tr.metrics["test"]["epoch-rmsd-full"])


def test_nan_watchdog_raises_after_recording_the_finite_rows(data):
    tr = small_trainer(data, loss="mse", optimizer="sgd",
                       lr_scheduling="plateau", learning_rate=1e9, clip=0.0,
                       batch_size=1, repeat_train=5)
    state = tr.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(FloatingPointError, match="A nan loss has occurred"):
        tr.train_epoch(state)
    # the blow-up update is step 0's: step 0 is recorded, step 1 is NaN
    assert tr.metrics["n_batches"] == 1
    assert tr.metrics["history-lr"] == [0.0, 1e9]


def flax_params(jtr, batch, seed=0):
    """Random weights in the JAX model's tree, drawn with numpy (the tree
    from jax.eval_shape, so nothing is compiled): fan-in-scaled normal
    kernels, unit norm scales, zero biases, a non-zero output head."""
    shapes = jax.eval_shape(
        jtr.model.init, {k: jax.random.PRNGKey(0)
                         for k in ("params", "dropout", "sampling")},
        jnp.asarray(batch.seq), jnp.asarray(batch.ang))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return np.ones(leaf.shape, np.float32)
        if name == "bias":
            return np.zeros(leaf.shape, np.float32)
        std = 0.3 if "AngleProjection_0" in str(path) else (
            1.0 if name == "embedding"
            else float(np.prod(leaf.shape[:-1])) ** -0.5)
        return rng.normal(0, std, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def device_batch(batch):
    return dataclasses.replace(batch, **{
        f.name: jnp.asarray(getattr(batch, f.name))
        for f in dataclasses.fields(batch)
        if hasattr(getattr(batch, f.name), "shape")})


def jax_trainer(data, out_dir, sem):
    return JTrainer(JConfig(**SLICE, grad_semantics=sem, name="ab",
                            out_dir=str(out_dir)), data=data, use_mesh=False)


@pytest.fixture(scope="module")
def jax_one_step(data, tmp_path_factory):
    """The JAX package's loss and gradients on one batch, from random
    weights: jax.value_and_grad over its compute_losses, for both gradient
    semantics in one compiled function."""
    out = tmp_path_factory.mktemp("ab")
    jtr = jax_trainer(data, out, "mean")
    ref_cfg = jax_trainer(data, out, "reference").cfg
    jbatch = first_rows(jtr.dm, jcollate)
    params, dev = flax_params(jtr, jbatch), device_batch(jbatch)

    def losses_and_grads(p):
        loss, g_mean = jax.value_and_grad(
            lambda q: jcompute_losses(jtr.model, q, dev, jtr.cfg)[0])(p)
        g_ref = jax.grad(
            lambda q: jcompute_losses(jtr.model, q, dev, ref_cfg)[0])(p)
        return loss, {"mean": g_mean, "reference": g_ref}

    loss, grads = jax.jit(losses_and_grads)(params)
    return dict(jbatch=jbatch, params=params, loss=float(loss), grads=grads)


@pytest.fixture(scope="module", params=["mean", "reference"])
def ab(request, data, jax_one_step, tmp_path_factory):
    """The port's trainer beside the JAX results under one gradient
    semantics, and five steps of the JAX _train_step_fn() from the same
    weights on the same batch."""
    sem = request.param
    jtr = jax_trainer(data, tmp_path_factory.mktemp("ab"), sem)
    params = jax_one_step["params"]
    dev = device_batch(jax_one_step["jbatch"])
    step = jtr._train_step_fn()
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = jtr.tx.init(p)
    step_no, losses = jnp.zeros((), jnp.int32), []
    for _ in range(5):
        p, opt_state, step_no, out, _ = step(p, opt_state, step_no, dev,
                                             jtr.rng, jnp.float32(1.0))
        losses.append(float(out[0]))
    tr = small_trainer(data, grad_semantics=sem)
    as_port = lambda tree: flax_to_state_dict(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), tr.model)
    return dict(trainer=tr, params=as_port(params),
                jbatch=jax_one_step["jbatch"], loss=jax_one_step["loss"],
                grads=as_port(jax_one_step["grads"][sem]), losses=losses,
                final=as_port(p))


def port_batch(ab):
    batch = first_rows(ab["trainer"].dm, collate)
    assert batch.seq.shape == (4, 44)
    for field in ("seq", "ang", "ang_mask", "crd", "crd_mask",
                  "protein_mask", "n_res"):
        np.testing.assert_array_equal(getattr(batch, field),
                                      getattr(ab["jbatch"], field))
    return batch


# The attention key bias has an exact gradient of zero (softmax ignores a
# constant per query), so both packages hold fp32 noise of ~1e-8 there.
NOISE_ONLY = ("attn.wk.bias",)


def test_one_step_loss_and_gradients_match_jax(ab):
    """Gates: loss within 1e-5 relative (measured 1.0e-7 on the CPU); each
    parameter's gradient within 1e-3 of its largest JAX entry (measured at
    most 1.2e-5), apart from the key biases, held to 1e-6 of the largest
    gradient of the model. The gap is fp32 summation order and the doubling
    scan of the port's NeRF against JAX's associative scan."""
    tr = ab["trainer"]
    state = tr.state_from(ab["params"])
    loss, _, grads = tr.loss_and_grads(state.params, port_batch(ab).to(CPU))
    assert abs(float(loss.detach()) - ab["loss"]) <= 1e-5 * abs(ab["loss"])
    top = max(float(g.abs().max()) for g in ab["grads"].values())
    for name, g in zip(state.params, grads):
        want = ab["grads"][name]
        scale = (1e-3 * top if name.endswith(NOISE_ONLY)
                 else float(want.abs().max()))
        assert float((g - want).abs().max()) <= 1e-3 * scale, name


def test_five_steps_match_jax_train_step(ab):
    """Trainer.train_step against the JAX _train_step_fn(): Adam, Noam,
    coupled decay, clip. Gates: per-step loss within 2e-5 relative
    (measured at most 1.5e-6 on the CPU); each parameter tensor's distance
    to JAX's final one within 2e-3 of its move over the five steps, in L2
    (measured at most 1.8e-4: Adam's per-element normalisation amplifies
    the gradients' fp32 differences). The key biases, whose gradient is
    fp32 noise that Adam turns into lr-sized steps of either sign
    (measured 5.5e-3 apart), are held only to twice the summed lr (5.9e-2)."""
    tr = ab["trainer"]
    state = tr.state_from(ab["params"])
    batch = port_batch(ab)
    losses = []
    for _ in range(5):
        state, out = tr.train_step(state, batch)
        losses.append(float(out[0]))
    np.testing.assert_allclose(losses, ab["losses"], rtol=2e-5)
    assert state.step == 5
    noise_bound = 2 * sum(tr.tx.lr(i) for i in range(5))
    for name, p in state.params.items():
        want, start = ab["final"][name], ab["params"][name]
        gap = p.detach() - want
        if name.endswith(NOISE_ONLY):
            assert float(gap.abs().max()) <= noise_bound, name
        else:
            assert float(gap.norm()) <= 2e-3 * float((want - start).norm()), \
                name
