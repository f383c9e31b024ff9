"""The 'mla-moe' model family (``models/mla_moe.py``) against the benchmark's
plain reference (``benchmark/reference/moonlight.py``) on the CPU, seeded,
at d_model 64 with 8 experts, top 2, three layers of which one is dense:

* the forward, the balance term and every parameter's gradient in fp32,
  and three training steps through ``Trainer.train_step`` (losses, the
  first gradient, the parameters' change, the correction biases);
* the bf16 forward within a stated tolerance of the reference at bf16
  (the program's rounding points) and of the fp32 reference;
* the router: selection by s + b, weights from s, the scaling, and every
  assignment computed;
* the balance term, the loads and the bias update over real residues
  only, and the outputs at real positions unmoved by pad rows and pad
  positions;
* the correction biases in the training state: a checkpoint holds them,
  and a resumed run and ``predict`` read them;
* the configuration file's published widths at ``meta`` size: 2.42 B
  parameters, named and shaped as the reference's;
* the configuration's checks and the paths the family does not take.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import moe_weights, proteins
from benchmark import spec as bench_spec
from benchmark.reference import moonlight as R
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import Batch
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.models import mla_moe
from protein_transformer_tpu_torch.models.factory import make_model
from protein_transformer_tpu_torch.models.transformer import (
    set_model_parallel)
from protein_transformer_tpu_torch.parallel.mesh import AxisGroup
from protein_transformer_tpu_torch.training.trainer import Trainer

CPU = torch.device("cpu")
CONFIG = (Path(__file__).resolve().parents[1] / "benchmark" / "configs"
          / "moonlight16b_stage1.json")
PAD = 20
ARCH = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, rope_theta=50000.0, first_k_dense_replace=1,
            moe_intermediate_size=32, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=2,
            routed_scaling_factor=2.446, rms_norm_eps=1e-5,
            bias_update_speed=1e-3, seq_aux_alpha=1e-4)
PROGRAM = dict(model="mla-moe", d_model=64, d_ff=128, n_heads=4,
               n_layers=3, dropout=0.0, mla_moe=ARCH, loss="combined",
               optimizer="adam", lr_scheduling="noam", n_warmup_steps=100,
               clip=1.0, max_seq_len=48)


def config(**kw) -> TrainConfig:
    return TrainConfig(**{**PROGRAM, **kw}).finalize()


def spec_of(cfg: TrainConfig) -> dict:
    """The reference's configuration of ``cfg``, as the benchmark's
    configuration files give it."""
    return {"model": cfg.model, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "n_heads": cfg.n_heads, "n_layers": cfg.n_layers,
            "mla_moe": cfg.mla_moe, "vocab_size": cfg.vocab_size,
            "compute_dtype": cfg.compute_dtype,
            "max_seq_len": cfg.max_seq_len,
            "pad_id": cfg.pad_id, "head_gain": 1.0, "reference":
            "benchmark.reference.moonlight", "loss": cfg.loss,
            "backbone_loss": cfg.backbone_loss,
            "combined_drmsd_weight": cfg.combined_drmsd_weight,
            "clip": cfg.clip, "n_warmup_steps": cfg.n_warmup_steps}


def weights(cfg: TrainConfig, seed: int = 3) -> dict:
    return moe_weights.make(spec_of(cfg), seed, np.full(24, 0.1), CPU)


def models(cfg: TrainConfig, w: dict):
    prog = make_model(cfg, np.full(24, 0.1, np.float32))
    prog.load_state_dict(w, strict=False)
    ref = R.model_of(spec_of(cfg), w, CPU)
    return prog, ref


def ids_batch(seed: int = 0, rows: int = 3, length: int = 40):
    """Ids with a short protein (pad positions) and a dummy row."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 20, (rows, length), generator=g)
    ids[1, 25:] = PAD
    ids[-1] = PAD
    return ids


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_fp32_forward_balance_and_gradients_match_the_reference():
    cfg = config()
    prog, ref = models(cfg, weights(cfg))
    prog.train(), ref.train()
    ids = ids_batch()
    real = ids != PAD
    out_p = prog(ids)
    out_r, per_row, _ = ref(ids)
    assert rel(out_p[real].detach(), out_r[real].detach()) < 1e-5
    bal_r = per_row.sum() / real.any(1).sum()
    bal_p = prog.balance[0]
    got, want = float(bal_p.detach()), float(bal_r.detach())
    assert abs(got - want) < 1e-6 * abs(want) + 1e-12
    probe = torch.randn(out_p.shape, generator=torch.Generator().manual_seed(1))
    loss_p = (out_p * probe)[real].sum() + bal_p * 1e3
    loss_r = (out_r * probe)[real].sum() + bal_r * 1e3
    names = [k for k, _ in ref.named_parameters()]
    pp = dict(prog.named_parameters())
    gp = torch.autograd.grad(loss_p, [pp[k] for k in names])
    gr = torch.autograd.grad(loss_r, [p for _, p in ref.named_parameters()])
    for k, a, b in zip(names, gp, gr):
        assert rel(a, b) < 1e-4, k


def test_three_train_steps_match_the_reference(tmp_path):
    traffic = {"splits": {"train": {"n": 8, "lengths": {
        "dist": "uniform", "min": 20, "max": 40}}},
        "missing_atoms": 0.02, "max_len": 48}
    splits, data = proteins.dataset(traffic, 0, CPU)
    tr = Trainer(TrainConfig(**PROGRAM, batch_size=4, train_only=True,
                             cluster=True, log_structure_step=0,
                             log_val_struct_step=0, out_dir=str(tmp_path),
                             name="m"), CPU, data)
    spec = spec_of(tr.cfg)
    w0 = weights(tr.cfg)
    state = tr.state_from(w0)
    # three proteins and a dummy row, padded to 44 residues
    b = R.batch_of(splits["train"], [0, 1, 2], 4, 44, PAD, CPU)
    batch = Batch(**b, n_res=int((b["seq"] != PAD).sum()))
    ref = R.train_steps(spec, w0, [b, b, b], 0, CPU)
    losses = []
    for step in range(3):
        state, out = tr.train_step(state, batch)
        losses.append(float(out[0]))
        if step == 0:
            grad1 = {k: m / (1 - R.ADAM_B1) - R.WEIGHT_DECAY * w0[k]
                     for k, m in zip(w0, state.opt_state.mu)}
    np.testing.assert_allclose(losses, ref.step_losses, rtol=1e-6)
    assert ref.losses == ref.step_losses[:1]
    med = float(np.median([g.norm() for g in ref.grad1.values()]))
    for k in w0:
        scale = max(float(ref.grad1[k].norm()), med)
        assert float((grad1[k] - ref.grad1[k]).norm()) < 1e-4 * scale, k
        change = state.params[k].detach() - w0[k]
        scale = max(float(ref.change[k].norm()), 1e-3)
        assert float((change - ref.change[k]).norm()) < 2e-3 * scale, k
    # the state's correction biases moved three times by 1e-3 at most; the
    # module's own stay as built
    assert sorted(state.buffers) == [
        f"layers.{i}.mlp.gate.e_score_correction_bias" for i in (1, 2)]
    for name, b_ in state.buffers.items():
        assert b_.abs().max() > 0 and torch.all(
            (b_.abs() * 1e3).round() <= 3)
        assert not tr.model.get_buffer(name).any()


def test_bf16_forward_is_within_its_tolerance():
    """bf16 products against the reference at bf16 (rounded where the
    program rounds), 8 experts: the angles within 1e-5 at every real
    position (measured: equal). Against the fp32 reference, with as many
    experts as a token takes (2 of 2), so that no selection can flip on a
    rounding: within 0.15 at every real position and 4% relative over all
    of them (measured: 0.087 and 2.3%; with 8 experts near-tied selections
    flip and the outputs part by up to ~1.9)."""
    cfg = config(compute_dtype="bfloat16")
    prog, ref = models(cfg, weights(cfg))
    ids = ids_batch()
    real = ids != PAD
    with torch.no_grad():
        got = prog.eval()(ids)[real]
        want = ref.eval()(ids)[0][real]
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)
    arch = dict(ARCH, n_routed_experts=2)
    cfg32 = config(mla_moe=arch)
    w = weights(cfg32)
    _, ref = models(cfg32, w)
    prog, _ = models(config(mla_moe=arch, compute_dtype="bfloat16"), w)
    ids = ids_batch()
    real = ids != PAD
    with torch.no_grad():
        got = prog.eval()(ids)[real]
        want = ref.eval()(ids)[0][real]
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) < 0.15
    assert rel(got, want) < 0.04


def test_dense_layers_only_train(tmp_path):
    """first_k_dense_replace = n_layers: no expert layer, no balance term,
    no buffer; a train step runs."""
    data = make_dataset(n_train=4, n_eval=2, min_len=10, max_len=20, seed=0)
    arch = dict(ARCH, first_k_dense_replace=3)
    tr = Trainer(TrainConfig(**{**PROGRAM, "mla_moe": arch}, batch_size=2,
                             train_only=True, cluster=True,
                             out_dir=str(tmp_path), name="m"), CPU, data)
    state = tr.init_state(torch.Generator().manual_seed(0))
    assert state.buffers == {}
    state = tr.train_epoch(state)
    assert state.step > 0


def test_router_selects_by_biased_scores_and_weighs_by_scores():
    cfg = config()
    prog, _ = models(cfg, weights(cfg))
    moe = next(m for m in prog.modules() if isinstance(m, mla_moe.MoE))
    bias = torch.linspace(-0.3, 0.3, 8)
    moe.gate.e_score_correction_bias.copy_(bias)
    x = torch.randn(50, 64, generator=torch.Generator().manual_seed(2))
    sel, g, s = moe.route(x)
    want = torch.topk(s + bias, 2, dim=-1).indices
    assert torch.equal(sel.sort(-1).values, want.sort(-1).values)
    picked = s.gather(1, sel)
    torch.testing.assert_close(g, picked / picked.sum(-1, keepdim=True)
                               * 2.446)
    torch.testing.assert_close(g.sum(-1), torch.full((50,), 2.446))
    # every assignment has a row: k rows a token, grouped by expert
    slot, token, offs = moe.dispatch(sel)
    assert len(token) == len(slot) == 2 * 50 and int(offs[-1]) == 100
    assert torch.equal(torch.bincount(token, minlength=50),
                       torch.full((50,), 2))
    flat = sel.reshape(-1)
    starts = torch.cat([offs.new_zeros(1), offs[:-1]]).long()
    for e in range(8):
        rows = torch.arange(int(starts[e]), int(offs[e]))
        assert torch.all(flat[torch.argsort(flat, stable=True)][rows] == e)
    assert torch.equal(token[slot], torch.arange(100) // 2)


def test_balance_loads_and_bias_update_count_real_residues_only():
    cfg = config()
    prog, _ = models(cfg, weights(cfg))
    prog.train()
    ids = ids_batch()
    real = ids != PAD
    prog(ids)
    loss, loads = prog.balance[0], prog.balance[1]
    assert sorted(loads) == [f"layers.{i}.mlp.gate.e_score_correction_bias"
                             for i in (1, 2)]
    for load in loads.values():
        assert float(load.sum()) == 2 * int(real.sum())
    # more pad positions and a second dummy row change nothing real
    wider = torch.full((4, 48), PAD)
    wider[:3, :40] = ids
    out_w = prog(wider)
    torch.testing.assert_close(prog.balance[0], loss, rtol=1e-6,
                               atol=0.0)
    for name, load in loads.items():
        assert torch.equal(prog.balance[1][name], load)
    out = prog(ids)
    torch.testing.assert_close(out_w[:3, :40][real], out[real], rtol=1e-5,
                               atol=1e-6)
    buffers = {k: torch.full((8,), 0.5) for k in loads}
    prog.update_buffers(buffers)
    for name, load in loads.items():
        torch.testing.assert_close(
            buffers[name] - 0.5, 1e-3 * torch.sign(load.mean() - load))


def test_published_widths_at_meta_size():
    conf = json.loads(CONFIG.read_text())
    spec = bench_spec.flat_config(conf)
    cfg = TrainConfig(**conf["program"]).finalize()
    # the published numbers at the top level are the program's
    assert (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_layers) == (
        conf["hidden_size"], conf["intermediate_size"],
        conf["num_attention_heads"], conf["num_hidden_layers"])
    for k, v in cfg.mla_moe.items():
        assert conf.get(k, v) == v, k
    with torch.device("meta"):
        prog = make_model(cfg, np.zeros(24, np.float32))
        ref = R.build(spec)
    shapes = {k: tuple(p.shape) for k, p in prog.named_parameters()}
    assert shapes == {k: tuple(p.shape) for k, p in ref.named_parameters()}
    assert sum(np.prod(s) for s in shapes.values()) == 2_422_460_952
    assert shapes["layers.1.mlp.experts.gate_proj"] == (64, 1408, 2048)
    assert shapes["layers.0.self_attn.kv_b_proj.weight"] == (4096, 512)


@pytest.mark.parametrize("change, words", [
    (dict(mla_moe={k: v for k, v in ARCH.items() if k != "v_head_dim"}),
     "lacks ['v_head_dim']"),
    (dict(mla_moe={**ARCH, "num_experts_per_tok": 9}),
     "must not exceed n_routed_experts"),
    (dict(mla_moe={**ARCH, "qk_rope_head_dim": 7}), "must be even"),
    (dict(mla_moe={**ARCH, "scoring_func": "sigmoid"}),
     "unknown keys ['scoring_func']"),
    (dict(attention_impl="flash"), "flash"),
    (dict(dropout=0.1), "dropout"),
    (dict(mla_moe=None), "lacks"),
])
def test_config_checks(change, words):
    with pytest.raises(ValueError, match=words.replace("[", r"\[")
                       .replace("]", r"\]")):
        config(**change)


def test_unsupported_paths_raise():
    from protein_transformer_tpu_torch.models import torch_import
    cfg = config()
    model = make_model(cfg, np.zeros(24, np.float32))
    with pytest.raises(ValueError, match="tensor-parallel"):
        set_model_parallel(model, AxisGroup(2, 0))
    with pytest.raises(ValueError, match="nothing to import"):
        torch_import.state_dict_to_port({}, model)


def test_checkpoint_resume_and_predict_keep_the_correction_bias(tmp_path):
    """A trained run's checkpoint holds the state's correction biases; a
    resumed trainer starts from them and ``predict.load_run`` builds the
    model with them, which then gives the trainer's predictions."""
    from protein_transformer_tpu_torch import predict
    data = make_dataset(n_train=6, n_eval=2, min_len=10, max_len=20, seed=0)
    kw = dict(PROGRAM, train_only=True, cluster=True, batch_size=3,
              epochs=1, log_structure_step=0, log_val_struct_step=0,
              out_dir=str(tmp_path), name="m")
    tr = Trainer(TrainConfig(**kw), CPU, data)
    state = tr.train()
    assert state.step > 0
    assert any(b.any() for b in state.buffers.values())
    run = str(tmp_path / "m")
    again = Trainer(TrainConfig(**kw), CPU, data)
    resumed = again.maybe_restore(again.init_state(
        torch.Generator().manual_seed(1)))
    assert resumed.step == state.step
    for k, b in state.buffers.items():
        assert torch.equal(resumed.buffers[k], b)
    _, model = predict.load_run(run, device="cpu")
    for k, b in state.buffers.items():
        assert torch.equal(model.get_buffer(k), b)
    seq = ids_batch()
    with torch.no_grad():
        want = torch.func.functional_call(
            tr.model.eval(), resumed.variables, (seq,))
        got = model(seq)
    torch.testing.assert_close(got, want)


def test_trainer_draws_each_expert_at_its_own_bound(tmp_path):
    data = make_dataset(n_train=4, n_eval=2, min_len=10, max_len=20, seed=0)
    tr = Trainer(TrainConfig(**PROGRAM, train_only=True, cluster=True,
                             out_dir=str(tmp_path), name="m"), CPU, data)
    w = tr.init_params(torch.Generator().manual_seed(0))
    stack = w["layers.1.mlp.experts.down_proj"]
    bound = (6.0 / (64 + 32)) ** 0.5
    for m in stack:
        assert 0.9 * bound < float(m.abs().max()) <= bound
