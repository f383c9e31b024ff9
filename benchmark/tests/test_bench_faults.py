"""Runs whose timed path is broken underneath come out not correct: the
harness's look for a card skipped (``--device cpu``), the rest of a run
as it is, one planted fault each."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import run
from conftest import make_tiny_root
from protein_transformer_tpu_torch.training import optim
from protein_transformer_tpu_torch.training import trainer as trainer_mod


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = make_tiny_root(tmp_path_factory.mktemp("faults"))
    # four proteins a scoring batch, so that half of one can go missing
    path = r / "benchmark/traffic/l500_eval.json"
    traffic = json.loads(path.read_text())
    traffic["program"]["batch_size"] = 4
    path.write_text(json.dumps(traffic))
    return r


def _run(root, workload, capsys) -> dict:
    assert run.main(["--workload", workload, "--seed", "2147483700",
                     "--seconds", "0.5", "--trace", "0", "--device", "cpu",
                     "--root", str(root)]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(optim.Optimizer, "update",
                        lambda self, params, grads, state, lr_scale=1.0:
                        state)


def _half_batch(monkeypatch):
    real = trainer_mod.compute_losses

    def halved(model, params, batch, cfg, **kw):
        pm = batch.protein_mask
        keep = torch.arange(pm.shape[0], device=pm.device) < max(
            1, int(pm.sum()) // 2)
        batch = trainer_mod.Batch(
            batch.seq, batch.ang, batch.ang_mask & keep[:, None, None],
            batch.crd, batch.crd_mask & keep[:, None, None], pm & keep,
            batch.n_res)
        return real(model, params, batch, cfg, **kw)
    monkeypatch.setattr(trainer_mod, "compute_losses", halved)


def _answer_altered(monkeypatch):
    real = trainer_mod.pack_metrics

    def altered(out):
        v = real(out)
        return v * torch.where(torch.arange(v.shape[0]) == 4, 1.01, 1.0).to(
            v.device) if v.shape[0] > 4 else v
    monkeypatch.setattr(trainer_mod, "pack_metrics",
                        lambda out: altered(out) if out["drmsd-full"].numel()
                        else real(out))


def _loss_altered(monkeypatch):
    real = trainer_mod.pack_metrics
    monkeypatch.setattr(trainer_mod, "pack_metrics",
                        lambda out: real({**out, "loss": out["loss"] * 1.01}))


@pytest.mark.parametrize("workload,fault", [
    ("conv512_train_l500", _state_unchanged),
    ("conv512_train_l500", _half_batch),
    ("conv512_train_l500", _loss_altered),
    ("conv1024_train_l500", _state_unchanged),
    ("conv512_eval_l500", _half_batch),
    ("conv512_eval_l500", _answer_altered),
])
def test_fault_is_not_correct(root, workload, fault, monkeypatch, capsys):
    fault(monkeypatch)
    res = _run(root, workload, capsys)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", ["conv512_train_l500",
                                      "conv512_eval_l500"])
def test_sound_run_is_correct(root, workload, capsys):
    assert _run(root, workload, capsys)["correct"] is True


def test_loop_that_skips_the_probe_raises(root, monkeypatch):
    """A training epoch that no longer goes through the wrapped
    ``train_step`` stops set-up at once instead of looping."""
    from benchmark import harness, spec
    monkeypatch.setattr(trainer_mod.Trainer, "train_epoch",
                        lambda self, state, *a, **k: state)
    with pytest.raises(RuntimeError, match="no call of the train_step"):
        harness.setup(spec.load(root, "conv512_train_l500"), 5,
                      torch.device("cpu"), warm=False)
