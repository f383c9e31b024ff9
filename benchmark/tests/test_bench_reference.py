"""The plain reference against the port on the CPU at small sizes (the
test imports both; the reference imports nothing of the port)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import correct, proteins, spec as S, weights
from benchmark.reference import geometry, losses
from benchmark.reference import train as R
from conftest import REPO
from protein_transformer_tpu_torch import losses as PL
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import Batch
from protein_transformer_tpu_torch.models.factory import make_model
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch
from protein_transformer_tpu_torch.training.trainer import (
    METRIC_KEYS, compute_losses)

CPU = torch.device("cpu")


def _spec(name, **kw):
    spec = S.flat_config(json.loads(
        (REPO / f"benchmark/configs/{name}.json").read_text()))
    spec.update(d_model=32, d_ff=64, n_heads=4, n_layers=2, **kw)
    return spec


def _port_model(spec):
    cfg = TrainConfig(**{k: spec[k] for k in (
        "model", "d_model", "d_ff", "n_heads", "n_layers", "dropout",
        "loss", "backbone_loss")}).finalize()
    return make_model(cfg, np.zeros(24, np.float32)), cfg


def _data(n=6):
    split = {"n": n, "lengths": {"dist": "uniform", "min": 20, "max": 40}}
    return proteins.make(split, np.random.default_rng(5), 0.02, CPU)


def test_geometry_matches_the_port():
    p = _data()
    ang = geometry.angles_from_sincos(torch.from_numpy(
        np.nan_to_num(p.sincos)))
    ids = torch.from_numpy(p.ids)
    ours = geometry.coords(ang, ids)
    port = build_coords_batch(ang, ids, "torch")
    assert torch.allclose(ours, port, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["conv_enc_512", "conv_enc_1024"])
def test_forward_and_metrics_match_the_port(name):
    spec = _spec(name)
    model, cfg = _port_model(spec)
    p = _data()
    w = weights.make(spec, 11, np.zeros(24, np.float32), CPU)
    batch = R.batch_of(p, np.arange(len(p)), 8, 64, 20, CPU)
    ref = R.score(spec, w, [batch], CPU)[0]
    model.eval()
    pb = Batch(batch["seq"], batch["ang"], batch["ang_mask"], batch["crd"],
               batch["crd_mask"], batch["protein_mask"], 0)
    with torch.no_grad():
        _, out = compute_losses(model, w, pb, cfg, impl="torch",
                                with_drmsd=True, with_rmsd=True,
                                sidechain_impl="torch")
    port = [float(out[k]) for k in R.METRICS]
    np.testing.assert_allclose(port, ref, rtol=2e-5)


def test_train_steps_match_the_port():
    """Three steps with dropout: the same masks from the same generator,
    so the losses and the updates agree to rounding."""
    spec = _spec("conv_enc_512")
    model, cfg = _port_model(spec)
    p = _data(12)
    w = weights.make(spec, 3, np.zeros(24, np.float32), CPU)
    batches = [R.batch_of(p, np.arange(i, i + 4), 4, 64, 20, CPU)
               for i in (0, 4, 8)]
    ref = R.train_steps(spec, w, batches, 99, CPU)
    from protein_transformer_tpu_torch.models.transformer import (
        set_dropout_generator)
    from protein_transformer_tpu_torch.training.optim import (
        make_optimizer, noam_schedule)
    gen = torch.Generator().manual_seed(99)
    set_dropout_generator(model, gen)
    model.train()
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    tx = make_optimizer("adam", noam_schedule(32, 10000), True, 1.0)
    st = tx.init(params)
    for i, b in enumerate(batches):
        pb = Batch(b["seq"], b["ang"], b["ang_mask"], b["crd"],
                   b["crd_mask"], b["protein_mask"], 0)
        loss, _ = compute_losses(model, params, pb, cfg, impl="torch",
                                 sidechain_impl="torch")
        assert abs(float(loss.detach()) - ref.losses[i]) \
            <= 1e-5 * abs(ref.losses[i])
        grads = torch.autograd.grad(loss, list(params.values()))
        st = tx.update(params, grads, st)
    # p + change rounds to the parameter's float32 grid, so the changes
    # are compared as the benchmark compares them: by each leaf's norm,
    # over the leaves whose gradient is not nought to rounding
    change = {k: params[k].detach() - w[k] for k in params}
    norms = {k: float(g.norm()) for k, g in ref.grad1.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k, n in norms.items() if n >= correct.NEGLIGIBLE * med]
    assert len(keep) > len(w) // 2
    assert correct._leaf_gap(change, ref.change, keep) < 1e-4


def test_kabsch_and_drmsd_match_the_port():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 50, 3, generator=g)
    b = torch.randn(3, 50, 3, generator=g)
    m = torch.rand(3, 50, generator=g) > 0.2
    assert torch.allclose(losses.kabsch_rmsd(a, b, m),
                          PL.kabsch_rmsd_masked(a, b, m), atol=1e-5)
    assert torch.allclose(losses.drmsd(a, b, m),
                          PL.drmsd_masked(a, b, m, "torch"), rtol=1e-5)
    # the written-out gradient against autograd of the plain formula
    a.requires_grad_()
    ours = torch.autograd.grad(losses.drmsd(a, b, m).sum(), a)[0]
    theirs = torch.autograd.grad(
        PL.drmsd_masked(a, b, m, "torch").sum(), a)[0]
    assert torch.allclose(ours, theirs, atol=1e-6)


def test_metric_order_is_the_port_order():
    assert tuple(METRIC_KEYS) == R.METRICS
