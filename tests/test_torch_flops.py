"""The port's ``training/flops.py`` against the JAX package's.

Every count of the two modules is equal for the model families and losses
below, built from the same config fields; the card's peak is the bf16 dense
peak of the NVIDIA H100 datasheet, and a card not in the table raises (the
JAX module falls back to a TPU's peak). The analytic forward count lands in
the band ``tests/test_flops.py`` holds against XLA's cost analysis, here
against ``torch.utils.flop_counter.FlopCounterMode`` on the port's forward.

Cost: ~5 s in one worker (no JAX compile; four small CPU forwards).
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from protein_transformer_tpu.config import TrainConfig as JConfig
from protein_transformer_tpu.training import flops as JF
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.models.factory import (
    make_model, model_args)
from protein_transformer_tpu_torch.training import flops as F

MODELS = [
    dict(),                                              # enc-only
    dict(model="conv-enc|11,5,3|1,1,1", d_model=128),    # conv front-end
    dict(model="conv-enc|11,5,3|2,2,1", d_model=128),    # with reductions
    dict(model="enc-dec"),                               # decoder stack
]
LOSSES = ["mse", "drmsd", "lndrmsd", "combined"]
SHAPES = [(4, 64), (1, 100), (16, 256)]


def both(**kw):
    base = dict(model="enc-only", d_model=64, d_ff=256, n_heads=4,
                n_layers=2, dropout=0.0, loss="mse", max_seq_len=64,
                bucket_sizes=(64,), batch_size=4, train_only=True)
    base.update(kw)
    return JConfig(**base).finalize(), TrainConfig(**base).finalize()


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("spec", MODELS, ids=["enc-only", "conv-enc",
                                              "conv-enc-reduc", "enc-dec"])
@pytest.mark.parametrize("backbone_loss", [False, True])
@pytest.mark.parametrize("full_metrics", [False, True])
def test_counts_equal_the_jax_module(spec, loss, backbone_loss,
                                     full_metrics):
    jcfg, cfg = both(loss=loss, backbone_loss=backbone_loss,
                     full_metrics=full_metrics, **spec)
    for b, l in SHAPES:
        for name in ("model_forward_flops", "loss_forward_flops",
                     "train_step_flops"):
            assert getattr(F, name)(cfg, b, l) == \
                getattr(JF, name)(jcfg, b, l), (name, b, l)
        assert F.mfu(cfg, b, l, 7.5e-3, n_chips=2,
                     device_name="NVIDIA H100 80GB HBM3") == \
            JF.train_step_flops(jcfg, b, l) / (7.5e-3 * 2 * 989.4e12)


def test_peak_is_the_h100_bf16_dense_peak():
    assert F.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989.4e12
    assert F.peak_flops_per_chip("NVIDIA H100 PCIe") == 756e12
    assert F.peak_flops_per_chip("NVIDIA H100 NVL") == 835e12
    for name in ("TPU v5 lite", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no bf16 peak"):
            F.peak_flops_per_chip(name)
        with pytest.raises(ValueError, match="no bf16 peak"):
            F.mfu(both()[1], 8, 256, 1e-2, device_name=name)


@pytest.mark.parametrize("spec", MODELS, ids=["enc-only", "conv-enc",
                                              "conv-enc-reduc", "enc-dec"])
def test_forward_count_tracks_torch_flop_counter(spec):
    _, cfg = both(**spec)
    b, l = 4, 64
    torch.manual_seed(0)
    model = make_model(cfg, np.zeros(24, np.float32)).eval()
    ids = torch.full((b, l), 3, dtype=torch.long)
    ang = torch.zeros((b, l, 24))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(*model_args(model, ids, ang))
    counted = counter.get_total_flops()
    analytic = F.model_forward_flops(cfg, b, l)
    # the counter counts matmuls and convolutions only; the analytic model
    # the dense work: the band of tests/test_flops.py
    assert 0.5 * counted <= analytic <= 1.6 * counted, (analytic, counted)
