"""Evaluation loop of the port: model -> angles -> NeRF -> dRMSD/MSE/RMSD.

Port of the eval slice of protein_transformer_tpu/training/trainer.py. The
model runs on an explicit device; parameters are a plain dict of tensors
(``Trainer.init_params``, or the flax bridge) applied with
``torch.func.functional_call``, the counterpart of flax's ``apply``. Metrics
are packed into one (K,) device vector per step and fetched in windows, then
accumulated by the JAX package's numpy-only ``training/metrics.py``.

Training (optimizer, backward), checkpoints, logging and the CLI come with
later slices of the port.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.func import functional_call

from protein_transformer_tpu.training import metrics as M
from protein_transformer_tpu_torch import losses as L
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import (
    Batch, DataModule, load_dataset)
from protein_transformer_tpu_torch.models.factory import make_model
from protein_transformer_tpu_torch.ops.drmsd import resolve_impl
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch

DRMSD_LOSSES = ("drmsd", "lndrmsd", "combined")

# Fixed order in which a step packs its scalar metrics into one (K,) vector,
# so a window of steps is fetched to the host in one copy.
METRIC_KEYS = ("loss", "mse-full", "mse-bb", "mse-sc", "drmsd-full",
               "lndrmsd-full", "drmsd-bb", "lndrmsd-bb", "combined-full",
               "rmsd-full")


def pack_metrics(out: dict) -> torch.Tensor:
    """Stack the scalar metric dict into a (K,) tensor."""
    return torch.stack([out[k] for k in METRIC_KEYS])


def unpack_metrics(row) -> dict:
    """Host-side inverse of pack_metrics for one fetched row."""
    return {k: float(v) for k, v in zip(METRIC_KEYS, row)}


def compute_losses(model, params, batch: Batch, cfg: TrainConfig,
                   impl: str = "auto", with_drmsd=None, with_rmsd=False):
    """All batch losses for a batch already on the model's device.

    Returns (loss, dict of scalar metrics). MSE is always computed; the
    dRMSD family when the loss needs it or with_drmsd. impl selects the
    dRMSD pair sweep (see ops.drmsd.resolve_impl). The model runs in
    whatever train/eval mode it is in; the eval step puts it in eval."""
    if with_drmsd is None:
        with_drmsd = cfg.loss in DRMSD_LOSSES
    pred = functional_call(model, params, (batch.seq,))
    m_full = L.mse_over_angles(pred, batch.ang, batch.ang_mask)
    m_bb = L.mse_over_angles(pred, batch.ang, batch.ang_mask, bb_only=True)
    m_sc = L.mse_over_angles(pred, batch.ang, batch.ang_mask, sc_only=True)

    zero = torch.zeros((), dtype=m_full.dtype, device=m_full.device)
    out = {"mse-full": m_full, "mse-bb": m_bb, "mse-sc": m_sc,
           "drmsd-full": zero, "lndrmsd-full": zero, "drmsd-bb": zero,
           "lndrmsd-bb": zero, "combined-full": zero, "rmsd-full": zero}

    pred_crd = None
    if with_drmsd or with_rmsd:
        pred_crd = build_coords_batch(L.inverse_trig_transform(pred),
                                      batch.seq)

    # --backbone_loss: coordinates reduce to the backbone before any
    # dRMSD/RMSD, so the 'full' slots report backbone values;
    # --full_metrics restores full-atom reporting.
    bb_only = cfg.backbone_loss and not cfg.full_metrics
    if with_drmsd:
        d = L.compute_batch_drmsd(
            pred, batch.crd, batch.seq, batch.crd_mask, batch.protein_mask,
            impl=impl, pred_crd=pred_crd, backbone_only=bb_only)
        out.update({"drmsd-full": d.drmsd, "lndrmsd-full": d.ln_drmsd,
                    "drmsd-bb": d.drmsd_bb, "lndrmsd-bb": d.ln_drmsd_bb})
        d_train = d.drmsd_bb if cfg.backbone_loss else d.drmsd
        ln_train = d.ln_drmsd_bb if cfg.backbone_loss else d.ln_drmsd
        c = L.combine_drmsd_mse(ln_train, m_full, w=cfg.combined_drmsd_weight)
        out["combined-full"] = c
        loss = {"drmsd": d_train, "lndrmsd": ln_train,
                "combined": c}.get(cfg.loss, m_full)
    else:
        loss = m_full

    if with_rmsd:
        if bb_only:
            out["rmsd-full"] = L.batch_rmsd(
                pred_crd[:, :, :3], batch.crd[:, :, :3],
                batch.crd_mask[:, :, :3], batch.protein_mask)
        else:
            out["rmsd-full"] = L.batch_rmsd(pred_crd, batch.crd,
                                            batch.crd_mask,
                                            batch.protein_mask)
    out["loss"] = loss
    return loss, out


class Trainer:
    """The evaluation half of the trainer, on one explicit device."""

    # steps whose metric vectors are fetched to the host in one copy
    FLUSH_EVERY = 32

    def __init__(self, cfg: TrainConfig, device: torch.device,
                 data: dict | None = None):
        self.cfg = cfg = cfg.finalize()
        self.device = torch.device(device)
        self.drmsd_impl = resolve_impl(cfg.drmsd_impl, self.device)
        data = data if data is not None else load_dataset(cfg.data)
        self.dm = DataModule(data, cfg)
        angle_means = (np.zeros(24, np.float32) if cfg.without_angle_means
                       else self.dm.angle_means)
        self.model = make_model(cfg, angle_means).to(self.device).eval()
        modes = ["train", "test"] + [f"valid-{s}"
                                     for s in (10, 20, 30, 40, 50, 70, 90)]
        self.metrics = M.init_metrics(modes)

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh parameters, drawn on the CPU from ``generator`` and moved to
        the device, initialised as the flax modules are: xavier-uniform
        weights (Linear, Conv1d, Embedding), zero biases, unit LayerNorm
        scales, and the zero-weight, angle-mean-bias output head."""
        params = {}
        for name, p in self.model.named_parameters():
            t = torch.empty(p.shape, dtype=p.dtype)
            if name.endswith("norm.weight"):
                t.fill_(1.0)
            elif name == "head.output_projection.bias":
                t.copy_(p.detach().cpu())  # angle-mean bias, set at build
            elif name.endswith("bias") or name.startswith("head."):
                t.zero_()
            else:
                torch.nn.init.xavier_uniform_(t, generator=generator)
            params[name] = t.to(self.device)
        return params

    @torch.inference_mode()
    def eval_step(self, params: dict, batch: Batch) -> torch.Tensor:
        """Packed (K,) metrics of one batch (moved to the device here)."""
        self.model.eval()
        _, out = compute_losses(self.model, params, batch.to(self.device),
                                self.cfg, impl=self.drmsd_impl,
                                with_drmsd=True, with_rmsd=True)
        return pack_metrics(out)

    def eval_epoch(self, params: dict, split: str) -> dict:
        """Evaluate one split's collated batches; returns (and keeps) its
        metrics dict. Metric vectors stay on the device and are fetched
        every FLUSH_EVERY steps."""
        mode = split
        self.metrics = M.reset_for_epoch(self.metrics, mode)
        pending: list = []
        t_last_flush = time.time()

        def flush():
            nonlocal pending, t_last_flush
            fetched = (torch.stack([p[0] for p in pending]).cpu().numpy()
                       if pending else [])
            t_now = time.time()
            dt = (t_now - t_last_flush) / max(len(pending), 1)
            for i, (row, (_, n_res)) in enumerate(zip(fetched, pending)):
                self.metrics = M.update_batch(self.metrics, mode,
                                              unpack_metrics(row), n_res,
                                              now=t_last_flush + (i + 1) * dt)
            t_last_flush = t_now
            pending = []

        for batch in self.dm.eval_batches(split):
            pending.append((self.eval_step(params, batch), batch.n_res))
            if len(pending) >= self.FLUSH_EVERY:
                flush()
        if pending:
            flush()
        self.metrics = M.end_of_epoch(self.metrics, mode)
        return self.metrics[mode]
