"""Training and evaluation of the port: model -> angles -> NeRF -> losses,
backward, and the optimizer update.

Port of the training step and the host-batch epoch loops of
protein_transformer_tpu/training/trainer.py. The model runs on an explicit
device; parameters are a plain dict of tensors (``Trainer.init_params``, or
the flax bridge) applied with ``torch.func.functional_call``, the
counterpart of flax's ``apply``. A step computes the losses in train mode
(dropout drawn from the trainer's own generator), takes the gradients with
``torch.autograd.grad`` and applies the optimizer of ``training/optim.py``
in place. Metrics are packed into one (K,) device vector per step and
fetched in windows of FLUSH_EVERY steps, then accumulated by the JAX
package's numpy-only ``training/metrics.py``.

The epoch driver with eval splits, plateau and early-stopping decisions,
checkpoints, logging and the CLI come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
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
from protein_transformer_tpu_torch.models.transformer import (
    set_dropout_generator)
from protein_transformer_tpu_torch.ops.drmsd import resolve_impl
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch
from protein_transformer_tpu_torch.training.optim import (
    OptState, PlateauState, make_optimizer, noam_schedule)

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
    whatever train/eval mode it is in: the train step puts it in train, the
    eval step in eval.

    Under ``grad_semantics="reference"`` with a dRMSD-family loss the
    returned loss keeps its value but carries the gradient of the sum over
    real proteins of per-protein ln-dRMSD (plus the MSE term of "combined"),
    as the original torch code stitched its gradients."""
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
        ref_grads = (cfg.grad_semantics == "reference"
                     and cfg.loss in DRMSD_LOSSES)
        d = L.compute_batch_drmsd(
            pred, batch.crd, batch.seq, batch.crd_mask, batch.protein_mask,
            impl=impl, pred_crd=pred_crd, with_per_protein=ref_grads,
            backbone_only=bb_only)
        if ref_grads:
            d, per = d
        out.update({"drmsd-full": d.drmsd, "lndrmsd-full": d.ln_drmsd,
                    "drmsd-bb": d.drmsd_bb, "lndrmsd-bb": d.ln_drmsd_bb})
        d_train = d.drmsd_bb if cfg.backbone_loss else d.drmsd
        ln_train = d.ln_drmsd_bb if cfg.backbone_loss else d.ln_drmsd
        c = L.combine_drmsd_mse(ln_train, m_full, w=cfg.combined_drmsd_weight)
        out["combined-full"] = c
        loss = {"drmsd": d_train, "lndrmsd": ln_train,
                "combined": c}.get(cfg.loss, m_full)
        if ref_grads:
            ln_vec = per.ln_drmsd_bb if cfg.backbone_loss else per.ln_drmsd
            grad_loss = torch.sum(ln_vec * batch.protein_mask.to(ln_vec.dtype))
            if cfg.loss == "combined":
                grad_loss = grad_loss + L.combine_drmsd_mse(
                    ln_train.detach(), m_full, w=cfg.combined_drmsd_weight)
            loss = (loss - grad_loss).detach() + grad_loss
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


@dataclasses.dataclass
class TrainState:
    """params: dict of leaf tensors that require grad, updated in place by
    the optimizer; opt_state: the optimizer's state; step: updates so far
    (a host integer)."""
    params: dict
    opt_state: OptState
    step: int


class Trainer:
    """The training step and the train/eval epoch loops on one explicit
    device."""

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
        # every dropout mask of the model is drawn from this generator
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(cfg.seed)
        set_dropout_generator(self.model, self.dropout_generator)
        if cfg.lr_scheduling == "noam":
            self.lr_schedule = noam_schedule(cfg.d_model, cfg.n_warmup_steps)
            self.plateau = None
        else:
            self.lr_schedule = None
            self.plateau = PlateauState(patience=cfg.patience,
                                        threshold=cfg.early_stopping_threshold)
        self.tx = make_optimizer(cfg.optimizer,
                                 self.lr_schedule or cfg.learning_rate,
                                 cfg.weight_decay, cfg.clip)
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

    def state_from(self, params: dict) -> TrainState:
        """Step 0 from copies of ``params`` on the device, with a fresh
        optimizer state."""
        params = {k: v.detach().to(self.device).clone().requires_grad_()
                  for k, v in params.items()}
        return TrainState(params, self.tx.init(params), 0)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Step 0 from fresh parameters drawn from ``generator``."""
        return self.state_from(self.init_params(generator))

    def current_lr(self, step: int) -> float:
        """The learning rate of the update after ``step`` updates."""
        if self.lr_schedule is not None:
            return self.lr_schedule(step)
        return self.cfg.learning_rate * (self.plateau.scale if self.plateau
                                         else 1.0)

    def loss_and_grads(self, params: dict, batch: Batch):
        """(loss, metrics dict, gradients in the params' order) of one batch
        already on the device, with the model in train mode."""
        self.model.train()
        loss, out = compute_losses(self.model, params, batch, self.cfg,
                                   impl=self.drmsd_impl)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        return loss, out, grads

    def train_step(self, state: TrainState, batch: Batch,
                   lr_scale: float = 1.0) -> tuple[TrainState, torch.Tensor]:
        """One optimizer update on one batch (moved to the device here):
        forward in train mode, backward, then the update, in place on
        ``state.params``. Returns the new state and the packed (K,) metrics
        vector of the batch, still on the device."""
        _, out, grads = self.loss_and_grads(state.params,
                                            batch.to(self.device))
        opt_state = self.tx.update(state.params, grads, state.opt_state,
                                   lr_scale)
        return (TrainState(state.params, opt_state, state.step + 1),
                pack_metrics(out).detach())

    def _record(self, mode: str, pending: list, t_last_flush: float) -> float:
        """Fetch a window of (metrics vector, n_res, step) in one copy and
        record its rows in order, each timed at an even share of the window;
        returns the flush time. A training row whose loss is not finite
        raises FloatingPointError after the rows before it are recorded."""
        rows = torch.stack([p[0] for p in pending]).cpu().numpy()
        t_now = time.time()
        dt = (t_now - t_last_flush) / len(pending)
        for i, (row, (_, n_res, step)) in enumerate(zip(rows, pending)):
            if mode == "train":
                if not np.isfinite(row[0]):  # METRIC_KEYS[0] == "loss"
                    raise FloatingPointError(
                        "A nan loss has occurred. Exiting training.")
                self.metrics["history-lr"].append(self.current_lr(step))
            self.metrics = M.update_batch(self.metrics, mode,
                                          unpack_metrics(row), n_res,
                                          now=t_last_flush + (i + 1) * dt)
        return t_now

    def train_epoch(self, state: TrainState) -> TrainState:
        """One epoch over the binned sampler's batches (drawn from
        ``seed + step``), with the plateau scale on the learning rate;
        returns the new state and keeps the "train" metrics."""
        mode = "train"
        self.metrics = M.reset_for_epoch(self.metrics, mode)
        step = state.step
        rng = np.random.default_rng(self.cfg.seed + step)
        lr_scale = self.plateau.scale if self.plateau else 1.0
        pending: list = []
        t_last_flush = time.time()
        for batch in self.dm.train_batches(rng):
            state, out = self.train_step(state, batch, lr_scale)
            pending.append((out, batch.n_res, step))
            step += 1
            if len(pending) >= self.FLUSH_EVERY:
                t_last_flush = self._record(mode, pending, t_last_flush)
                pending = []
        if pending:
            self._record(mode, pending, t_last_flush)
        self.metrics = M.end_of_epoch(self.metrics, mode)
        return state

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
        for batch in self.dm.eval_batches(split):
            pending.append((self.eval_step(params, batch), batch.n_res, None))
            if len(pending) >= self.FLUSH_EVERY:
                t_last_flush = self._record(mode, pending, t_last_flush)
                pending = []
        if pending:
            self._record(mode, pending, t_last_flush)
        self.metrics = M.end_of_epoch(self.metrics, mode)
        return self.metrics[mode]
