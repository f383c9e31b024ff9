"""Training control loop of the port: the training and evaluation steps
(model -> angles -> NeRF -> losses, backward, the optimizer update) and the
host loop around them.

Port of protein_transformer_tpu/training/trainer.py. The model runs on an
explicit device; parameters are a plain dict of tensors
(``Trainer.init_params``, or the flax bridge) applied with
``torch.func.functional_call``, the counterpart of flax's ``apply``. A step
computes the losses in train mode (dropout drawn from the trainer's own
generator), takes the gradients with ``torch.autograd.grad`` and applies the
optimizer of ``training/optim.py`` in place. Metrics are packed into one (K,)
device vector per step, copied to the host without blocking, and recorded in
windows of FLUSH_EVERY steps by ``training/metrics.py``; the NaN watchdog
polls the copies that have arrived after every step.

Batches come by one of two data paths, as in the JAX package. With the
device-resident store (``data/device_store.py``; ``--device_data``, on under
``auto`` when the splits fit ``device_data_max_mb``) each split lives on the
device and a batch is an index vector and one gather: the step makes no
stream synchronisation. Otherwise batches are collated on a prefetch thread
(``data/prefetch.py``) and copied from pinned memory on a copy stream, which
the step's stream waits for by an event.

``Trainer.train`` is the host loop with the reference's semantics: epochs,
the validation splits after each, plateau scheduling and early stopping on
the monitored metric, 'best' / 'latest' checkpoints, resume, the CSV log,
structure logging (``training/structure_logging.py``), the test split at
the end, a profiler trace of the first epoch (``--profile_dir``) and the
per-phase host-time report of ``LoopProfiler`` (``PTT_LOOP_PROFILE=1``),
made from the loops' spans (``tracing``), which a profiler trace holds as
ranges.

With ``use_wandb`` the loop logs to Weights & Biases
(``training/wandb_logging.py``) where the JAX package does: each train row
on the ``log_wandb_step`` cadence with the histograms of that step's
predicted angles, the epoch metrics and summaries, the checkpoint
summaries, the structures, and once an epoch the histograms of every
parameter and of its gradient on a random train batch
(``_probe_gradients``, one more forward and backward). A cadence step's
predictions reach the host as its metrics row does, by a non-blocking copy
that the flush reads; with ``use_wandb`` off a step launches nothing more.

**Meshes** (``parallel/``; ``cfg.mesh_shape`` / ``mesh_axes``, as in the
JAX package). One process per device: the trainer joins the process group
the environment configures (``parallel.distributed.initialize_from_env``),
then lays the ranks out on the mesh. Over 'data' each rank takes its rows of
the same global batch (batches are padded to a multiple of the axis size);
over 'model' the attention heads and the feed-forward hidden units are
split Megatron-style and the parameters and Adam moments are slices
(``parallel/sharding.py``). The step keeps the JAX step's global-batch
semantics: every loss and metric is a global quotient, so each rank divides
its sums by the global counts (one all-reduce of ``losses.batch_counts``),
and the gradients and the packed metrics are summed over 'data' in one
all-reduce; the clip takes the norm of the full parameters. Every rank
therefore reads the same metrics, and the NaN watchdog, the plateau, early
stopping and the checkpoint policy decide alike. Dropout masks are drawn
per 'data' rank and alike on the 'model' ranks of one, so that a
replicated activation gets the same mask on each. Rank 0 alone writes the
CSV, config.json, wandb and structure files and the status line;
collective work (the gradient probe, structure predictions, checkpoint
gathers) runs on every rank. A checkpoint holds the full tensors, so it
restores under any layout.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import time

import numpy as np
import torch
from torch.func import functional_call

from protein_transformer_tpu_torch.training import metrics as M
from protein_transformer_tpu_torch.training import wandb_logging as W
from protein_transformer_tpu_torch import losses as L
from protein_transformer_tpu_torch import tracing
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data import device_store as DS
from protein_transformer_tpu_torch.data.dataset import (
    Batch, DataModule, collate, load_dataset)
from protein_transformer_tpu_torch.data.prefetch import prefetch
from protein_transformer_tpu_torch.models.enc_dec import (
    OUTPUT_GAIN, Transformer)
from protein_transformer_tpu_torch.models.factory import (
    make_model, model_args)
from protein_transformer_tpu_torch.models.transformer import (
    set_dropout_generator, set_model_parallel)
from protein_transformer_tpu_torch.parallel.distributed import (
    broadcast_one_to_all, initialize_from_env)
from protein_transformer_tpu_torch.parallel.mesh import (
    AxisGroup, make_mesh, replicate_tree, shard_batch)
from protein_transformer_tpu_torch.parallel.sharding import (
    assemble, gather_params, shard_layout, shard_params)
from protein_transformer_tpu_torch.ops import sidechain
from protein_transformer_tpu_torch.ops.drmsd import resolve_impl
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch
from protein_transformer_tpu_torch.training.structure_logging import (
    StructureLogger)
from protein_transformer_tpu_torch.training.checkpoint import (
    CheckpointManager, check_against, checkpoint_policy)
from protein_transformer_tpu_torch.training.optim import (
    EarlyStopping, OptState, PlateauState, make_optimizer, noam_schedule)
from protein_transformer_tpu_torch.utils import maybe_profile

DRMSD_LOSSES = ("drmsd", "lndrmsd", "combined")

# The trainer's four generator streams. Each is seeded cfg.seed + offset,
# taken mod 2^32 because a CPU generator keeps only the low 32 bits of a
# seed, with offset = stream * 2^30 + rank * 2^24 + step: the streams, 64
# 'data' ranks and 2^24 steps never share a seed. Dropout is stream 0, so
# rank 0's dropout seeds are cfg.seed + step. The gradient probe draws from
# streams of its own, and the generators' states are restored after it: a
# run trains the same with wandb on or off, as in the JAX package.
SEED_STREAMS = ("dropout", "sampling", "probe_dropout", "probe_sampling")
STREAM_STRIDE = 1 << 30
RANK_STRIDE = 1 << 24
MAX_DATA_RANKS = STREAM_STRIDE // RANK_STRIDE
MAX_STEPS = RANK_STRIDE


def stream_seed(seed: int, stream: str, rank: int, step: int) -> int:
    """The seed of ``stream`` for 'data' rank ``rank`` at ``step``; raises
    rather than let a rank or a step reach into another one's seeds."""
    if not 0 <= rank < MAX_DATA_RANKS:
        raise ValueError(f"'data' rank {rank}: the generator seeds keep "
                         f"{MAX_DATA_RANKS} ranks apart at most")
    if not 0 <= step < MAX_STEPS:
        raise ValueError(f"step {step}: the generator seeds keep "
                         f"{MAX_STEPS} (2^24) steps apart at most")
    offset = (SEED_STREAMS.index(stream) * STREAM_STRIDE + rank * RANK_STRIDE
              + step)
    return (seed + offset) % (1 << 32)

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


class LoopProfiler:
    """The report of ``PTT_LOOP_PROFILE=1``, printed at the end of each
    training epoch: host ms a step by phase, and what the phases leave
    unaccounted of the epoch's wall time. ``of`` fills it from the epoch's
    spans (``tracing``): each span name is a phase, at its own time (its
    children's taken out, so no time counts twice), and the steps are the
    ``train.step`` spans."""

    def __init__(self):
        self.t = {}
        self.steps = 0

    @classmethod
    def of(cls, session: dict) -> "LoopProfiler":
        spans = session["spans"]
        own = [(s["end_ns"] - s["start_ns"]) / 1e9 for s in spans]
        for s in spans:
            if s["parent"] >= 0:
                own[s["parent"]] -= (s["end_ns"] - s["start_ns"]) / 1e9
        prof = cls()
        for s, dt in zip(spans, own):
            if s["parent"] >= 0:  # the root is the wall time
                prof.add(s["name"], dt)
        prof.steps = session["count"].get("train.step", 0)
        return prof

    def add(self, phase: str, dt: float) -> None:
        self.t[phase] = self.t.get(phase, 0.0) + dt

    def report(self, wall: float) -> str:
        n = max(self.steps, 1)
        lines = [f"# loop profile: {self.steps} steps, "
                 f"{1e3 * wall / n:.2f} ms/step wall"]
        acct = 0.0
        for k, v in sorted(self.t.items(), key=lambda kv: -kv[1]):
            lines.append(f"#   {k:<18} {1e3 * v / n:6.2f} ms/step")
            acct += v
        lines.append(f"#   {'(unaccounted)':<18} "
                     f"{1e3 * (wall - acct) / n:6.2f} ms/step")
        return "\n".join(lines)


def compute_losses(model, params, batch: Batch, cfg: TrainConfig,
                   impl: str = "auto", with_drmsd=None, with_rmsd=False,
                   sidechain_impl: str = "auto", with_pred: bool = False,
                   counts=None):
    """All batch losses for a batch already on the model's device.

    Returns (loss, dict of scalar metrics); with_pred adds the (B, L, 24)
    predictions under "pred". MSE is always computed; the
    dRMSD family when the loss needs it or with_drmsd. impl selects the
    dRMSD pair sweep (see ops.drmsd.resolve_impl) and sidechain_impl the
    sidechain build (see ops.sidechain.resolve_impl). The model runs in
    whatever train/eval mode it is in: the train step puts it in train, the
    eval step in eval.

    Under ``grad_semantics="reference"`` with a dRMSD-family loss the
    returned loss keeps its value but carries the gradient of the sum over
    real proteins of per-protein ln-dRMSD (plus the MSE term of "combined"),
    as the original torch code stitched its gradients.

    ``counts``: when ``batch`` is one rank's rows of a global batch, the
    global batch's ``losses.batch_counts``. Every returned value is then
    this rank's share of the global batch's, and the shares (and their
    gradients) sum to it over the ranks; the padded dummy rows that all
    land on the last rank count for nothing."""
    if with_drmsd is None:
        with_drmsd = cfg.loss in DRMSD_LOSSES
    den = [None] * 4 if counts is None else counts
    pred = functional_call(model, params,
                           model_args(model, batch.seq, batch.ang))
    m_full = L.mse_over_angles(pred, batch.ang, batch.ang_mask, count=den[0])
    m_bb = L.mse_over_angles(pred, batch.ang, batch.ang_mask, bb_only=True,
                             count=den[1])
    m_sc = L.mse_over_angles(pred, batch.ang, batch.ang_mask, sc_only=True,
                             count=den[2])

    zero = torch.zeros((), dtype=m_full.dtype, device=m_full.device)
    out = {"mse-full": m_full, "mse-bb": m_bb, "mse-sc": m_sc,
           "drmsd-full": zero, "lndrmsd-full": zero, "drmsd-bb": zero,
           "lndrmsd-bb": zero, "combined-full": zero, "rmsd-full": zero}

    pred_crd = None
    if with_drmsd or with_rmsd:
        pred_crd = build_coords_batch(L.inverse_trig_transform(pred),
                                      batch.seq, sidechain_impl)

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
            backbone_only=bb_only, n_proteins=den[3])
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
                batch.crd_mask[:, :, :3], batch.protein_mask, den[3])
        else:
            out["rmsd-full"] = L.batch_rmsd(pred_crd, batch.crd,
                                            batch.crd_mask,
                                            batch.protein_mask, den[3])
    out["loss"] = loss
    if with_pred:
        out["pred"] = pred
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
    """The training and evaluation steps, the epoch loops and the host loop
    (``train``) on one explicit device: this rank's, under a mesh."""

    # steps kept in flight before their metric rows are recorded; the NaN
    # watchdog and the CSV rows trail the device by at most this many steps
    FLUSH_EVERY = 32

    def __init__(self, cfg: TrainConfig, device: torch.device,
                 data: dict | None = None, use_mesh: bool = True):
        # join the process group the environment configures (a no-op for
        # one process) before anything else touches the device
        self.process_index, self.process_count = initialize_from_env(device)
        self.cfg = cfg = cfg.finalize()
        self.device = torch.device(device)
        self.mesh = (make_mesh(cfg.mesh_shape, cfg.mesh_axes, self.device)
                     if use_mesh else None)
        self.data_axis = (self.mesh.axis("data") if self.mesh
                          else AxisGroup(1, 0))
        self.model_axis = (self.mesh.axis("model") if self.mesh
                           else AxisGroup(1, 0))
        self.drmsd_impl = resolve_impl(cfg.drmsd_impl, self.device)
        self.sidechain_impl = sidechain.resolve_impl(cfg.sidechain_impl,
                                                     self.device)
        data = data if data is not None else load_dataset(cfg.data)
        self.dm = DataModule(data, cfg, batch_multiple=self.data_axis.size)
        # the monitored metric's mode must be one this run evaluates:
        # otherwise the first epoch end raises KeyError after a full epoch
        if cfg.es_mode != "train":
            if cfg.train_only:
                raise ValueError(
                    f"--early_stopping_metric {cfg.early_stopping_metric!r} "
                    "monitors a validation split but --train_only never "
                    "evaluates one")
            if cfg.es_mode == "test" or cfg.es_mode not in self.dm.eval_splits:
                raise ValueError(
                    f"--early_stopping_metric {cfg.early_stopping_metric!r}: "
                    f"split {cfg.es_mode!r} is not evaluated during training "
                    f"(available: train, "
                    f"{', '.join(s for s in self.dm.eval_splits if s != 'test')})")
        angle_means = (np.zeros(24, np.float32) if cfg.without_angle_means
                       else self.dm.angle_means)
        self.model = make_model(cfg, angle_means).to(self.device).eval()
        set_model_parallel(self.model, self.model_axis)
        # {parameter name: its sharded dim} of the parameters that are
        # slices over 'model'
        self.layout = shard_layout(self.model, self.model_axis.size)
        # every dropout mask of the model is drawn from this generator
        self.dropout_generator = torch.Generator(device=self.device)
        if self.data_axis.size > MAX_DATA_RANKS:
            raise ValueError(f"{self.data_axis.size} 'data' ranks: the "
                             f"generator seeds keep {MAX_DATA_RANKS} apart "
                             "at most")
        self.dropout_generator.manual_seed(self._seed("dropout", 0))
        set_dropout_generator(self.model, self.dropout_generator)
        # the encoder-decoder's scheduled-sampling draws: a stream of their
        # own, on the host, where they decide which decoder passes run
        self.sampling_generator = torch.Generator()
        self.sampling_generator.manual_seed(self._seed("sampling", 0))
        if isinstance(self.model, Transformer):
            self.model.sampling_generator = self.sampling_generator
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
        self.tx.shard(set(self.layout), self.model_axis)
        self.early_stop = EarlyStopping(patience=cfg.early_stopping,
                                        threshold=cfg.early_stopping_threshold)
        self.start_epoch = 0
        self.start_time = time.time()
        self._best_history: list = []
        modes = ["train", "test"] + [f"valid-{s}"
                                     for s in (10, 20, 30, 40, 50, 70, 90)]
        self.metrics = M.init_metrics(modes)

        # The device-resident data path: budget only the stores this run
        # builds (a train_only run builds no eval-split store). A store that
        # cannot be built raises, also under device_data true.
        self.train_store = None
        self._eval_stores: dict = {}
        splits = ([self.dm.train] if cfg.train_only else
                  [self.dm.train, *self.dm.eval_splits.values()])
        self.use_device_data = DS.auto_enabled(
            cfg, splits, self.process_count, has_mesh=self.mesh is not None,
            n_data=self.data_axis.size)
        if self.use_device_data:
            self.train_store = DS.DeviceStore(self.dm.train, self.device,
                                              self.mesh)
        # host batches are copied to a GPU on a stream of their own
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

        self.out_dir = os.path.join(cfg.out_dir, cfg.name or "run")
        os.makedirs(self.out_dir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(self.out_dir,
                                                   "checkpoints"))
        self.structure_logger = StructureLogger(self.out_dir,
                                                save_pngs=cfg.save_pngs)
        # the wandb run, made by the first train() with use_wandb
        self.wandb_run = None
        # live per-batch status line; --cluster disables it, otherwise it is
        # on for an interactive stderr (on rank 0 only)
        self.batch_status = M.BatchStatus(
            cfg.loss, cfg.lr_scheduling,
            enabled=(False if cfg.cluster or self.process_index != 0
                     else None))
        # config and angle means, for predict and analysis tooling
        if self.process_index == 0:
            with open(os.path.join(self.out_dir, "config.json"), "w") as f:
                json.dump({"config": cfg.to_dict(),
                           "angle_means": [float(a) for a in angle_means]},
                          f, indent=1, default=str)

    def _seed(self, stream: str, step: int) -> int:
        """The seed of one of ``SEED_STREAMS`` at ``step``. The dropout
        streams are this 'data' rank's, the same on every 'model' rank of
        it; the sampling streams are rank 0's on every rank, since their
        draws decide which decoder passes run, and those must agree."""
        rank = self.data_axis.rank if stream.endswith("dropout") else 0
        return stream_seed(self.cfg.seed, stream, rank, step)

    # ---------------- state init / restore ----------------

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh full parameters, drawn on the CPU from ``generator`` and
        moved to the device, initialised as the flax modules are:
        xavier-uniform weights (Linear, Conv1d, Embedding), zero biases, unit
        LayerNorm scales, and the output head: the angle-mean bias under a
        zero weight (encoder models) or a tiny-gain Xavier weight
        (encoder-decoder)."""
        params = {}
        for name, p in self.model.named_parameters():
            t = torch.empty(p.shape, dtype=p.dtype)
            if name.endswith("norm.weight"):
                t.fill_(1.0)
            elif name.endswith("output_projection.bias"):
                t.copy_(p.detach().cpu())  # angle-mean bias, set at build
            elif name == "output_projection.weight":
                torch.nn.init.xavier_uniform_(t, gain=OUTPUT_GAIN,
                                              generator=generator)
            elif name.endswith("bias") or name.startswith("head."):
                t.zero_()
            else:
                torch.nn.init.xavier_uniform_(t, generator=generator)
            params[name] = t.to(self.device)
        return params

    def state_from(self, params: dict) -> TrainState:
        """Step 0 from copies of the full ``params`` on the device (rank 0's
        under a mesh, this rank's slices of them under 'model'), with a
        fresh optimizer state in the same layout."""
        params = replicate_tree({k: v.detach().to(self.device).clone()
                                 for k, v in params.items()}, self.mesh)
        params = {k: v.requires_grad_() for k, v in shard_params(
            params, self.layout, self.model_axis).items()}
        return TrainState(params, self.tx.init(params), 0)

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Step 0 from fresh parameters drawn from ``generator``."""
        return self.state_from(self.init_params(generator))

    def maybe_restore(self, state: TrainState) -> TrainState:
        """Resume from the 'best' checkpoint (or ``load_chkpt``) unless
        ``restart``; with ``restart_opt`` the weights and the step are
        restored and the optimizer state stays fresh. Also restores the
        epoch, the elapsed time, the plateau and early-stopping machines and
        the loss history from the JSON sidecar; a missing sidecar degrades
        to epoch-0 bookkeeping with the weights restored.

        The checkpoint holds no random state, as in the JAX package, whose
        dropout keys are a function of the seed and the step. The port's
        dropout generator is reseeded here with ``seed + step`` (and the
        sampling generator likewise, from its own base), so a resumed run
        draws masks that depend on where it resumes and does not replay
        those of the run's first steps; it does not continue the interrupted
        run's stream. The checkpoint holds the full tensors; each rank takes
        its slices of them."""
        cfg = self.cfg
        modifier = cfg.load_chkpt or "best"
        if cfg.restart or not self.ckpt.exists(modifier):
            return state
        if cfg.restart_opt:
            # the saved optimizer state may belong to another optimizer or
            # schedule, and must not be required to match
            arrays, meta = self.ckpt.restore_raw(modifier, self.device)
            opt_state = state.opt_state
        else:
            template = self._full_arrays(state)
            arrays, meta = self.ckpt.restore_raw(modifier, self.device)
            saved = arrays["opt_state"]
            if any(set(saved[moment]) != set(template["opt_state"][moment])
                   for moment in ("mu", "nu")):
                raise ValueError(
                    f"checkpoint {modifier!r}: its optimizer state does not "
                    f"fit -opt {cfg.optimizer} (its moments name "
                    f"{len(saved['mu'])} parameters, the live optimizer's "
                    f"{len(state.opt_state.mu)}); pass --restart_opt to "
                    f"resume from its weights with a fresh optimizer")
            check_against(template, arrays, repr(modifier))
            # the moments are stored by parameter name, the optimizer holds
            # them as lists in the live parameters' order
            mu, nu = (shard_params(saved[m], self.layout, self.model_axis)
                      for m in ("mu", "nu"))
            opt_state = OptState(saved["count"],
                                 [mu[k] for k in state.params],
                                 [nu[k] for k in state.params])
        params = shard_params({k: arrays["params"][k].to(self.device)
                               for k in state.params}, self.layout,
                              self.model_axis)
        params = {k: v.requires_grad_() for k, v in params.items()}
        step = int(arrays["step"])
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.start_time -= float(meta.get("elapsed", 0.0))
        if self.plateau and meta.get("plateau"):
            self.plateau.load_state_dict(dict(meta["plateau"]))
        if meta.get("early_stop"):
            self.early_stop.load_state_dict(dict(meta["early_stop"]))
        self._best_history = list(meta.get("best_history", []))
        self.dropout_generator.manual_seed(self._seed("dropout", step))
        self.sampling_generator.manual_seed(self._seed("sampling", step))
        print(f"[Info] Resumed from '{modifier}' at epoch {self.start_epoch}.")
        return TrainState(params, opt_state, step)

    # ---------------- steps ----------------

    def current_lr(self, step: int) -> float:
        """The learning rate of the update after ``step`` updates."""
        if self.lr_schedule is not None:
            return self.lr_schedule(step)
        return self.cfg.learning_rate * (self.plateau.scale if self.plateau
                                         else 1.0)

    def _put(self, batch, non_blocking: bool = False) -> Batch:
        """A batch on the device: a host batch's rows of this rank under a
        mesh with more than one 'data' rank, all of them otherwise; a batch
        already on the device as it is."""
        if self.data_axis.size > 1 and isinstance(batch.seq, np.ndarray):
            return shard_batch(batch, self.mesh, non_blocking)
        return batch.to(self.device, non_blocking=non_blocking)

    def _global_counts(self, batch: Batch):
        """The global batch's loss denominators (``losses.batch_counts``,
        summed over 'data') in a run with a process group, else None."""
        if self.data_axis.group is None:
            return None
        return self.data_axis.all_reduce(
            L.batch_counts(batch.ang_mask, batch.protein_mask))

    def _sum_over_data(self, tensors) -> list:
        """``tensors`` summed over the 'data' axis, in one all-reduce of
        their concatenation."""
        tensors = list(tensors)
        if self.data_axis.group is None:
            return tensors
        flat = self.data_axis.all_reduce(
            torch.cat([t.reshape(-1) for t in tensors]))
        return [part.view_as(t) for part, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)]

    def loss_and_grads(self, params: dict, batch: Batch,
                       with_pred: bool = False):
        """(loss, metrics dict, gradients in the params' order) of one batch
        already on the device, with the model in train mode; with_pred puts
        the predictions in the dict. Under a mesh the loss and metrics are
        this rank's shares of the global batch's, and the gradients are
        this rank's share too: ``train_step`` sums them over 'data'. The
        loss and the metrics come back detached: the step's graph is
        released here, with the backward that consumed it."""
        with tracing.span("train.forward"):
            self.model.train()
            loss, out = compute_losses(self.model, params, batch, self.cfg,
                                       impl=self.drmsd_impl,
                                       sidechain_impl=self.sidechain_impl,
                                       with_pred=with_pred,
                                       counts=self._global_counts(batch))
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            loss, out = loss.detach(), {k: v.detach() for k, v in out.items()}
        return loss, out, grads

    def train_step(self, state: TrainState, batch: Batch,
                   lr_scale: float = 1.0, with_pred: bool = False) -> tuple:
        """One optimizer update on one batch (moved to the device here, a
        no-op for a batch already there):
        forward in train mode, backward, then the update, in place on
        ``state.params``. Returns the new state and the packed (K,) metrics
        vector of the batch, still on the device; with_pred also the
        batch's (B, L, 24) predictions, detached, as a third element. Under
        a mesh the metrics and the predictions are the global batch's.
        Raises before an update that would take the step count to
        ``MAX_STEPS``, where the generator seeds would wrap."""
        if state.step + 1 >= MAX_STEPS:
            raise ValueError(f"step {state.step + 1}: the generator seeds "
                             f"keep {MAX_STEPS} (2^24) steps apart at most")
        _, out, grads = self.loss_and_grads(
            state.params, self._put(batch), with_pred=with_pred)
        *grads, metrics = self._sum_over_data([*grads, pack_metrics(out)])
        with tracing.span("train.optimizer"):
            opt_state = self.tx.update(state.params, grads, state.opt_state,
                                       lr_scale)
        new = (TrainState(state.params, opt_state, state.step + 1), metrics)
        if not with_pred:
            return new
        return (*new, assemble(out["pred"].detach(), 0, self.data_axis))

    @torch.inference_mode()
    def eval_step(self, params: dict, batch: Batch) -> torch.Tensor:
        """Packed (K,) metrics of one batch (moved to the device here, a
        no-op for a batch already there); the global batch's under a
        mesh."""
        self.model.eval()
        batch = self._put(batch)
        _, out = compute_losses(self.model, params, batch,
                                self.cfg, impl=self.drmsd_impl,
                                with_drmsd=True, with_rmsd=True,
                                sidechain_impl=self.sidechain_impl,
                                counts=self._global_counts(batch))
        return self._sum_over_data([pack_metrics(out)])[0]

    def _probe_gradients(self, state: TrainState) -> dict:
        """Full gradients, keyed like the parameters, of one forward and
        backward in train mode on a random train batch: the epoch's
        gradient histograms. The rows are the JAX package's (drawn from
        ``seed + step``); the batch is collated on the host and copied
        without blocking; the dropout and sampling draws come from the
        trainer's generators, reseeded on the probe's streams at ``step``
        and given their streams back afterwards. Under a mesh every
        rank must call it: the gradients are summed over 'data' and
        gathered over 'model'."""
        cfg = self.cfg
        n = min(cfg.batch_size, len(self.dm.train))
        rng = np.random.default_rng(cfg.seed + state.step)
        idx = rng.choice(len(self.dm.train), size=n, replace=False)
        batch = collate(self.dm.train, idx, cfg.bucket_sizes,
                        self.dm.max_seq_len,
                        batch_multiple=self.dm.batch_multiple)
        gens = (self.dropout_generator, self.sampling_generator)
        saved = [g.get_state() for g in gens]
        self.dropout_generator.manual_seed(
            self._seed("probe_dropout", state.step))
        self.sampling_generator.manual_seed(
            self._seed("probe_sampling", state.step))
        try:
            _, _, grads = self.loss_and_grads(
                state.params, self._put(batch, non_blocking=True))
        finally:
            for g, st in zip(gens, saved):
                g.set_state(st)
        return gather_params(dict(zip(state.params,
                                      self._sum_over_data(grads))),
                             self.layout, self.model_axis)

    # ---------------- structure logging ----------------

    @torch.no_grad()
    def _log_structure(self, params: dict, batch: Batch, step: int,
                       name: str = "train") -> None:
        """Predict the last real protein of a batch in eval mode, build its
        coordinates on the device and hand them to the structure logger,
        whose worker thread makes the copies to the host. ``batch`` is a host
        batch or a ``LazyBatch``, whose fields the first access gathers
        once on the device (its ``protein_mask`` is the plan's host array:
        the index reads nothing from the device). A host batch's rows go to
        the device without waiting for it (``non_blocking``: the copy from
        pageable memory is staged before it returns). Under a mesh every
        rank predicts (the model's collectives need them all) and rank 0
        alone logs."""
        idx = max(int(batch.protein_mask.sum()) - 1, 0)
        seq = torch.as_tensor(batch.seq[idx:idx + 1]).to(
            self.device, non_blocking=True).long()
        ang = torch.as_tensor(batch.ang[idx:idx + 1]).to(
            self.device, non_blocking=True)
        was_training = self.model.training
        self.model.eval()
        pred = functional_call(self.model, params,
                               model_args(self.model, seq, ang))
        self.model.train(was_training)
        crd = build_coords_batch(L.inverse_trig_transform(pred), seq,
                                 self.sidechain_impl)
        if self.process_index == 0:
            self.structure_logger.log(step, name, batch.seq[idx], crd[0],
                                      batch.crd[idx], batch.crd_mask[idx])

    def _log_validation_structures(self, params: dict, step: int) -> None:
        """Log the middle protein of each validation split."""
        for split, ds in self.dm.eval_splits.items():
            if split == "test" or len(ds) == 0:
                continue
            batch = collate(ds, np.array([len(ds) // 2]),
                            self.cfg.bucket_sizes, self.dm.max_seq_len,
                            batch_multiple=self.dm.batch_multiple)
            self._log_structure(params, batch, step,
                                name=f"V{split.split('-')[-1]}")

    # ---------------- epoch loops ----------------

    def _process_train_outputs(self, out_host: dict, n_res: int, step: int,
                               t_dispatch: float, logger,
                               logged=None) -> None:
        """Host-side bookkeeping of one fetched training row: the NaN
        watchdog, the metrics, the status line and the CSV row; for a step
        on the wandb cadence (``logged``: its real proteins, its fetched
        predictions and its host sequence ids) the wandb row and the
        predicted-angle histograms."""
        if not np.isfinite(out_host["loss"]):
            raise FloatingPointError(
                "A nan loss has occurred. Exiting training.")
        self.metrics["history-lr"].append(self.current_lr(step))
        self.metrics = M.update_batch(self.metrics, "train", out_host, n_res,
                                      now=t_dispatch)
        self.batch_status.update_train(self.metrics)
        if logger:
            logger.log(self.metrics, "train", self.start_time)
        if logged is not None:
            n_real, pred, seq = logged
            W.log_train_batch(self.wandb_run, out_host, n_real,
                              self.metrics["train"]["speed"],
                              lr=self.metrics["history-lr"][-1])
            W.log_angle_histograms(self.wandb_run, pred.numpy(), seq,
                                   self.cfg.pad_id)

    def _start_fetch(self, out: torch.Tensor, host_rows, slot: int,
                     pred: torch.Tensor | None = None):
        """Begin moving one step's metrics vector (and ``pred``, the
        step's predictions, on the wandb cadence) to the host without
        waiting for the device: (host tensor, event to poll or None when
        the values are there already, host predictions or None)."""
        if out.device.type != "cuda":
            return out, None, pred
        host_rows[slot].copy_(out, non_blocking=True)
        if pred is not None:
            # a pinned slot of its own; the caching host allocator keeps it
            # until the copy has landed
            pred_host = torch.empty(pred.shape, dtype=pred.dtype,
                                    pin_memory=True)
            pred = pred_host.copy_(pred, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host_rows[slot], event, pred

    # ---------------- data streams ----------------

    def _device_stream(self, split_obj, store: DS.DeviceStore, index_iter):
        """(LazyBatch, device Batch) pairs for the device-data path: the
        plan and the LazyBatch's host fields on the host, the batch one
        gather on the device."""
        for idx in index_iter:
            plan = DS.plan_batch(split_obj, idx, self.cfg.bucket_sizes,
                                 self.dm.max_seq_len, self.dm.batch_multiple)
            yield DS.LazyBatch(store, plan), store.batch(plan)

    def _transfer(self, batch: Batch):
        """(host batch, device batch, event or None); runs on the prefetch
        thread. On a GPU the fields go from pinned memory, without blocking,
        on the copy stream, and the event marks their arrival."""
        if self.device.type != "cuda":
            return batch, self._put(batch), None
        with torch.cuda.stream(self._copy_stream):
            dev = self._put(batch, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return batch, dev, event

    def _host_stream(self, batch_iter):
        """(host batch, device batch) pairs: collate and the transfer run
        ahead on the prefetch thread; the step's stream waits for each
        batch's copies, and the caching allocator learns that the step's
        stream uses them."""
        for host, dev, event in prefetch(batch_iter, size=2,
                                         transform=self._transfer):
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for field in dataclasses.fields(dev):
                    value = getattr(dev, field.name)
                    if isinstance(value, torch.Tensor):
                        value.record_stream(stream)
            yield host, dev

    def _eval_store(self, split: str) -> DS.DeviceStore:
        if split not in self._eval_stores:
            self._eval_stores[split] = DS.DeviceStore(
                self.dm.eval_splits[split], self.device, self.mesh)
        return self._eval_stores[split]

    def _eval_batch_stream(self, split: str):
        """Eval batches for a split via whichever data path is active."""
        if self.use_device_data:
            return self._device_stream(self.dm.eval_splits[split],
                                       self._eval_store(split),
                                       self.dm.eval_index_batches(split))
        return self.dm.eval_batches(split)

    def train_epoch(self, state: TrainState, logger=None) -> TrainState:
        """One epoch over the binned sampler's batches (drawn from
        ``seed + step``), with the plateau scale on the learning rate;
        returns the new state and keeps the "train" metrics. Batches come
        from the device store when it is on, else prefetched host batches.

        Up to FLUSH_EVERY steps stay in flight: each step's metrics vector
        starts a non-blocking copy to pinned host memory, and the rows are
        recorded once per window, each timed at an even share of the
        window. The NaN watchdog does not wait for the window: after every
        step it reads the rows whose copies have arrived, oldest first, and
        a loss that is not finite raises FloatingPointError at once, after
        the rows before it are recorded. The loop's phases are spans
        (``tracing``); under PTT_LOOP_PROFILE=1 their host time a step is
        reported on stderr (``LoopProfiler``)."""
        mode = "train"
        self.metrics = M.reset_for_epoch(self.metrics, mode)
        step = state.step
        rng = np.random.default_rng(self.cfg.seed + step)
        lr_scale = self.plateau.scale if self.plateau else 1.0
        if self.train_store is not None:
            batches = self._device_stream(self.dm.train, self.train_store,
                                          self.dm.train_index_batches(rng))
        else:
            batches = self._host_stream(self.dm.train_batches(rng))
        host_rows = (torch.empty((self.FLUSH_EVERY, len(METRIC_KEYS)),
                                 pin_memory=True)
                     if self.device.type == "cuda" else None)
        # steps on the wandb cadence also fetch their predictions, which
        # every rank gathers when rank 0 logs
        logs_wandb = self.wandb_run is not None
        if self.process_count > 1:
            logs_wandb = broadcast_one_to_all(logs_wandb)
        wandb_every = max(self.cfg.log_wandb_step, 1) if logs_wandb else 0
        # pending entries: [host tensor, event | None, n_res, step,
        # row | None, wandb's (real proteins, predictions, seq ids) | None]
        pending: list = []
        t_last_flush = time.time()

        def drain(rows) -> None:
            """Record fetched rows, each at an even share of the time since
            the last flush."""
            dt = (time.time() - t_last_flush) / max(len(rows), 1)
            for i, (_, _, n_res, step_i, row, logged) in enumerate(rows):
                self._process_train_outputs(
                    unpack_metrics(row), n_res, step_i,
                    t_last_flush + (i + 1) * dt, logger, logged)

        def check_ready() -> None:
            for j, p in enumerate(pending):
                if p[4] is not None:
                    continue
                if p[1] is not None and not p[1].query():
                    break  # steps finish in order: later ones wait too
                p[4] = p[0].numpy().copy()
                if not np.isfinite(p[4][0]):  # METRIC_KEYS[0] == "loss"
                    drain(pending[:j + 1])  # raises at row j

        def flush() -> None:
            nonlocal pending, t_last_flush
            for p in pending:
                if p[4] is None:
                    if p[1] is not None:
                        with tracing.wait("train.flush"):
                            p[1].synchronize()
                    p[4] = p[0].numpy().copy()
            drain(pending)
            t_last_flush = time.time()
            pending = []

        cfg = self.cfg
        with tracing.epoch("train.epoch", step):
            batch_it = iter(batches)
            while True:
                with tracing.span("train.batch", step):
                    nxt = next(batch_it, None)
                if nxt is None:
                    break
                batch, payload = nxt
                if wandb_every and step % wandb_every == 0:
                    with tracing.span("train.step", step):
                        state, out, pred = self.train_step(
                            state, payload, lr_scale, with_pred=True)
                    with tracing.span("train.fetch", step):
                        host, event, pred = self._start_fetch(
                            out, host_rows, len(pending), pred)
                    # the host's own ids: a LazyBatch's seq would gather
                    logged = (int(batch.protein_mask.sum()), pred,
                              batch.host_seq
                              if isinstance(batch, DS.LazyBatch)
                              else batch.seq)
                else:
                    with tracing.span("train.step", step):
                        state, out = self.train_step(state, payload,
                                                     lr_scale)
                    with tracing.span("train.fetch", step):
                        host, event, _ = self._start_fetch(out, host_rows,
                                                           len(pending))
                    logged = None
                pending.append([host, event, batch.n_res, step, None,
                                logged])
                with tracing.span("train.watchdog", step):
                    check_ready()
                # at dispatch, so the logged parameters are those after this
                # step's update, labelled with its number
                log_train = (cfg.log_structure_step
                             and step % cfg.log_structure_step == 0)
                log_val = (cfg.log_val_struct_step
                           and step % cfg.log_val_struct_step == 0)
                if log_train or log_val:
                    with tracing.span("train.structure_log", step):
                        if log_train:
                            self._log_structure(state.params, batch, step)
                        if log_val:
                            self._log_validation_structures(state.params,
                                                            step)
                step += 1
                if len(pending) >= self.FLUSH_EVERY:
                    with tracing.span("train.flush", step - 1):
                        flush()
            if pending:
                with tracing.span("train.flush", step - 1):
                    flush()
        if tracing.switched_on():
            session = tracing.last_session()
            print(LoopProfiler.of(session).report(
                session["total_ms"]["train.epoch"] / 1e3), file=sys.stderr)
        self.batch_status.clear()
        self.metrics = M.end_of_epoch(self.metrics, mode)
        return state

    def eval_epoch(self, params: dict, mode: str, batches=None,
                   logger=None) -> dict:
        """Evaluate ``batches`` and keep the result under ``mode``; returns
        that metrics dict. ``batches``: host Batch objects (collated; they
        go through the prefetch thread and the copy stream), or the
        (LazyBatch, device Batch) pairs of the device-data path; by default
        the split ``mode`` through whichever data path is active. Metric
        vectors stay on the device and are fetched every FLUSH_EVERY steps
        in one copy."""
        self.metrics = M.reset_for_epoch(self.metrics, mode)
        if batches is None:
            batches = self._eval_batch_stream(mode)

        def flush() -> None:
            nonlocal pending, t_last_flush
            rows = torch.stack([p[0] for p in pending])
            with tracing.wait("eval.flush"):
                rows = rows.cpu()
            rows = rows.numpy()
            t_now = time.time()
            dt = (t_now - t_last_flush) / len(pending)
            for i, (row, (_, n_res)) in enumerate(zip(rows, pending)):
                self.metrics = M.update_batch(self.metrics, mode,
                                              unpack_metrics(row), n_res,
                                              now=t_last_flush + (i + 1) * dt)
            self.batch_status.update_eval(mode, self.metrics)
            t_last_flush = t_now
            pending = []

        with tracing.epoch("eval.epoch", 0):
            it = iter(batches)
            with tracing.span("eval.batch", 0):
                first = next(it, None)
            chained = (itertools.chain([first], it) if first is not None
                       else iter(()))
            pairs = iter(self._host_stream(chained)
                         if isinstance(first, Batch) else chained)
            pending: list = []
            t_last_flush = time.time()
            i = 0
            while True:
                with tracing.span("eval.batch", i):
                    nxt = next(pairs, None)
                if nxt is None:
                    break
                batch, payload = nxt
                with tracing.span("eval.step", i):
                    out = self.eval_step(params, payload)
                pending.append((out, batch.n_res))
                i += 1
                if len(pending) >= self.FLUSH_EVERY:
                    with tracing.span("eval.flush", i - 1):
                        flush()
            if pending:
                with tracing.span("eval.flush", i - 1):
                    flush()
        self.batch_status.clear()
        self.metrics = M.end_of_epoch(self.metrics, mode)
        if logger:
            logger.log(self.metrics, mode, self.start_time,
                       end_of_epoch=True)
        W.log_eval_epoch(self.wandb_run, mode, self.metrics[mode])
        W.log_final_epoch_summary(self.wandb_run, mode, self.metrics[mode])
        return self.metrics[mode]

    # ---------------- checkpointing ----------------

    @staticmethod
    def _arrays(state: TrainState) -> dict:
        """What a checkpoint holds of a state: tensors and plain Python
        values only, the optimizer's moments keyed by parameter name (empty
        for SGD)."""
        opt = state.opt_state
        return {"params": state.params,
                "opt_state": {"count": opt.count,
                              "mu": dict(zip(state.params, opt.mu)),
                              "nu": dict(zip(state.params, opt.nu))},
                "step": state.step}

    def _full_arrays(self, state: TrainState) -> dict:
        """``_arrays`` of the full tensors: under 'model' the slices of the
        parameters and moments gathered, which every rank must call."""
        arrays = self._arrays(state)
        if self.layout:
            arrays["params"] = gather_params(arrays["params"], self.layout,
                                             self.model_axis)
            for m in ("mu", "nu"):
                arrays["opt_state"][m] = gather_params(
                    arrays["opt_state"][m], self.layout, self.model_axis)
        return arrays

    def _monitored_metric(self) -> float:
        cfg = self.cfg
        return self.metrics[cfg.es_mode][f"epoch-{cfg.es_metric}-full"]

    def _save_checkpoint(self, state: TrainState, epoch: int,
                         cur_loss: float, history: list) -> None:
        modifier = checkpoint_policy(cur_loss, history,
                                     self.metrics["last_chkpt_time"],
                                     self.cfg.checkpoint_time_interval,
                                     process_count=self.process_count)
        if modifier is None:
            return
        meta = {"epoch": epoch,
                "elapsed": time.time() - self.start_time,
                "plateau": (self.plateau.state_dict()
                            if self.plateau else {}),
                "early_stop": self.early_stop.state_dict(),
                "best_history": list(history)}
        arrays = self._full_arrays(state)
        if self.process_index == 0:
            self.ckpt.save(modifier, arrays, meta)
        self.metrics["last_chkpt_time"] = time.time()
        W.log_checkpoint_summary(self.wandb_run, modifier, cur_loss, epoch,
                                 self.metrics, self.cfg.train_only)
        print(f"    - [Info] checkpoint '{modifier}' updated.")

    # ---------------- main loop ----------------

    def train(self, state: TrainState | None = None) -> TrainState:
        """The host loop: from ``state``, or from fresh parameters (drawn
        from the config's seed) and the checkpoint ``maybe_restore`` finds,
        train epochs ``start_epoch .. epochs - 1``; after each, the
        ``--eval_train`` pass and the validation splits, the plateau step
        and the early-stopping update on the monitored metric, and the
        checkpoint the policy asks for; the test split at the end. With
        ``profile_dir`` the first trained epoch is traced there
        (``utils.maybe_profile``). With ``use_wandb`` the first call opens
        the wandb run (``training/wandb_logging.py``), each epoch ends with
        the gradient probe's histograms, and the run is finished at the
        end. Under a mesh rank 0 alone writes the CSV and wandb."""
        cfg = self.cfg
        if state is None:
            state = self.init_state(torch.Generator().manual_seed(cfg.seed))
            state = self.maybe_restore(state)
        if (self.wandb_run is None and cfg.use_wandb
                and self.process_index == 0):
            n_params = sum(p.numel() for p in self.model.parameters())
            self.wandb_run = W.try_init_wandb(cfg, n_params,
                                              self.dm.angle_means)
            self.structure_logger.wandb_run = self.wandb_run
            W.save_model_txt(self.wandb_run, self.model, self.out_dir)
            W.mirror_run_files(self.wandb_run, self.out_dir)
        logger = (M.CsvLogger(
            os.path.join(self.out_dir, (cfg.name or "run") + ".train"),
            cfg.loss, resume=self.start_epoch > 0)
            if self.process_index == 0 else None)
        history = self._best_history

        for epoch in range(self.start_epoch, cfg.epochs):
            print(f"[ Epoch {epoch} ]")
            start = time.time()
            with maybe_profile(cfg.profile_dir if epoch == self.start_epoch
                               else None):
                state = self.train_epoch(state, logger)
            if cfg.eval_train:
                te_rng = np.random.default_rng(epoch)
                te_batches = (self._device_stream(
                    self.dm.train, self.train_store,
                    self.dm.train_eval_index_batches(te_rng))
                    if self.train_store is not None
                    else self.dm.train_eval_batches(te_rng))
                self.eval_epoch(state.params, "train", te_batches, logger)
            M.print_epoch_status("train", self.metrics, start)
            if logger:
                logger.log(self.metrics, "train", self.start_time,
                           end_of_epoch=True)
            W.log_final_epoch_summary(self.wandb_run, "train",
                                      self.metrics["train"])
            if cfg.use_wandb:
                # the epoch's parameter and gradient histograms; the probe
                # runs whenever wandb is asked for, as in the JAX package
                grads = self._probe_gradients(state)
                params = gather_params(state.params, self.layout,
                                       self.model_axis)
                W.watch_params(self.wandb_run, self.model, params,
                               grads=grads)

            if not cfg.train_only:
                splits = [s for s in self.dm.eval_splits if s != "test"]
                for split in splits:
                    start = time.time()
                    self.eval_epoch(state.params, split, logger=logger)
                    M.print_epoch_status(split, self.metrics, start)
                W.log_avg_validation(self.wandb_run, self.metrics, splits)

            # LR plateau scheduling on the monitored metric
            monitored = self._monitored_metric()
            if self.plateau is not None:
                self.plateau.step(monitored)

            history.append(monitored)
            stop = self.early_stop.update(epoch, monitored)
            self._save_checkpoint(state, epoch, monitored, history)
            if stop:
                print(f"No improvement for {cfg.early_stopping} epochs. "
                      "Stopping model training early.")
                W.log_early_stop(self.wandb_run)
                break

        if not cfg.train_only and "test" in self.dm.eval_splits:
            start = time.time()
            self.eval_epoch(state.params, "test", logger=logger)
            M.print_epoch_status("test", self.metrics, start)
        if logger:
            logger.close()
        self.structure_logger.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()
        return state
