"""Optimizers and learning-rate schedules in PyTorch.

Port of protein_transformer_tpu/training/optim.py, whose optax chain it
follows step for step:

1. clip by global norm: scale by clip / norm when norm > clip (optax's
   form; ``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6);
2. weight decay 1e-2 added to the gradient, coupled, before the moments;
3. Adam(0.9, 0.98, eps 1e-9) with bias correction and eps outside the
   sqrt, or plain SGD;
4. times the learning rate (a float, or a schedule of the update count),
   times the plateau scale that the trainer passes.

Parameters are a dict of tensors, updated in place under ``no_grad`` (the
JAX package donates their buffers to the same end). Under tensor
parallelism (``shard``) a rank holds slices of some of them; the clip then
takes the norm of the full parameters, as the JAX step does: the square
sums of the sliced gradients are summed over the 'model' axis, and the
replicated ones are counted once. The moments take their parameter's
layout. The step count lives on the host, so the learning rate and the
bias corrections are host floats and the update never reads the device.

Two paths, chosen by the parameters' device (``ops.adam.resolve_impl``):

* CUDA tensors take the hand-written kernel (``ops/adam.py``, K6): one
  pass over the gradients for the norm, then one pass that clips, decays,
  moves the moments and updates every parameter, 32 bytes a parameter in
  two launches, with no temporaries and no wait for the device. It adds
  the parameters it hands the kernel to the counter
  ``optim.fused_params``, a host number.
* CPU tensors (and ``impl="torch"``) take the multi-tensor
  ``torch._foreach_*`` chain, the kernel's plain version: a launch count
  flat in the number of parameter tensors, but a pass over memory an
  operation. Its update after the clip runs over groups of at most
  ``GROUP_BYTES`` of parameters, so that a model of billions of
  parameters does not hold three full-size temporaries at once. The
  kernel makes none, so the groups serve this path alone, where it runs
  at that size: on the card with ``impl="torch"``, as
  ``tools/bench_adam.py`` runs it beside the kernel at 2.42 B parameters.

``PlateauState`` and ``EarlyStopping`` are the JAX package's host-side
state machines, copied as plain Python.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from protein_transformer_tpu_torch import tracing
from protein_transformer_tpu_torch.ops import adam as adam_ops

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.98, 1e-9
WEIGHT_DECAY = 1e-2
# The foreach path's update runs over groups of parameters of at most this
# many bytes: its three temporaries a parameter then stay under three times
# this (a model under it updates in one group, the same launches as
# without). Without them the chain at 2.42 B parameters would hold 29 GB of
# temporaries beside the 39 GB of parameters, gradients and moments.
GROUP_BYTES = 1 << 30

Schedule = Callable[[int], float]


def noam_schedule(d_model: int, warmup_steps: int) -> Schedule:
    """lr = d_model^-0.5 * min(step^-0.5, warmup^-1.5 * step), with step
    counting from count + 1 (count = updates done before this one)."""
    init_lr = float(d_model) ** -0.5
    wu = float(warmup_steps) ** -1.5

    def schedule(count: int) -> float:
        step = float(max(count + 1, 1))
        return init_lr * min(step ** -0.5, wu * step)

    return schedule


@dataclasses.dataclass
class OptState:
    """count: updates applied so far; mu, nu: Adam's moments, one tensor per
    parameter in the parameter dict's order (empty for SGD)."""
    count: int
    mu: list
    nu: list


class Optimizer:
    """The chain of ``make_optimizer``; ``update`` applies one step."""

    def __init__(self, optimizer: str, learning_rate: Union[float, Schedule],
                 weight_decay: bool, clip: float | None, impl: str = "auto"):
        if optimizer not in ("adam", "sgd"):
            raise ValueError(f"Unknown optimizer {optimizer}")
        adam_ops.resolve_impl(impl, "cpu")  # raises for an unknown impl
        self.optimizer = optimizer
        # the path: "auto" (by the parameters' device), "cuda" or "torch"
        self.impl = impl
        self.learning_rate = learning_rate
        self.weight_decay = WEIGHT_DECAY if weight_decay else 0.0
        self.clip = clip
        # the names of the parameters that are slices over the 'model'
        # axis, and that axis (set by ``shard``)
        self.sharded: frozenset = frozenset()
        self.axis = None

    def shard(self, names, axis) -> None:
        """Take the parameters ``names``, slices over the 'model' ``axis``
        (a ``parallel.mesh.AxisGroup``), into the clip's norm as such."""
        self.sharded, self.axis = frozenset(names), axis

    def global_norm(self, grads: list, sliced: list) -> torch.Tensor:
        """The L2 norm of the full gradients, as a 0-d tensor; ``sliced[i]``
        says that ``grads[i]`` is a slice over the 'model' axis."""
        norms = torch._foreach_norm(grads)
        if not any(sliced):
            return torch.linalg.vector_norm(torch.stack(norms))
        zero = torch.zeros((), device=norms[0].device)
        part = sum((n.square() for n, s in zip(norms, sliced) if s), zero)
        rest = sum((n.square() for n, s in zip(norms, sliced) if not s), zero)
        return torch.sqrt(self.axis.all_reduce(part) + rest)

    def lr(self, count: int) -> float:
        """The learning rate of the update after ``count`` updates."""
        if callable(self.learning_rate):
            return float(self.learning_rate(count))
        return float(self.learning_rate)

    def scalars(self, count: int, lr_scale: float = 1.0) -> tuple:
        """(the signed step, Adam's two bias corrections 1 - b^t) of the
        update after ``count`` updates, t = count + 1: host floats."""
        t = count + 1
        return (-self.lr(count) * lr_scale, 1.0 - ADAM_B1 ** t,
                1.0 - ADAM_B2 ** t)

    def init(self, params: dict) -> OptState:
        if self.optimizer == "sgd":
            return OptState(0, [], [])
        zeros = [torch.zeros_like(p) for p in params.values()]
        return OptState(0, zeros, [torch.zeros_like(p) for p in zeros])

    @torch.no_grad()
    def update(self, params: dict, grads, state: OptState,
               lr_scale: float = 1.0) -> OptState:
        """Apply one update to ``params`` in place; grads is a sequence in
        the params' order and is consumed (the foreach path scales it in
        place; the kernel only reads it)."""
        ps = list(params.values())
        gs = list(grads)
        lr, bc1, bc2 = self.scalars(state.count, lr_scale)
        if ps and adam_ops.resolve_impl(self.impl, ps[0].device) == "cuda":
            adam = self.optimizer == "adam"
            adam_ops.adam_update_cuda(
                ps, gs, state.mu if adam else None,
                state.nu if adam else None, lr=lr,
                weight_decay=self.weight_decay, clip=self.clip,
                sliced=[k in self.sharded for k in params], axis=self.axis,
                b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS, bc1=bc1, bc2=bc2)
            tracing.count("optim.fused_params", torch.tensor(
                [sum(p.numel() for p in ps)]))
            return OptState(state.count + 1, state.mu, state.nu)
        if self.clip:
            norm = self.global_norm(gs, [k in self.sharded for k in params])
            factor = torch.where(norm < self.clip, 1.0, self.clip / norm)
            torch._foreach_mul_(gs, factor)
        if self.weight_decay:
            torch._foreach_add_(gs, ps, alpha=self.weight_decay)
        for part in _groups(ps, GROUP_BYTES):
            p_, g_ = [ps[i] for i in part], [gs[i] for i in part]
            if self.optimizer == "adam":
                mu = [state.mu[i] for i in part]
                nu = [state.nu[i] for i in part]
                torch._foreach_lerp_(mu, g_, 1.0 - ADAM_B1)
                torch._foreach_mul_(nu, ADAM_B2)
                torch._foreach_addcmul_(nu, g_, g_, value=1.0 - ADAM_B2)
                mu_hat = torch._foreach_div(mu, bc1)
                denom = torch._foreach_div(nu, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, ADAM_EPS)
                g_ = torch._foreach_div(mu_hat, denom)
                del mu_hat, denom
            torch._foreach_add_(p_, g_, alpha=lr)
        return OptState(state.count + 1, state.mu, state.nu)


def _groups(tensors: list, limit: int) -> list:
    """Consecutive index groups of ``tensors``, each of at most ``limit``
    bytes or one tensor: the whole list while it fits."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        n = t.numel() * t.element_size()
        if cur and size + n > limit:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    return out + [cur] if cur else out


def make_optimizer(optimizer: str, learning_rate: Union[float, Schedule],
                   weight_decay: bool, clip: float | None) -> Optimizer:
    """learning_rate: a float, or a schedule of the update count."""
    return Optimizer(optimizer, learning_rate, weight_decay, clip)


@dataclasses.dataclass
class PlateauState:
    """torch.optim.lr_scheduler.ReduceLROnPlateau with mode='min',
    factor=0.1, threshold_mode='rel', as a scale on the base lr."""
    patience: int
    threshold: float
    factor: float = 0.1
    best: float = float("inf")
    num_bad_epochs: int = 0
    scale: float = 1.0

    def step(self, metric: float) -> float:
        """Update with an epoch metric; returns the current lr scale."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.scale *= self.factor
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)


@dataclasses.dataclass
class EarlyStopping:
    """Stop when the monitored metric has not improved by more than
    ``threshold`` for more than ``patience`` epochs."""
    patience: int
    threshold: float
    best: float = float("inf")
    epoch_last_improved: int = -1

    def update(self, epoch: int, metric: float) -> bool:
        """Returns True if training should stop."""
        if self.best - metric > self.threshold:
            self.best = metric
            self.epoch_last_improved = epoch
            return False
        return (self.patience > 0
                and epoch - self.epoch_last_improved > self.patience)

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)
