"""The reference's training steps and scoring, plain PyTorch, float32.

``train_steps`` follows the first steps of a run from the same weights on
the same batches: the forward pass in train mode with the configuration's
dropout (masks drawn from a generator seeded as the run's), the NeRF and
sidechain coordinates, the loss, its gradients, then the original's
optimizer: clip by global norm (scale by clip / norm when norm > clip),
weight decay 1e-2 added to the gradient, Adam (0.9, 0.98, eps 1e-9, bias
corrected, eps outside the square root) and the Noam learning rate
d_model^-0.5 * min(s^-0.5, warmup^-1.5 * s) at update s = 1, 2, ...
``score`` gives the eval metrics of a batch in eval mode (no dropout).

``batch_of`` pads the benchmark's own proteins to a given (rows, length):
the reference never reads a batch that the program assembled. ``build``
makes the model. A configuration names this module as its ``reference``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import geometry, losses
from benchmark.reference.model import ConvEncoder

ADAM_B1, ADAM_B2, ADAM_EPS, WEIGHT_DECAY = 0.9, 0.98, 1e-9, 1e-2
METRICS = ("loss", "mse-full", "mse-bb", "mse-sc", "drmsd-full",
           "lndrmsd-full", "drmsd-bb", "lndrmsd-bb", "combined-full",
           "rmsd-full")


def batch_of(prot, indices, rows: int, length: int, pad_id: int,
             device) -> dict:
    """Rows ``indices`` of ``prot`` (``benchmark.proteins.Proteins``)
    padded to (rows, length); the rows past len(indices) are padding."""
    idx = np.asarray(indices, np.int64)
    n = len(idx)
    if n > rows or int(prot.lens[idx].max()) > length:
        raise ValueError(f"{n} proteins of up to {int(prot.lens[idx].max())}"
                         f" residues do not fit a ({rows}, {length}) batch")
    cut = min(length, prot.ids.shape[1])
    seq = np.full((rows, length), pad_id, np.int64)
    ang = np.zeros((rows, length, 24), np.float32)
    crd = np.full((rows, length, 14, 3), np.nan, np.float32)
    seq[:n, :cut] = prot.ids[idx, :cut]
    ang[:n, :cut] = prot.sincos[idx, :cut]
    crd[:n, :cut] = prot.crd[idx, :cut]
    real = np.arange(length)[None, :] < np.r_[prot.lens[idx],
                                              np.zeros(rows - n, int)][:, None]
    seq[~real] = pad_id
    ang_mask = np.isfinite(ang) & real[..., None]
    crd_mask = np.isfinite(crd).all(-1) & real[..., None]
    out = {"seq": seq, "ang": np.where(ang_mask, ang, 0.0),
           "ang_mask": ang_mask,
           "crd": np.where(crd_mask[..., None], crd, 0.0).astype(np.float32),
           "crd_mask": crd_mask,
           "protein_mask": np.arange(rows) < n}
    return {k: torch.as_tensor(v).to(device) for k, v in out.items()}


def build(spec: dict) -> ConvEncoder:
    return ConvEncoder(spec)


def model_of(spec: dict, weights: dict, device) -> ConvEncoder:
    model = build(spec).to(device)
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise ValueError("the weights do not name the model's parameters: "
                         f"{sorted(set(names) ^ set(weights))[:4]}")
    with torch.no_grad():
        for k, p in names.items():
            p.copy_(weights[k])
    return model


def forward_metrics(model, batch: dict, spec: dict, with_rmsd: bool,
                    drop_half: bool = False) -> dict:
    """Metrics of one batch; ``drop_half`` is a planted fault: the second
    half of the real proteins left out, the means taken over the rest."""
    if drop_half:
        pm = batch["protein_mask"]
        n = int(pm.sum())
        keep = torch.arange(pm.shape[0], device=pm.device) < max(1, n // 2)
        batch = {**batch, "protein_mask": pm & keep,
                 "ang_mask": batch["ang_mask"] & keep[:, None, None],
                 "crd_mask": batch["crd_mask"] & keep[:, None, None]}
    pred = model(batch["seq"])
    crd = geometry.coords(geometry.angles_from_sincos(pred), batch["seq"])
    return losses.batch_metrics(pred, crd, batch, spec, with_rmsd)


def noam(d_model: int, warmup: int, update: int) -> float:
    s = float(update)
    return float(d_model) ** -0.5 * min(s ** -0.5, float(warmup) ** -1.5 * s)


@dataclasses.dataclass
class TrainReadings:
    """What the comparison reads of the first steps: each step's loss, the
    first step's gradient as the optimizer takes it (clipped, before the
    weight decay), and each parameter's change over the steps."""
    losses: list
    grad1: dict
    change: dict


def train_steps(spec: dict, weights: dict, batches: list, seed: int,
                device, drop_half: bool = False) -> TrainReadings:
    """The first len(batches) steps from ``weights`` (not changed)."""
    model = model_of(spec, weights, device).train()
    model.generator = torch.Generator(device=device)
    model.generator.manual_seed(seed % (1 << 32))
    params = [p for _, p in model.named_parameters()]
    names = [k for k, _ in model.named_parameters()]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    out = TrainReadings([], {}, {})
    for step, batch in enumerate(batches, start=1):
        loss = forward_metrics(model, batch, spec, False, drop_half)["loss"]
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        out.losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            clip = spec["clip"]
            factor = 1.0 if float(norm) < clip else clip / float(norm)
            grads = [g * factor for g in grads]
            if step == 1:
                out.grad1 = {k: g.clone() for k, g in zip(names, grads)}
            lr = noam(spec["d_model"], spec["n_warmup_steps"], step)
            for p, g, m, v in zip(params, grads, mu, nu):
                g = g + WEIGHT_DECAY * p
                m.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                upd = ((m / (1 - ADAM_B1 ** step))
                       / (torch.sqrt(v / (1 - ADAM_B2 ** step)) + ADAM_EPS))
                p.sub_(lr * upd)
    with torch.no_grad():
        out.change = {k: p - weights[k] for k, p in zip(names, params)}
    return out


@torch.no_grad()
def score(spec: dict, weights: dict, batches: list, device,
          drop_half: bool = False) -> list:
    """Eval metrics (``METRICS`` order) of each batch, as float lists."""
    model = model_of(spec, weights, device).eval()
    rows = []
    for batch in batches:
        m = forward_metrics(model, batch, spec, True, drop_half)
        rows.append([float(m[k]) for k in METRICS])
    return rows
