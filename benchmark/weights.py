"""The benchmark's weights, made on the device from the seed.

One uniform(-1, 1) draw from a ``torch.Generator`` on the device fills a
flat float32 buffer for every weight matrix at once; each matrix is then
its slice scaled to its Xavier-uniform bound (fan in and out as torch
counts them), the output head's by ``head_gain``. Biases are zero, layer
norm scales one, and the head's bias is arctanh of the training split's
angle means, so the untrained model starts near the mean structure. A
random head (the original's is zero) gives every layer a gradient from the
first step.
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch

HEAD = "head.output_projection."


def shapes(spec: dict) -> dict:
    """{parameter name: shape} of the configuration's model, as its
    reference (the module ``spec["reference"]`` names) builds it."""
    build = importlib.import_module(spec["reference"]).build
    with torch.device("meta"):
        model = build(spec)
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def xavier_bound(shape: tuple) -> float:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return math.sqrt(6.0 / (fan_in + fan_out))


def make(spec: dict, seed: int, angle_means, device) -> dict:
    """{name: float32 tensor on ``device``}; the same seed gives the same
    bits."""
    sizes = shapes(spec)
    mats = [k for k, s in sizes.items() if len(s) >= 2]
    total = sum(math.prod(sizes[k]) for k in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    out, at = {}, 0
    for k, shape in sizes.items():
        if len(shape) >= 2:
            n = math.prod(shape)
            gain = spec["head_gain"] if k.startswith(HEAD) else 1.0
            out[k] = flat[at:at + n].view(shape).mul_(
                gain * xavier_bound(shape))
            at += n
        elif k.endswith("norm.weight"):
            out[k] = torch.ones(shape, device=device)
        elif k == HEAD + "bias":
            am = np.clip(np.asarray(angle_means, np.float32), -1 + 1e-7,
                         1 - 1e-7)
            out[k] = torch.as_tensor(np.arctanh(am).astype(np.float32),
                                     device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out
