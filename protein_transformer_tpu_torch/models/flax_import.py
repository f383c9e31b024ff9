"""Weights bridge: JAX package (flax) parameters -> the port's state_dict.

A flax params tree is given as nested dicts of numpy arrays, keyed as the
JAX package names them (``p['params']['EncoderLayer_0']
['MultiHeadedAttention_0']['wq']['kernel']`` ...). Module names map onto the
port's attribute names; leaves map as

* Dense kernel (in, out)        -> Linear weight (out, in)
* Conv kernel (k, in, out)      -> Conv1d weight (out, in, k)
* Embed embedding, LayerNorm scale -> weight; every bias -> bias.

Every flax leaf must land on a model parameter of the same shape, and every
model parameter must be covered; anything else raises.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_MODULE_NAMES = {
    "Encoder_0": "encoder",
    # the encoder-decoder names its three parts itself
    "encoder": "encoder",
    "decoder": "decoder",
    "output_projection": "output_projection",
    "Embeddings_0": "embeddings",
    "Embed_0": "embed",
    "MultiHeadedAttention_0": "attn",
    "MultiHeadedAttention_1": "cross_attn",
    "PositionwiseFeedForward_0": "ff",
    "LayerNorm_0": "norm",
    "AngleProjection_0": "head",
}
_INDEXED = (
    (re.compile(r"EncoderLayer_(\d+)$"), lambda i: f"layers.{i}"),
    (re.compile(r"DecoderLayer_(\d+)$"), lambda i: f"layers.{i}"),
    (re.compile(r"SublayerConnection_(\d+)$"), lambda i: f"sublayer.{i}"),
    (re.compile(r"Conv_(\d+)$"), lambda i: f"convs.{i}"),
    (re.compile(r"Dense_(\d+)$"), lambda i: f"w_{i + 1}"),
)
_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
               "bias": "bias"}
_GOLDEN_KEY = re.compile(r"\['([^']*)'\]")


def _module_name(seg: str, parent: str | None = None) -> str:
    if (parent, seg) == ("decoder", "Dense_0"):
        return "embed"  # the decoder's input embedding, not a feed-forward
    if seg in _MODULE_NAMES:
        return _MODULE_NAMES[seg]
    for pattern, fmt in _INDEXED:
        m = pattern.match(seg)
        if m:
            return fmt(int(m.group(1)))
    if seg in ("wq", "wk", "wv", "wo"):
        return seg
    raise KeyError(f"no port module for flax module {seg!r}")


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def flax_to_state_dict(params: Mapping, model: nn.Module
                       ) -> dict[str, torch.Tensor]:
    """Map a flax params tree onto ``model``'s state_dict keys and layouts.

    params may be the full variables dict ({'params': ...}) or the inner
    tree. Returns CPU float32 tensors keyed like ``model.state_dict()``."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        flax_name = "/".join(path)
        if path[-1] not in _LEAF_NAMES:
            raise KeyError(f"no port parameter for flax leaf {flax_name}")
        name = ".".join([_module_name(seg, parent) for parent, seg
                         in zip((None,) + path, path[:-1])]
                        + [_LEAF_NAMES[path[-1]]])
        if name not in target:
            raise KeyError(f"flax parameter {flax_name} maps to {name}, "
                           "which the model does not have")
        arr = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
        if tuple(arr.shape) != tuple(target[name].shape):
            raise ValueError(f"flax parameter {flax_name} has shape "
                             f"{arr.shape} in port layout; {name} is "
                             f"{tuple(target[name].shape)}")
        out[name] = torch.tensor(arr)  # a copy: flax arrays are read-only
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model parameters with no flax counterpart: {missing}")
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy flax params into ``model`` in place (on its own device)."""
    model.load_state_dict(flax_to_state_dict(params, model))
    return model


def params_from_flat_keys(flat: Mapping[str, np.ndarray]) -> dict:
    """Nested params from flat keys: golden-file keys such as
    "p['params']['Conv_0']['kernel']", or the slash keys of an exported
    checkpoint such as "params/params/Conv_0/kernel" (the first segment is
    the checkpoint's entry, the rest the flax path). Other keys are skipped
    (inputs, expected outputs or the step share the file)."""
    tree: dict = {}
    for key in flat:
        if key.startswith("p["):
            path = _GOLDEN_KEY.findall(key)
        elif key.startswith("params/"):
            path = key.split("/")[1:]
        else:
            continue
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.asarray(flat[key])
    return tree
