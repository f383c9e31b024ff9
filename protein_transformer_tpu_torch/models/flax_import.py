"""Weights bridge: JAX package (flax) parameters -> the port's state_dict.

A flax params tree is given as nested dicts of numpy arrays, keyed as the
JAX package names them (``p['params']['EncoderLayer_0']
['MultiHeadedAttention_0']['wq']['kernel']`` ...). Module names map onto the
port's attribute names; leaves map as

* Dense kernel (in, out)        -> Linear weight (out, in)
* Conv kernel (k, in, out)      -> Conv1d weight (out, in, k)
* Embed embedding, LayerNorm scale -> weight; every bias -> bias.

Every flax leaf must land on a model parameter of the same shape, and every
model parameter must be covered; anything else raises. ``flax_names`` and
``to_flax_layout`` go the other way: each parameter's flax path and layout
(the names wandb's histograms carry, the embedding table's export).
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


# the port's module attribute -> the flax module it came from, where the
# name alone decides (the inverse of _MODULE_NAMES)
_FLAX_MODULES = {v: k for k, v in _MODULE_NAMES.items() if k != v
                 and k != "Encoder_0"}
_FLAX_INDEXED = {"sublayer": "SublayerConnection_", "convs": "Conv_"}


def _flax_segment(seg: str, parent: str | None, enc_dec: bool) -> str:
    """The flax module name of the port's attribute ``seg`` (one segment,
    "layers.0" included) under ``parent``: the inverse of ``_module_name``."""
    if seg == "embed" and parent == "decoder":
        return "Dense_0"
    if seg in ("wq", "wk", "wv", "wo", "output_projection") or (
            enc_dec and seg in ("encoder", "decoder")):
        return seg
    if seg == "encoder":
        return "Encoder_0"
    if seg in _FLAX_MODULES:
        return _FLAX_MODULES[seg]
    name, _, index = seg.partition(".")
    if name == "layers":
        return ("DecoderLayer_" if parent == "decoder"
                else "EncoderLayer_") + index
    if name in _FLAX_INDEXED:
        return _FLAX_INDEXED[name] + index
    if re.fullmatch(r"w_\d+", seg):
        return f"Dense_{int(seg[2:]) - 1}"
    raise KeyError(f"no flax module for port module {seg!r}")


def flax_names(model: nn.Module) -> dict[str, str]:
    """{parameter name: its flax path ("Encoder_0/EncoderLayer_0/.../kernel")}
    for every parameter of ``model``: the inverse of the name mapping of
    ``flax_to_state_dict``, which each path is held to."""
    modules = dict(model.named_modules())
    enc_dec = "decoder" in modules
    out = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        # indexed children ("layers.0") are one segment, as flax names them
        segs = re.findall(r"[a-z_]+\.\d+|[a-z_0-9]+", owner)
        path = [_flax_segment(seg, parent, enc_dec)
                for parent, seg in zip([None] + segs, segs)]
        module = modules[owner]
        if leaf == "bias":
            path.append("bias")
        elif isinstance(module, nn.Embedding):
            path.append("embedding")
        elif isinstance(module, nn.LayerNorm):
            path.append("scale")
        else:
            path.append("kernel")
        back = ".".join([_module_name(seg, parent) for parent, seg
                         in zip([None] + path, path[:-1])]
                        + [_LEAF_NAMES[path[-1]]])
        if back != name:
            raise KeyError(f"{name}: flax path {'/'.join(path)} maps back "
                           f"to {back}")
        out[name] = "/".join(path)
    return out


def to_flax_layout(value: np.ndarray, flax_path: str) -> np.ndarray:
    """A parameter in the port's layout -> flax's (the inverse of the
    layouts of ``flax_to_state_dict``: Linear (out, in) -> Dense (in, out),
    Conv1d (out, in, k) -> Conv (k, in, out))."""
    if not flax_path.endswith("kernel"):
        return value
    return value.T if value.ndim == 2 else np.transpose(value, (2, 1, 0))


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
