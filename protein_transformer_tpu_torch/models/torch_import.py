"""Import checkpoints of the original torch reference into the port.

Lets a user of the reference (jonathanking/protein-transformer) move a
trained model into the port: the reference's ``torch.save`` checkpoints
carry a ``model_state_dict`` (reference: train.py:212-220) whose tensors map
1:1 onto the port's parameters. The port's counterpart of the JAX package's
``models/torch_import.py``, which fills flax trees from the same files.

Names go in two steps, so that no third naming table exists: each port
parameter's flax path (``flax_import.flax_names``), then the reference key
of that path (``_torch_key_for``, the port's copy of the JAX module's
rules: ``Encoder_0/EncoderLayer_3/MultiHeadedAttention_0/wq/kernel`` ->
``encoder.enc_layers.3.self_attn.wq.weight``). Layouts need no conversion,
so the rules give only the key where the JAX module's also give a transpose:
a reference ``Linear.weight`` is (out, in) and a ``Conv1d.weight`` (out, in,
k), as the port's own modules hold them, and ``LayerNorm`` keeps ``weight``
and ``bias``. The shape check is what catches a tensor under the wrong
name.

``state_dict_to_port`` walks the *model's* parameters, so a parameter with
no reference tensor raises ``KeyError`` and a tensor of another shape
``ValueError``; reference entries the model does not own (the positional
encoding's buffer) are ignored, as the JAX module ignores them.
"""
from __future__ import annotations

import re
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from protein_transformer_tpu_torch.models.flax_import import flax_names
from protein_transformer_tpu_torch.models.mla_moe import MLAMoETransformer


def _torch_key_for(parts: Sequence[str]) -> str:
    """The reference's state_dict key of one flax path given as its
    segments, a leading "params" allowed."""
    parts = list(parts)
    if parts and parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    mods = parts[:-1]

    prefix = ""
    if mods and mods[0] in ("encoder", "decoder"):
        # the encoder-decoder's parts carry the reference's attribute names
        prefix = mods[0] + "."
        mods = mods[1:]
    elif mods and mods[0].startswith("Encoder_"):
        prefix = "encoder."
        mods = mods[1:]
    elif mods and mods[0].startswith(("Embeddings_", "Conv_",
                                      "EncoderLayer_")):
        # conv-enc is flat: embedding, convolutions and layers all live on
        # the reference's .encoder
        prefix = "encoder."

    out = prefix
    for i, m in enumerate(mods):
        if m.startswith("Embeddings_"):
            out += "input_embedding."
        elif m == "Embed_0":
            return out + "emb.weight"
        elif re.fullmatch(r"Conv_(\d+)", m):
            out += f"conv_layers.{m.split('_')[1]}."
            return out + ("weight" if leaf == "kernel" else "bias")
        elif re.fullmatch(r"EncoderLayer_(\d+)", m):
            out += f"enc_layers.{m.split('_')[1]}."
        elif re.fullmatch(r"DecoderLayer_(\d+)", m):
            out += f"dec_layers.{m.split('_')[1]}."
        elif m == "MultiHeadedAttention_0":
            # the first attention is self_attn in the reference's encoder
            # and decoder alike (Encoder.py:40, Decoder.py:42)
            out += "self_attn."
        elif m == "MultiHeadedAttention_1":
            out += "src_attn."
        elif m in ("wq", "wk", "wv", "wo"):
            out += m + "."
        elif m == "PositionwiseFeedForward_0":
            out += "pwff."
        elif re.fullmatch(r"Dense_(\d+)", m):
            n = int(m.split("_")[1])
            if "pwff" in out:
                out += f"layer{n + 1}."
            elif prefix == "decoder." and not any(
                    s.startswith("DecoderLayer") for s in mods[:i]):
                # the decoder's input embedding, outside its layers
                out += "input_embedding."
            else:
                raise KeyError(f"unmapped Dense at {'/'.join(parts)}")
        elif re.fullmatch(r"SublayerConnection_(\d+)", m):
            out += f"sublayer_connections.{m.split('_')[1]}."
        elif m == "LayerNorm_0":
            return out + "norm." + ("weight" if leaf == "scale"
                                    else "bias")
        elif m == "AngleProjection_0":
            pass  # a wrapper: the reference holds output_projection on top
        elif m == "output_projection":
            out += "output_projection."
        else:
            raise KeyError(f"unmapped flax module {m!r} in "
                           f"{'/'.join(parts)}")
    return out + ("weight" if leaf == "kernel" else leaf)


def reference_names(model: nn.Module) -> dict[str, str]:
    """{port parameter name: its reference state_dict key} for every
    parameter of ``model``: ``flax_names`` composed with
    ``_torch_key_for``."""
    return {name: _torch_key_for(flax_path.split("/"))
            for name, flax_path in flax_names(model).items()}


def _as_float32(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(value, np.float32))


def state_dict_to_port(state_dict: Mapping, model: nn.Module) -> nn.Module:
    """Fill ``model``'s parameters, in place on its own device, from a
    reference state_dict (name -> tensor or array); returns ``model``.
    Raises KeyError for a parameter whose reference tensor is missing,
    naming both, and ValueError for a tensor of another shape."""
    if isinstance(model, MLAMoETransformer):
        raise ValueError("the reference's checkpoints hold no 'mla-moe' "
                         "model: nothing to import")
    params = dict(model.named_parameters())
    values = {}
    for name, key in reference_names(model).items():
        if key not in state_dict:
            raise KeyError(f"{key} (for port parameter {name}) not in "
                           "state_dict")
        value = _as_float32(state_dict[key])
        if tuple(value.shape) != tuple(params[name].shape):
            raise ValueError(f"shape mismatch for {key}: reference "
                             f"{tuple(value.shape)} vs port {name} "
                             f"{tuple(params[name].shape)}")
        values[name] = value
    with torch.no_grad():
        for name, value in values.items():
            params[name].copy_(value)
    return model


def load_reference_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """A reference ``.chkpt`` file (train.py:212-220 payload, or a bare
    state_dict) into ``model``'s parameters; returns ``model``."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    return state_dict_to_port(payload.get("model_state_dict", payload),
                              model)
