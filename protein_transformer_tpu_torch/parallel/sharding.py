"""Tensor parallelism over the 'model' mesh axis (Megatron layout).

Port of protein_transformer_tpu/parallel/sharding.py. The JAX package
assigns PartitionSpecs to flax parameter paths (``_RULES``,
``param_spec``) and lets XLA insert the collectives. The port keeps the
same table on the same flax paths (``models/flax_import.flax_names`` maps
each torch parameter to its path) and writes the collectives itself:

* attention wq/wk/wv kernels shard their output (head) dim, so the heads
  are split across 'model'; the wo kernel shards its input dim
  (row-parallel). FFN Dense_0 is column-parallel (kernel and bias), Dense_1
  row-parallel. Everything else is replicated.
* A flax kernel is (in, out), a torch ``weight`` (out, in): ``P(None,
  "model")`` on ``wq/kernel`` shards the ROWS of the torch weight
  (``sharded_dim``).
* The modules (``models/transformer.py``) use the two Megatron operators
  of this module: ``copy_to_model`` (identity forward, all-reduce backward)
  at a block's input and ``reduce_from_model`` (all-reduce forward,
  identity backward) after a row-parallel product, whose bias is added once
  after the all-reduce. The JAX rules shard the wq/wk/wv kernels but not
  their biases: a rank takes its slice of the replicated bias after
  ``copy_to_model``, so the bias's gradient is summed over 'model'.

A full tensor is put back together by one all-reduce (``assemble``): each
rank writes its block into a tensor of -0.0 and the sum over the group is
every block bit for bit (x + -0.0 is x for every float x), with the
collective that gloo also runs on CUDA tensors.
"""
from __future__ import annotations

import re

import torch

# (path regex, spec) -- first match wins. Paths look like
# 'Encoder_0/EncoderLayer_3/MultiHeadedAttention_0/wq/kernel'. A spec is a
# tuple over the flax leaf's dims: the mesh axis a dim is sharded over, or
# None; () is replicated.
_RULES = (
    (re.compile(r"(wq|wk|wv)/kernel$"), (None, "model")),
    (re.compile(r"wo/kernel$"), ("model", None)),
    # FFN: Dense_0 = dm->dff (column-parallel), Dense_1 = dff->dm (row)
    (re.compile(r"PositionwiseFeedForward_\d+/Dense_0/kernel$"),
     (None, "model")),
    (re.compile(r"PositionwiseFeedForward_\d+/Dense_0/bias$"), ("model",)),
    (re.compile(r"PositionwiseFeedForward_\d+/Dense_1/kernel$"),
     ("model", None)),
)


def param_spec(path: str) -> tuple:
    for pattern, spec in _RULES:
        if pattern.search(path):
            return spec
    return ()  # replicated


def sharded_dim(path: str, shape, size: int) -> int | None:
    """The dim of the torch parameter at flax ``path`` (torch ``shape``)
    that is sharded over a 'model' axis of ``size``; None when it is
    replicated, by the rules or because the dim does not divide."""
    spec = param_spec(path)
    if size <= 1 or "model" not in spec:
        return None
    dim = spec.index("model")
    if path.endswith("kernel"):
        # flax kernels are the torch layouts reversed
        dim = len(shape) - 1 - dim
    if dim >= len(shape) or shape[dim] % size:
        return None
    return dim


def shard_layout(model: torch.nn.Module, size: int) -> dict:
    """{parameter name: sharded torch dim} of ``model``'s parameters that
    are sharded over a 'model' axis of ``size``, after
    ``models.transformer.set_model_parallel``: the rules' leaves whose dim
    divides, in blocks that the model splits (an attention block whose heads
    do not divide stays replicated, numbers and all)."""
    if size <= 1:
        return {}
    from protein_transformer_tpu_torch.models.flax_import import flax_names
    modules = dict(model.named_modules())
    params = dict(model.named_parameters())
    layout = {}
    for name, path in flax_names(model).items():
        dim = sharded_dim(path, params[name].shape, size)
        if dim is None:
            continue
        # every rule's leaf is <block>.<layer>.<weight|bias>
        if getattr(modules[name.rsplit(".", 2)[0]], "mp", None) is not None:
            layout[name] = dim
    return layout


def shard_params(params: dict, layout: dict, axis) -> dict:
    """Each rank's slice of the full tensors in ``params`` along ``layout``
    (``shard_layout``) over the 'model' ``axis`` (``mesh.AxisGroup``);
    the other tensors as they are."""
    return {k: (v.chunk(axis.size, layout[k])[axis.rank].contiguous()
                if k in layout else v) for k, v in params.items()}


def assemble(local: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """The full tensor of which each rank of ``axis`` holds the block
    ``axis.rank`` along ``dim``: one all-reduce, exact bit for bit."""
    if axis.size == 1:
        return local
    shape = list(local.shape)
    width = shape[dim]
    shape[dim] = width * axis.size
    full = torch.full(shape, -0.0, dtype=local.dtype, device=local.device)
    full.narrow(dim, axis.rank * width, width).copy_(local)
    return axis.all_reduce(full)


def gather_params(params: dict, layout: dict, axis) -> dict:
    """The full tensors of ``params`` sharded along ``layout``; every rank
    of ``axis`` must call it."""
    return {k: (assemble(v.detach(), layout[k], axis) if k in layout
                else v) for k, v in params.items()}


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over 'model' backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over 'model' forward, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis)
