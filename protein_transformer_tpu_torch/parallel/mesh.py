"""Device mesh and batch placement over the ranks of a process group.

Port of protein_transformer_tpu/parallel/mesh.py. A JAX mesh lays devices
out on named axes; here the devices are ranks, one process per device, laid
out row-major on the axes (rank = the ranks' flat index in
``np.arange(world).reshape(shape)``), so the ranks of one 'model' group are
neighbours. Each axis holds the process group of this rank's line along it
(``AxisGroup``). In a run with a process group every reduction over an axis
is a collective, also over an axis of one rank (a launcher's world of one
runs the multi-process code paths on its one card); without a process
group there is none.

Parameters are replicated (``replicate_tree``) or sharded over 'model'
(``parallel/sharding.py``); batches are sharded over 'data': every rank of
one 'data' coordinate holds the same contiguous row block of the global
batch (``batch_sharding`` / ``shard_batch``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from protein_transformer_tpu_torch.parallel.distributed import (
    local_world_size, make_global_batch, process_local_rows)


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's line along one mesh axis: its size, this rank's index
    on it, and the process group of its ranks (None without a process
    group)."""
    size: int
    rank: int
    group: Optional[object] = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the axis; returns it."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t


@dataclasses.dataclass
class Mesh:
    """The ranks on named axes: ``shape`` maps each axis to its size,
    ``axes`` each axis to this rank's ``AxisGroup``; ``device`` is where
    this rank computes."""
    shape: dict
    axes: dict
    device: torch.device

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def axis(self, name: str) -> AxisGroup:
        """The axis ``name``; a size-1 axis when the mesh has none."""
        return self.axes.get(name, AxisGroup(1, 0))


def infer_shape(shape: Sequence[int], world: int) -> list:
    """``shape`` with a -1 axis inferred over ``world`` ranks; raises, with
    the JAX package's messages, when it cannot be inferred or needs more
    ranks than there are."""
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if known <= 0 or world % known != 0:
            raise ValueError(
                f"mesh shape {shape} cannot be inferred over {world} "
                f"devices: the fixed axes ({known}) must divide the device "
                "count")
        shape[shape.index(-1)] = world // known
    total = int(np.prod(shape))
    if total > world:
        raise ValueError(f"mesh shape {shape} needs {total} devices, "
                         f"only {world} available")
    return shape


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",),
              device: torch.device | str = "cpu") -> Mesh:
    """A mesh over the ranks of the process group (one rank without one);
    -1 infers that axis size.

    An inferred axis must divide the rank count evenly and an explicit
    shape must cover the ranks exactly: where the JAX package idles the
    devices a shape leaves out, a rank outside the mesh would be stranded,
    so that raises too. The JAX package's idle-device warning fires here
    when the host has more cards than ranks on it. Every rank must call
    this with the same arguments, in the same order as its other
    collectives: it makes one process group per line of each axis."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = torch.device(device)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {list(shape)} and axes {list(axes)} "
                         "differ in length")
    shape = infer_shape(shape, world)
    total = int(np.prod(shape))
    if total < world:
        raise ValueError(f"mesh shape {shape} uses {total} of {world} "
                         f"devices; {world - total} would idle")
    if device.type == "cuda":
        cards, ranks = torch.cuda.device_count(), local_world_size(world)
        if ranks < cards:
            print(f"[mesh] warning: shape {shape} uses {ranks} of {cards} "
                  f"devices on this host; {cards - ranks} idle")
    grid = np.arange(world).reshape(shape)
    coords = dict(zip(axes, (int(c) for c in
                             np.argwhere(grid == rank)[0])))
    out = {}
    for i, name in enumerate(axes):
        group = None
        if dist.is_initialized():
            # one group per line along this axis, made in the same order
            # on every rank; this rank keeps its own
            others = [range(s) for j, s in enumerate(shape) if j != i]
            for fixed in itertools.product(*others):
                index = list(fixed)
                index.insert(i, slice(None))
                members = [int(r) for r in grid[tuple(index)]]
                made = dist.new_group(members)
                if rank in members:
                    group = made
        out[name] = AxisGroup(shape[i], coords[name], group)
    return Mesh(dict(zip(axes, shape)), out, device)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) axis sharded over 'data': block ``index`` of
    ``count``, on ``device``."""
    index: int
    count: int
    device: torch.device

    def rows(self, n_rows: int) -> slice:
        return process_local_rows(n_rows, self.index, self.count)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Shard the leading (batch) axis over the 'data' mesh axis."""
    data = mesh.axis("data")
    return BatchSharding(data.rank, data.size, mesh.device)


def shard_batch(batch, mesh: Optional[Mesh], non_blocking: bool = False):
    """A host Batch's rows of this rank's 'data' coordinate, as tensors on
    the mesh's device (``Batch.to``'s dtypes and its ``non_blocking``);
    ``n_res`` stays the global batch's. Without a mesh the batch is
    returned as it is."""
    if mesh is None:
        return batch
    sh = batch_sharding(mesh)
    names = [f.name for f in dataclasses.fields(batch)
             if hasattr(getattr(batch, f.name), "shape")]
    put = {n: make_global_batch(np.asarray(getattr(batch, n)), sh,
                                non_blocking)
           for n in names}
    put["seq"] = put["seq"].long()
    return dataclasses.replace(batch, **put)


def replicate_tree(tree: dict, mesh: Optional[Mesh]) -> dict:
    """Rank 0's value of every tensor of a flat dict, on every rank (in
    place, and returned): parameters start equal on every rank whatever
    each rank loaded."""
    if mesh is not None and dist.is_initialized() \
            and dist.get_world_size() > 1:
        for t in tree.values():
            dist.broadcast(t, src=0)
    return tree
