"""Multi-process initialisation and per-rank batch rows, on torch.distributed.

Port of protein_transformer_tpu/parallel/distributed.py. JAX runs one
process over many devices; PyTorch runs one process per device, so here a
rank is a process and its device:

* ``initialize_from_env``: ``torch.distributed.init_process_group`` gated
  on the environment, so single-process runs pay nothing. The JAX package's
  triple PTT_COORDINATOR (host:port of rank 0) / PTT_NUM_PROCESSES /
  PTT_PROCESS_ID configures a run by hand; PTT_DISTRIBUTED=1 takes the
  launcher's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT, which is what
  ``python -m torch.distributed.run`` sets. The backend is chosen from the
  layout before the group is made, and printed: ``nccl`` when every rank on
  the host has a card of its own, ``gloo`` on the CPU or when ranks share a
  card (NCCL refuses two ranks on one device). A failing init raises;
  nothing moves a rank to the CPU.

* ``process_local_rows`` / ``make_global_batch``: every rank samples the
  SAME global batch (the host sampler is seeded identically), then keeps
  the contiguous row block of its 'data' coordinate. The global batch is
  therefore the single-process run's at any rank count.

Every collective of the port is an all-reduce or a broadcast, the two that
gloo also runs on CUDA tensors.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

_ENV_COORD = "PTT_COORDINATOR"          # host:port of rank 0
_ENV_NPROC = "PTT_NUM_PROCESSES"
_ENV_PID = "PTT_PROCESS_ID"

# the device this process computes on, set by initialize_from_env; host
# values that go through a collective travel as tensors on it
_device: torch.device | None = None


def _auto() -> bool:
    return os.environ.get("PTT_DISTRIBUTED", "") not in ("", "0", "false")


def _triple() -> tuple[str | None, int]:
    coord = os.environ.get(_ENV_COORD)
    return coord, int(os.environ.get(_ENV_NPROC, "0") or 0)


def local_device_index() -> int | None:
    """The index of this rank's card: LOCAL_RANK under a launcher,
    PTT_PROCESS_ID modulo the host's card count under the triple, None for
    a single-process run (the current device)."""
    if _auto() and "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    coord, nproc = _triple()
    if coord and nproc > 1 and os.environ.get(_ENV_PID) is not None:
        return int(os.environ[_ENV_PID]) % max(torch.cuda.device_count(), 1)
    return None


def local_world_size(world: int) -> int:
    """Ranks on this host: the launcher's LOCAL_WORLD_SIZE, else every rank
    (a run configured by the triple is taken to be one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def choose_backend(device_type: str, local_world: int,
                   device_count: int) -> str:
    """nccl when every rank on the host has a card of its own; gloo on the
    CPU, or when ranks share a card."""
    if device_type == "cuda" and local_world <= device_count:
        return "nccl"
    return "gloo"


def initialize_from_env(device: torch.device | str | None = None
                        ) -> tuple[int, int]:
    """Join the process group the environment configures, once.

    ``device`` is where this rank computes (default: the current CUDA
    device); it decides the backend. No-op when nothing is set, and
    idempotent across Trainer constructions. Returns (process_index,
    process_count), (0, 1) with nothing set."""
    global _device
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord, nproc = _triple()
    auto = _auto()
    if not (auto or (coord and nproc > 1)):
        return 0, 1
    if coord and nproc > 1:
        pid = os.environ.get(_ENV_PID)
        if pid is None:
            raise RuntimeError(
                f"{_ENV_PID} must be set (0..{nproc - 1}) when "
                f"{_ENV_COORD}/{_ENV_NPROC} configure a multi-process run")
        rank, world, init = int(pid), nproc, f"tcp://{coord}"
    else:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init = "env://"
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_device_index() or 0)
        torch.cuda.set_device(device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = choose_backend(device.type, local_world_size(world), n_cards)
    print(f"[distributed] rank {rank} of {world} on {device}: backend "
          f"{backend}", flush=True)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    _device = device
    return rank, world


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def broadcast_one_to_all(value: bool) -> bool:
    """Process 0's ``value`` on every process (a no-op without a process
    group)."""
    if not dist.is_initialized():
        return bool(value)
    t = torch.tensor([int(bool(value))], device=_device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def all_agree(value: bool) -> bool:
    """True on every process when ``value`` is True on every process (a
    no-op without a process group)."""
    if not dist.is_initialized():
        return bool(value)
    t = torch.tensor([int(bool(value))], device=_device)
    dist.all_reduce(t)
    return int(t.item()) == _world()


def process_local_rows(n_rows: int,
                       process_index: int | None = None,
                       process_count: int | None = None) -> slice:
    """The contiguous block of global-batch rows that block ``process_index``
    of ``process_count`` owns: [p*n/P, (p+1)*n/P). By default the block of
    this process among all processes; the mesh passes a rank's 'data'
    coordinate and the 'data' axis size. n_rows must divide evenly: the
    collate path pads batches to a multiple of the 'data' axis size."""
    p = _rank() if process_index is None else process_index
    n = _world() if process_count is None else process_count
    if n_rows % n:
        raise ValueError(f"batch rows {n_rows} not divisible by "
                         f"process count {n}")
    per = n_rows // n
    return slice(p * per, (p + 1) * per)


def make_global_batch(x: np.ndarray, sharding,
                      non_blocking: bool = False) -> torch.Tensor:
    """This rank's rows of a host array, on its device. Every rank passes
    the same full global array (identically seeded samplers); only its own
    row block is copied. ``sharding``: ``parallel.mesh.batch_sharding``.
    With non_blocking a copy bound for a GPU goes from pinned memory and
    does not wait, as ``Batch.to`` does it."""
    t = torch.as_tensor(np.ascontiguousarray(x[sharding.rows(x.shape[0])]))
    if non_blocking and sharding.device.type == "cuda":
        t = t.pin_memory()
    return t.to(sharding.device, non_blocking=non_blocking)
