"""Checkpoints with the reference's best/interval policy, via ``torch.save``.

Port of protein_transformer_tpu/training/checkpoint.py. Policy: save under
'best' when the monitored loss improves on its history; save under 'latest'
when ``checkpoint_time_interval`` hours have passed since the last
checkpoint; resume from 'best' by default, ``restart`` skips loading,
``restart_opt`` loads the weights but keeps a fresh optimizer.

Tensor state (parameters, optimizer state, step; the full tensors, whatever
the run's mesh, which the trainer gathers and process 0 writes) goes into
one file per modifier, ``<directory>/<modifier>``, which holds tensors and
plain Python values only, so that it loads with ``torch.load(..., weights_only=True)``.
Host-side scalar state (epoch, elapsed time, the plateau and early-stopping
machines, the loss history) goes to a JSON sidecar,
``<directory>/<modifier>.meta.json``. Each file is written under a temporary
name and moved into place, the tensor file first: a crash leaves the old
checkpoint or the new one, at worst with the older sidecar or none, and a
missing sidecar restores as an empty dict.

A run of the JAX package comes in through numpy: ``ptt_scripts/
export_checkpoint_npz.py`` (outside this package; it reads the orbax
checkpoint with the JAX package) writes the parameters as a flat ``.npz``
with the run's ``config.json``, and ``import_run`` here turns that directory
into a run directory of the port:

    python -m protein_transformer_tpu_torch.training.checkpoint \
        <exported_dir> <run_dir> [--checkpoint best]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Mapping, Optional

import numpy as np
import torch


def check_against(template, restored, where: str) -> None:
    """Raise if ``restored`` does not have ``template``'s structure: the same
    dict keys and tensor shapes."""
    if isinstance(template, dict):
        if not isinstance(restored, dict) or set(template) != set(restored):
            raise ValueError(
                f"checkpoint {where}: keys differ from the live state "
                f"(missing {sorted(set(template) - set(restored or ()))}, "
                f"unexpected {sorted(set(restored or ()) - set(template))})")
        for key in template:
            check_against(template[key], restored[key], f"{where}.{key}")
    elif isinstance(template, torch.Tensor):
        if not isinstance(restored, torch.Tensor) \
                or restored.shape != template.shape:
            raise ValueError(
                f"checkpoint {where}: expected a tensor of shape "
                f"{tuple(template.shape)}, got "
                f"{tuple(getattr(restored, 'shape', ()))}")


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, modifier: str) -> str:
        return os.path.join(self.directory, modifier)

    def save(self, modifier: str, arrays: dict, meta: dict) -> None:
        """arrays: nested dicts of tensors and plain Python values (the
        optimizer state as a dict, its moments by parameter name); meta:
        JSON-serialisable."""
        path = self._path(modifier)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(_detached(arrays), tmp)
        os.replace(tmp, path)
        with open(tmp, "w") as f:
            json.dump(meta, f, default=float)
        os.replace(tmp, path + ".meta.json")

    def _meta(self, path: str) -> dict:
        meta_path = path + ".meta.json"
        if not os.path.exists(meta_path):
            return {}
        with open(meta_path) as f:
            return json.load(f)

    def restore_raw(self, modifier: str, map_location="cpu"
                    ) -> Optional[tuple[dict, dict]]:
        """(arrays, meta) as saved, tensors on ``map_location``, or None if
        there is no such checkpoint. Nothing is checked against a live
        state: ``restart_opt`` and tooling that only needs the parameters
        use it."""
        path = self._path(modifier)
        if not os.path.exists(path):
            return None
        arrays = torch.load(path, weights_only=True,
                            map_location=map_location)
        return arrays, self._meta(path)

    def restore(self, modifier: str, template: dict, map_location="cpu"
                ) -> Optional[tuple[dict, dict]]:
        """As ``restore_raw``, and raises ValueError unless the restored
        arrays have ``template``'s structure (keys and shapes)."""
        result = self.restore_raw(modifier, map_location)
        if result is not None:
            check_against(template, result[0], repr(modifier))
        return result

    def exists(self, modifier: str) -> bool:
        return os.path.exists(self._path(modifier))


def checkpoint_policy(cur_loss: float, loss_history: list,
                      last_chkpt_time: float,
                      time_interval_hours: float,
                      process_count: int = 1) -> Optional[str]:
    """Returns 'best', 'latest', or None.

    'best' for the first recorded loss and for one below every earlier one;
    otherwise 'latest' once the time interval (hours, 0 = never) has passed.
    The time trigger reads the local clock; in a multi-process run the
    processes could disagree near the interval's end and part ways around
    the checkpoint's gather, so process 0's decision is broadcast."""
    do_time = (time_interval_hours > 0 and
               (time.time() - last_chkpt_time) / 3600 > time_interval_hours)
    if process_count > 1 or torch.distributed.is_initialized():
        from protein_transformer_tpu_torch.parallel.distributed import (
            broadcast_one_to_all)
        do_time = broadcast_one_to_all(do_time)
    if len(loss_history) == 1 or (loss_history[:-1]
                                  and cur_loss < min(loss_history[:-1])):
        return "best"
    if do_time:
        return "latest"
    return None


def import_flat_arrays(flat: Mapping[str, np.ndarray],
                       model: torch.nn.Module) -> dict:
    """The arrays of a port checkpoint from a flat mapping of numpy arrays
    keyed "params/<flax path>" (and "step"), as an exported checkpoint of
    the JAX package holds them: the parameters mapped onto ``model``'s names
    and layouts through the flax bridge, the step, and an empty optimizer
    state (the JAX optimizer's moments are not carried over: resume
    training from such a checkpoint with ``--restart_opt``)."""
    from protein_transformer_tpu_torch.models.flax_import import (
        flax_to_state_dict, params_from_flat_keys)
    params = flax_to_state_dict(params_from_flat_keys(flat), model)
    step = int(np.asarray(flat["step"])) if "step" in flat else 0
    return {"params": params,
            "opt_state": {"count": 0, "mu": {}, "nu": {}}, "step": step}


def import_run(exported_dir: str, run_dir: str,
               modifier: str = "best") -> str:
    """Make ``run_dir`` a run directory of the port from an exported run of
    the JAX package: ``<exported_dir>/config.json`` and
    ``<exported_dir>/<modifier>.npz`` (with ``<modifier>.meta.json`` when
    the run had one). Writes ``config.json`` with the port's fields (kernel
    choices reset to "auto": their JAX values name TPU implementations) and
    ``checkpoints/<modifier>`` with its sidecar; returns ``run_dir``.

    Settings of the JAX run that the port has no field for are dropped: they
    only say how that run was executed (logging, profiling, the data
    store). The mesh is kept, as a record: the checkpoint holds the full
    tensors, and a run resumed from it takes its mesh from its own flags.
    The compute dtype is kept: a bfloat16 run's parameters are
    float32 as a float32 run's, and the imported model computes in bf16."""
    from protein_transformer_tpu_torch.config import TrainConfig
    from protein_transformer_tpu_torch.models.factory import make_model
    with open(os.path.join(exported_dir, "config.json")) as f:
        saved = json.load(f)
    cfg = TrainConfig.from_dict(saved["config"])
    cfg.drmsd_impl = cfg.sidechain_impl = "auto"
    cfg = cfg.finalize()
    model = make_model(cfg, np.asarray(saved["angle_means"], np.float32))
    with np.load(os.path.join(exported_dir, modifier + ".npz")) as flat:
        arrays = import_flat_arrays(flat, model)
    meta_path = os.path.join(exported_dir, modifier + ".meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump({"config": cfg.to_dict(),
                   "angle_means": saved["angle_means"]}, f, indent=1,
                  default=str)
    CheckpointManager(os.path.join(run_dir, "checkpoints")).save(
        modifier, arrays, meta)
    return run_dir


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Import an exported run of the JAX package (config.json "
                    "and <checkpoint>.npz) as a run directory of the port.")
    p.add_argument("exported_dir")
    p.add_argument("run_dir")
    p.add_argument("--checkpoint", default="best")
    args = p.parse_args(argv)
    print(import_run(args.exported_dir, args.run_dir, args.checkpoint))


if __name__ == "__main__":
    main()
