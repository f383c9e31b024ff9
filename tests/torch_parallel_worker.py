"""One rank of the port's multi-process runs on the CPU (gloo), for
tests/test_torch_parallel.py.

    PYTHONPATH=. PTT_COORDINATOR=127.0.0.1:<port> PTT_NUM_PROCESSES=<n> \\
        PTT_PROCESS_ID=<r> python tests/torch_parallel_worker.py \\
        <world2|world4> <dir>

``<dir>`` holds what the test prepared (``data.pt``, ``params.pt``); each
rank writes its results there as ``<scenario>.rank<r>.pt``. The scenarios
run in a fixed order on every rank (their collectives must pair up), the
CLI run last: ``cli.main`` leaves the process group at its end. Imports the
port only.
"""
import os
import sys
import time

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import ProteinSplit, collate
from protein_transformer_tpu_torch.data.device_store import (
    DeviceStore, plan_batch)
from protein_transformer_tpu_torch.parallel.distributed import (
    initialize_from_env)
from protein_transformer_tpu_torch.parallel.mesh import make_mesh
from protein_transformer_tpu_torch.parallel.sharding import gather_params
from protein_transformer_tpu_torch.training import cli
from protein_transformer_tpu_torch.training.checkpoint import (
    checkpoint_policy)
from protein_transformer_tpu_torch.training.trainer import Trainer

CPU = torch.device("cpu")
# the model and the run of every scenario: 15 real proteins a batch,
# padded to 16 rows, so the two 'data' ranks hold 8 and 7
SMALL = dict(model="conv-enc|5,3|1,1", d_model=16, d_ff=32, n_heads=2,
             n_layers=1, batch_size=15, loss="combined", dropout=0.0,
             optimizer="adam", lr_scheduling="noam", n_warmup_steps=10,
             batching_order="descending", log_structure_step=0,
             log_val_struct_step=0, cluster=True, seed=3)
# the CLI run: with structure logging (the whole batch gathered from the
# sharded store on every rank) and wandb (a recording module; the gradient
# probe on every rank, the predictions gathered over 'data')
CLI_ARGS = ["-m", "conv-enc|5,3|1,1", "-dm", "16", "-dih", "32", "-nh", "2",
            "-nl", "1", "-e", "2", "-b", "15", "-l", "combined", "-opt",
            "adam", "--lr_scheduling", "noam", "-nws", "10", "-do", "0",
            "--batching_order", "descending", "-s", "3", "-c", "True",
            "--log_structure_step", "2", "-lvs", "3", "--use_wandb", "True",
            "--device", "cpu"]
# the cut of the sharded-gather scenario: shorter than some proteins
CUT = 24


def run_cli(argv: list) -> dict:
    """``cli.main(argv)`` under a recording wandb module; what the run
    logged, where one was made (rank 0): each train row's RMSE, the counts
    summed of each histogram by key, and every key."""
    from chip_smoke import recording_wandb
    with recording_wandb() as runs:
        cli.main(argv)
    if not runs:
        return {}
    logged = runs[0].logged
    totals: dict = {}
    for payload in logged:
        for key, value in payload.items():
            hist = getattr(value, "np_histogram", None)
            if hist is not None:
                totals.setdefault(key, []).append(int(np.sum(hist[0])))
    return {"rmse": [p["Train Batch RMSE"] for p in logged
                     if "Train Batch RMSE" in p],
            "totals": totals, "keys": runs[0].keys()}


def save(where, scenario, rank, value):
    torch.save(value, os.path.join(where, f"{scenario}.rank{rank}.pt"))


def trainer(where, data, name, mesh_shape, mesh_axes, **kw):
    cfg = TrainConfig(**{**SMALL, "out_dir": where, "name": name,
                         "mesh_shape": mesh_shape, "mesh_axes": mesh_axes,
                         **kw})
    return Trainer(cfg, device=CPU, data=data)


def first_batch(tr):
    """The first 15 training proteins, collated (16 rows)."""
    return collate(tr.dm.train, np.arange(15), tr.cfg.bucket_sizes,
                   tr.dm.max_seq_len, batch_multiple=tr.dm.batch_multiple)


def sharded_gather(where, data, rank):
    """(b): the sharded store's rows of a plan with a dead row and cut
    proteins."""
    mesh = make_mesh((-1,), ("data",), CPU)
    raw = data["train"]
    split = ProteinSplit(raw["seq"], raw["ang"], raw["crd"],
                         max_seq_len=CUT)
    store = DeviceStore(split, CPU, mesh)
    assert store.sharded and store.store["seq"].shape[0] < sum(split.lens)
    out = {}
    for name, idx in (("dead_row", np.arange(3, 18)),
                      ("cut", np.argsort(-split.lens)[:4])):
        plan = plan_batch(split, idx, (16, CUT), CUT, batch_multiple=2)
        rows, whole = store.batch(plan), store.batch(plan, whole=True)
        out[name] = {"idx": idx, "rows": rows, "whole": whole}
    save(where, "gather", rank, out)


def one_step(where, data, rank, mesh_shape, mesh_axes, tag, **kw):
    """(d), (g): loss and full gradients of one step from the test's
    weights (with ``kw``, another model's: seeded fresh ones), and the
    clip's norm."""
    tr = trainer(where, data, tag, mesh_shape, mesh_axes, **kw)
    params = (tr.init_params(torch.Generator().manual_seed(5)) if kw
              else torch.load(os.path.join(where, "params.pt")))
    state = tr.state_from(params)
    batch = tr._put(first_batch(tr))
    loss, out, grads = tr.loss_and_grads(state.params, batch)
    *grads, loss = tr._sum_over_data([*grads, loss.detach()])
    full = gather_params(dict(zip(state.params, grads)), tr.layout,
                         tr.model_axis)
    norms = torch.stack(torch._foreach_norm(list(full.values())))
    save(where, tag, rank, {
        "loss": float(loss), "grads": full, "layout": tr.layout,
        "real_rows": int(batch.protein_mask.sum()),
        "clip_norm": float(tr.tx.global_norm(
            grads, [k in tr.layout for k in state.params])),
        "full_norm": float(torch.linalg.vector_norm(norms))})


def policy(where, rank):
    """(f): process 0's time decision wins: rank 0's last checkpoint is
    hours old, rank 1's has just been written."""
    last = 0.0 if rank == 0 else time.time()
    got = checkpoint_policy(4.5, [5.0, 4.0, 4.5], last, 1.0, process_count=2)
    save(where, "policy", rank, got)


def tp_run(where, data, rank):
    """(f): one epoch under (1, 2), its 'best' checkpoint and its metrics."""
    tr = trainer(where, data, "tp", (1, 2), ("data", "model"), epochs=1)
    assert tr.layout, "no parameter is sharded over 'model'"
    tr.train()
    save(where, "tp_run", rank, {k: tr.metrics[k] for k in tr.dm.eval_splits})


def replicas(where, data, rank):
    """(e): three steps at dropout 0.1 under (2, 2); this rank's
    parameters."""
    tr = trainer(where, data, "replicas", (2, 2), ("data", "model"),
                 dropout=0.1)
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = first_batch(tr)
    for _ in range(3):
        state, _ = tr.train_step(state, batch)
    save(where, "replicas", rank, {
        "params": {k: v.detach() for k, v in state.params.items()},
        "layout": tr.layout, "coords": (tr.data_axis.rank,
                                        tr.model_axis.rank)})


def main():
    world, where = sys.argv[1], sys.argv[2]
    rank, _ = initialize_from_env(CPU)
    data = torch.load(os.path.join(where, "data.pt"), weights_only=False)
    out = os.path.join(where, world)
    if world == "world2":
        sharded_gather(where, data, rank)
        one_step(where, data, rank, (-1,), ("data",), "step_dp")
        one_step(where, data, rank, (1, 2), ("data", "model"), "step_tp")
        one_step(where, data, rank, (2,), ("data",), "step_enc_dec_dp",
                 model="enc-dec")
        one_step(where, data, rank, (1, 2), ("data", "model"),
                 "step_enc_dec_tp", model="enc-dec")
        policy(where, rank)
        tp_run(where, data, rank)
        mesh = ["--mesh_shape", "-1"]
    else:
        replicas(where, data, rank)
        mesh = ["--mesh_shape", "2", "2", "--mesh_axes", "data", "model"]
    logged = run_cli(["--data", os.path.join(where, "data.pt"), "--name",
                      "dist", "--out_dir", out, *CLI_ARGS, *mesh])
    save(where, f"wandb_{world}", rank, logged)
    print("done rank", rank)


if __name__ == "__main__":
    main()
