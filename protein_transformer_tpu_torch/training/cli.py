"""Command-line interface of the port (the reference's train.py argparse
surface).

Port of protein_transformer_tpu/training/cli.py: the same flags, aliases and
defaults onto ``TrainConfig`` fields, with a "GPU Args" group in place of
the "TPU Args" group. The run goes to the GPU unless ``--device cpu`` asks
for the CPU; without a GPU ``--device cuda`` raises. The flags that the JAX
package itself accepts and ignores (``--sequential_drmsd_loss``,
``--no_cuda``) stay accepted and ignored.

Run:  python -m protein_transformer_tpu_torch.training.cli --data <path> [...]

Multi-GPU (``--mesh_shape`` / ``--mesh_axes``; one process per card, each
on its own card): launch one process per rank with ``PTT_DISTRIBUTED=1``
under ``python -m torch.distributed.run --nproc_per_node N``, or set
``PTT_COORDINATOR=host:port``, ``PTT_NUM_PROCESSES`` and ``PTT_PROCESS_ID``
for each process (``parallel/distributed.py``).
"""
from __future__ import annotations

import argparse
import dataclasses

from protein_transformer_tpu_torch.config import TrainConfig


def my_bool(s):
    return s != "False"


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="protein-transformer-tpu-torch")
    req = p.add_argument_group("Required Args")
    req.add_argument("--data", default=TrainConfig.data,
                     help="Path to training data (.pt or native dir).")
    req.add_argument("--name", type=str, default=None)

    t = p.add_argument_group("Training Args")
    t.add_argument("-lr", "--learning_rate", type=float, default=1e-4)
    t.add_argument("-e", "--epochs", type=int, default=10)
    t.add_argument("-b", "--batch_size", type=int, default=8)
    t.add_argument("-es", "--early_stopping", type=int, default=20)
    t.add_argument("-nws", "--n_warmup_steps", type=int, default=10_000)
    t.add_argument("-cg", "--clip", type=float, default=1.0)
    t.add_argument("-l", "--loss", default="combined",
                   choices=["mse", "drmsd", "lndrmsd", "combined"])
    t.add_argument("--train_only", action="store_true")
    t.add_argument("--lr_scheduling", choices=["noam", "plateau"],
                   default="plateau")
    t.add_argument("--patience", type=int, default=10)
    t.add_argument("--early_stopping_threshold", type=float, default=0.001)
    t.add_argument("-esm", "--early_stopping_metric", default=None)
    t.add_argument("--without_angle_means", action="store_true")
    t.add_argument("--eval_train", type=my_bool, default="False")
    t.add_argument("-opt", "--optimizer", choices=["adam", "sgd"],
                   default="sgd")
    t.add_argument("-fctf", "--fraction_complete_tf", type=float, default=1.0)
    t.add_argument("-fsstf", "--fraction_subseq_tf", type=float, default=1.0)
    t.add_argument("--skip_missing_res_train", type=my_bool, default="False")
    t.add_argument("--repeat_train", type=int, default=1)
    t.add_argument("-s", "--seed", type=int, default=11_731)
    t.add_argument("--combined_drmsd_weight", type=float, default=0.5)
    t.add_argument("--batching_order", default="binned-random",
                   choices=["descending", "ascending", "binned-random"])
    t.add_argument("--backbone_loss", action="store_true")
    t.add_argument("--full_metrics", action="store_true",
                   help="with --backbone_loss, report genuinely full-atom "
                        "dRMSD/RMSD metrics instead of the reference's "
                        "backbone-reduced 'full' columns")
    t.add_argument("--grad_semantics", choices=["mean", "reference"],
                   default="mean")
    t.add_argument("--bins", type=int, default=-1)
    t.add_argument("--train_eval_downsample", type=float, default=0.10)
    t.add_argument("--sequential_drmsd_loss", action="store_true",
                   help="(ignored: dRMSD is always computed in the step)")
    t.add_argument("--automatically_determine_batch_size", "-adbs",
                   type=my_bool, default="False",
                   help="probe the largest batch size that fits on the "
                        "device before training and use 0.8x of it "
                        "(reference train.py:532-551)")

    m = p.add_argument_group("Model Args")
    m.add_argument("-m", "--model", default="enc-only")
    m.add_argument("-dm", "--d_model", type=int, default=512)
    m.add_argument("-dih", "--d_ff", "--d_inner_hid", dest="d_ff", type=int,
                   default=2048)
    m.add_argument("-nh", "--n_heads", "--n_head", dest="n_heads", type=int,
                   default=8)
    m.add_argument("-nl", "--n_layers", type=int, default=6)
    m.add_argument("-do", "--dropout", type=float, default=0.1)
    m.add_argument("--postnorm", action="store_true")
    m.add_argument("--weight_decay", type=my_bool, default="True")
    for i in (1, 2, 3):
        m.add_argument(f"--conv{i}_size", type=int, default=None)
        m.add_argument(f"--conv{i}_reduc", type=float, default=None)
    m.add_argument("--use_embedding", type=my_bool, default="True")
    m.add_argument("--conv_out_matches_dm", type=my_bool, default="True")

    s = p.add_argument_group("Saving Args")
    s.add_argument("--log_structure_step", type=int, default=10)
    s.add_argument("--log_val_struct_step", "-lvs", type=int, default=50)
    s.add_argument("--log_wandb_step", type=int, default=1)
    s.add_argument("--save_pngs", "-png", type=my_bool, default="False")
    s.add_argument("--no_cuda", action="store_true",
                   help="(ignored: the device is picked by --device)")
    s.add_argument("--restart", action="store_true")
    s.add_argument("--restart_opt", action="store_true")
    s.add_argument("--checkpoint_time_interval", type=float, default=0.0)
    s.add_argument("--load_chkpt", type=str, default=None)
    s.add_argument("--out_dir", type=str, default="runs")
    s.add_argument("--use_wandb", type=my_bool, default="False")
    # limited-I/O mode: no live per-batch status line
    s.add_argument("-c", "--cluster", type=my_bool, default="False")

    gpu = p.add_argument_group("GPU Args")
    gpu.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="cuda needs a GPU and raises without one; the CPU "
                          "is used only when asked for")
    gpu.add_argument("--drmsd_impl", choices=["auto", "cuda", "torch"],
                     default="auto",
                     help="dRMSD pair sweep and the RMSD's superposition: "
                          "the hand-written CUDA kernels, the plain PyTorch "
                          "versions, or auto (cuda on a CUDA device)")
    gpu.add_argument("--sidechain_impl", choices=["auto", "cuda", "torch"],
                     default="auto",
                     help="sidechain build: as --drmsd_impl")
    gpu.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                     default="float32",
                     help="the dtype the model computes in; parameters, "
                          "output head and losses stay float32")
    gpu.add_argument("--mesh_shape", type=int, nargs="+", default=[-1])
    gpu.add_argument("--mesh_axes", type=str, nargs="+", default=["data"])
    gpu.add_argument("--attention_impl", choices=["auto", "xla", "flash"],
                     default="auto",
                     help="encoder self-attention: xla materialises the "
                          "probabilities; flash sends eval steps and "
                          "dropout-0 training through the hand-written "
                          "flash kernels (CUDA; the plain version on the "
                          "CPU) and keeps the materialised branch for "
                          "training with dropout > 0; auto = xla")
    gpu.add_argument("--profile_dir", type=str, default=None,
                     help="write a torch.profiler Chrome trace of the first "
                          "trained epoch into this directory")
    gpu.add_argument("--device_data", choices=["auto", "true", "false"],
                     default="auto",
                     help="hold each split on the device and assemble a "
                          "batch by one gather there (true), collate host "
                          "batches on a prefetch thread (false), or auto: "
                          "the store when the splits fit "
                          "--device_data_max_mb")
    gpu.add_argument("--device_data_max_mb", type=int, default=4096)
    return p


def _config(args: argparse.Namespace) -> TrainConfig:
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    return TrainConfig(**kwargs).finalize()


def config_from_args(argv=None) -> TrainConfig:
    return _config(create_parser().parse_args(argv))


def main(argv=None):
    args = create_parser().parse_args(argv)
    cfg = _config(args)
    if cfg.name and "_" in cfg.name:
        raise ValueError("Model names must not contain '_' (conflicts with "
                         "structure files).")
    import torch

    from protein_transformer_tpu_torch.device import cuda_device
    from protein_transformer_tpu_torch.parallel import distributed
    from protein_transformer_tpu_torch.training.trainer import Trainer
    # each rank on its own card (the current one for a single process)
    device = (cuda_device(distributed.local_device_index())
              if args.device == "cuda" else torch.device("cpu"))
    trainer = Trainer(cfg, device=device)
    if cfg.automatically_determine_batch_size:
        # Probe the out-of-memory frontier at the longest bucket, then
        # rebuild the trainer at 0.8 of it (reference: train.py:532-551).
        from protein_transformer_tpu_torch.training import batch_probe
        b = batch_probe.probe_trainer_batch_size(trainer)
        print(f"[Info] automatically determined batch size: {b}")
        cfg = dataclasses.replace(
            cfg, batch_size=b, automatically_determine_batch_size=False)
        # drop the probed trainer and its device store before the new
        # trainer uploads its own
        del trainer
        batch_probe.release_memory()
        trainer = Trainer(cfg, device=device)
    state = trainer.train()
    distributed.shutdown()
    return state


if __name__ == "__main__":
    main()
