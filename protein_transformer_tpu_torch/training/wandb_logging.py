"""Optional Weights & Biases logging.

Port of protein_transformer_tpu/training/wandb_logging.py, function for
function. Disabled when wandb is not requested or cannot be imported (one
line is printed and nothing is logged). The project, the config payload, the
metric names ('Train Batch RMSE', '<Mode> Epoch DRMSD', 'Valid-Avg Epoch
...', the angle histograms) and the run summaries are the JAX package's,
string for string, so dashboards carry over; MSE is logged as RMSE. The
parameter and gradient histograms are keyed by each parameter's flax path
(``models/flax_import.py::flax_names``), as the JAX package keys them.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from protein_transformer_tpu_torch.models.flax_import import flax_names


def try_init_wandb(cfg, n_params: int, angle_means) -> Optional[object]:
    """wandb.init with the config payload, or None when wandb is off or
    absent."""
    if not getattr(cfg, "use_wandb", False):
        return None
    try:
        import wandb
    except ImportError:
        print("[wandb] not installed; disabling wandb logging")
        return None
    run = wandb.init(project="protein-transformer-tpu", name=cfg.name,
                     config=cfg.to_dict())
    run.config.update({"n_params": n_params,
                       "max_seq_len": cfg.max_seq_len}, allow_val_change=True)
    run.summary["stopped_training_early"] = False
    run.summary["max_batch_size"] = cfg.batch_size
    return run


def _np_histogram(values: np.ndarray):
    """np.histogram of ``values``: the JAX module's bins; where numpy cannot
    make 10 bins in float32 (all values within a few ulps of each other,
    as a LayerNorm scale a few warm-up steps from 1.0 is; numpy >= 2.1
    raises there, and so does the JAX module), the bins of the values in
    float64."""
    try:
        return np.histogram(values)
    except ValueError:
        return np.histogram(values.astype(np.float64))


def _histogram(value: torch.Tensor):
    import wandb
    # non-finite values surface through the NaN watchdog, not as a range
    # error of np.histogram here; the bins do not depend on element order,
    # so the port's transposed layouts give the JAX package's histograms
    return wandb.Histogram(np_histogram=_np_histogram(
        np.nan_to_num(value.detach().cpu().numpy())))


def watch_params(run, model: nn.Module, params: dict,
                 grads: Optional[dict] = None) -> None:
    """Histograms of every parameter of ``model`` (``params``: name ->
    tensor, as the trainer holds them) and of its gradient (``grads``, the
    same keys), logged once an epoch as 'parameters/params/<flax path>' and
    'gradients/params/<flax path>', in flax's sorted order."""
    if run is None:
        return
    names = sorted(flax_names(model).items(),
                   key=lambda kv: kv[1].split("/"))
    payload = {}
    for prefix, values in (("parameters", params), ("gradients", grads)):
        if values is None:
            continue
        for name, path in names:
            payload[f"{prefix}/params/{path}"] = _histogram(values[name])
    run.log(payload, commit=False)


def save_model_txt(run, model, out_dir: str) -> None:
    """MODEL.txt with the model's architecture string."""
    path = os.path.join(out_dir, "MODEL.txt")
    with open(path, "w") as f:
        f.write(str(model) + "\n")
    if run is not None:
        run.save(path, base_path=out_dir)


def mirror_run_files(run, out_dir: str) -> None:
    """Live mirroring of the checkpoints, structures and CSV log."""
    if run is None:
        return
    for pattern in ("checkpoints/*", "structures/*", "*.train"):
        run.save(os.path.join(out_dir, pattern), base_path=out_dir,
                 policy="live")


def log_checkpoint_summary(run, modifier: str, cur_loss: float, epoch: int,
                           metrics: dict, train_only: bool) -> None:
    """Run summaries stamped at checkpoint time."""
    if run is None:
        return
    run.summary[f"{modifier}_validation_loss"] = cur_loss
    run.summary[f"{modifier}_validation_epoch"] = epoch
    hist = metrics["train"]["speed-history"]
    if hist:
        run.summary["avg_training_speed"] = float(np.mean(hist))
    if not train_only:
        # averaged over whichever validation splits the dataset carries
        hists = [metrics[m]["speed-history"] for m in metrics
                 if isinstance(metrics.get(m), dict)
                 and m.startswith("valid")
                 and metrics[m].get("speed-history")]
        if hists:
            run.summary["avg_evaluation_speed"] = float(
                np.mean(np.concatenate(hists)))


def log_final_epoch_summary(run, mode: str, m: dict) -> None:
    """final_epoch_<mode>_* summaries, refreshed every epoch so that the run
    ends with its last epoch's values."""
    if run is None:
        return
    hist = m.get("speed-history") or [0.0]
    run.summary[f"final_epoch_{mode}_drmsd"] = m["epoch-drmsd-full"]
    run.summary[f"final_epoch_{mode}_mse"] = m["epoch-mse-full"]
    run.summary[f"final_epoch_{mode}_rmsd"] = m["epoch-rmsd-full"]
    run.summary[f"final_epoch_{mode}_comb"] = m["epoch-combined-full"]
    run.summary[f"final_epoch_{mode}_speed"] = float(np.mean(hist))


def log_early_stop(run) -> None:
    """stopped_training_early flips to True on an early stop."""
    if run is None:
        return
    run.summary["stopped_training_early"] = True


def log_train_batch(run, losses: dict, batch_size: int, speed: float,
                    lr: Optional[float] = None) -> None:
    if run is None:
        return
    payload = {
        "Train Batch RMSE": float(np.sqrt(losses["mse-full"])),
        "Train Batch DRMSD": losses["drmsd-full"],
        "Train Batch ln-DRMSD": losses["lndrmsd-full"],
        "Train Batch Combined Loss": losses["combined-full"],
        "Train Batch Speed": speed,
        "Batch size": batch_size,
        "Train Batch DRMSD Backbone": losses["drmsd-bb"],
        "Train Batch ln-DRMSD Backbone": losses["lndrmsd-bb"],
        "Train Batch RMSE Backbone": float(np.sqrt(losses["mse-bb"])),
        "Train Batch RMSE Sidechain": float(np.sqrt(losses["mse-sc"])),
    }
    if lr is not None:
        payload["Learning Rate"] = lr
    run.log(payload)


def log_eval_epoch(run, mode: str, m: dict) -> None:
    if run is None:
        return
    run.log({
        f"{mode.title()} Epoch RMSE": float(np.sqrt(m["epoch-mse-full"])),
        f"{mode.title()} Epoch RMSD": m["epoch-rmsd-full"],
        f"{mode.title()} Epoch DRMSD": m["epoch-drmsd-full"],
        f"{mode.title()} Epoch ln-DRMSD": m["epoch-lndrmsd-full"],
        f"{mode.title()} Epoch Combined Loss": m["epoch-combined-full"],
        f"{mode.title()} Epoch ln-DRMSD Backbone": m["epoch-lndrmsd-bb"],
        f"{mode.title()} Epoch DRMSD Backbone": m["epoch-drmsd-bb"],
        f"{mode.title()} Epoch RMSE Backbone": float(
            np.sqrt(m["epoch-mse-bb"])),
        f"{mode.title()} Epoch RMSE Sidechain": float(
            np.sqrt(m["epoch-mse-sc"])),
    }, commit=False)


def log_avg_validation(run, metrics: dict, splits) -> None:
    """Averages over the validation splits."""
    if run is None or not splits:
        return
    acc: dict[str, float] = {}
    for split in splits:
        m = metrics[split]
        acc["Valid-Avg Epoch RMSE"] = acc.get("Valid-Avg Epoch RMSE", 0) + \
            float(np.sqrt(m["epoch-mse-full"]))
        acc["Valid-Avg Epoch RMSD"] = acc.get("Valid-Avg Epoch RMSD", 0) + \
            m["epoch-rmsd-full"]
        acc["Valid-Avg Epoch DRMSD"] = acc.get("Valid-Avg Epoch DRMSD", 0) + \
            m["epoch-drmsd-full"]
        acc["Valid-Avg Epoch ln-DRMSD"] = acc.get(
            "Valid-Avg Epoch ln-DRMSD", 0) + m["epoch-lndrmsd-full"]
        acc["Valid-Avg Epoch Combined Loss"] = acc.get(
            "Valid-Avg Epoch Combined Loss", 0) + m["epoch-combined-full"]
    n = len(list(splits))
    run.log({k: v / n for k, v in acc.items()}, commit=False)


def log_angle_histograms(run, pred_sincos: np.ndarray,
                         seq_ids: np.ndarray, pad_id: int) -> None:
    """Histograms of the predicted sin/cos pairs and of their angles over
    the real residues (``seq_ids != pad_id``)."""
    if run is None:
        return
    import wandb
    sel = seq_ids != pad_id
    flat = pred_sincos[sel]
    radians = np.arctan2(flat.reshape(-1, 12, 2)[..., 1],
                         flat.reshape(-1, 12, 2)[..., 0])
    run.log({"Predicted Angles (sin cos)":
             wandb.Histogram(np_histogram=_np_histogram(flat)),
             "Predicted Angles (radians)":
             wandb.Histogram(np_histogram=_np_histogram(radians))},
            commit=False)
