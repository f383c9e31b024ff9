"""Structure logging during training, off the train loop's thread.

Port of protein_transformer_tpu/training/structure_logging.py. Every
``log_structure_step`` train steps the trainer hands the logger one
protein's predicted coordinates; every ``log_val_struct_step`` steps, one
protein of each validation split. Under
``<out_dir>/structures/<name>/`` (name = "train" or "V<split>") the logger
writes

* ``<step>_pred.pdb`` and ``<step>_pred.glb``: the prediction as a PDB file
  and as a glTF binary with real bond topology;
* ``true.pdb`` and ``true.glb``, once: the true structure, missing atoms
  left out;
* ``<step>_scene.glb``: the prediction Kabsch-aligned onto the true
  structure, both in one scene (where at least 3 true atoms exist and the
  prediction is finite: a diverged step has no alignment, and the NaN
  watchdog, not the logger, reports it);
* ``<step>.png`` with ``save_pngs``: a matplotlib render of the two CA
  traces.

Writing happens on a worker thread. The coordinates may arrive as a tensor
still on the GPU: the copy to the host, which waits for the device, is made
by the worker, never by the train loop. When the worker is backed up (more
than 4 structures waiting) a new one is dropped. A failure of the worker,
other than of the optional PNG render, stops it and is raised in the train
loop by the next ``log`` or by ``close``. Given a wandb run (``wandb_run``,
which the trainer sets when it opens one) the worker also logs, with
``commit=False``, ``<name>_mol`` (a ``wandb.Molecule`` of the PDB file),
``<name>_3d`` (a ``wandb.Object3D`` of the .glb), ``<name>_scene`` and
``<name>_align_rmsd`` where the aligned scene was written, and
``<name>_png`` (a ``wandb.Image``) where the PNG was, as the JAX package
logs them.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from protein_transformer_tpu_torch.protein.gltf import (
    save_glb, save_glb_scene)
from protein_transformer_tpu_torch.protein.pdb import PdbWriter
from protein_transformer_tpu_torch.protein.vocab import VOCAB

# seconds close() gives the worker to write what is waiting
CLOSE_TIMEOUT = 60.0

# the true structure's color in the aligned scene; the prediction keeps the
# backbone / sidechain palette
_TRUE_COLOR = (0.55, 0.55, 0.55, 1.0)


def kabsch_align(mobile: np.ndarray, target: np.ndarray):
    """Least-squares rigid alignment of mobile onto target ((N, 3) each).

    Returns (transform, rmsd): transform(x) maps any (..., 3) points with
    the fitted rotation and translation, so that a whole structure can be
    moved into the target's frame."""
    mu_m, mu_t = mobile.mean(0), target.mean(0)
    h = (mobile - mu_m).T @ (target - mu_t)
    u, _s, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T

    def transform(x):
        return (x - mu_m) @ r.T + mu_t

    rmsd = float(np.sqrt(np.mean(
        np.sum((transform(mobile) - target) ** 2, axis=-1))))
    return transform, rmsd


def render_structure_png(path: str, pred_crd: np.ndarray,
                         true_crd: np.ndarray | None = None,
                         true_mask: np.ndarray | None = None) -> None:
    """3-D CA-trace render (pred solid, true dashed) to a PNG file."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ca = pred_crd[:, 1]
    ax.plot(ca[:, 0], ca[:, 1], ca[:, 2], color="#4682B4", lw=2,
            label="pred")
    if true_crd is not None:
        tca = true_crd[:, 1].copy()
        if true_mask is not None:
            tca = np.where(true_mask[:, 1, None], tca, np.nan)
        ax.plot(tca[:, 0], tca[:, 1], tca[:, 2], color="#FFBF26", lw=2,
                ls="--", label="true")
    ax.set_axis_off()
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def _to_numpy(x) -> np.ndarray:
    """A host array of x; for a tensor on the GPU this waits for the device,
    so only the worker thread calls it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class StructureLogger:
    """Writes the structures it is handed under ``<out_dir>/structures``,
    on a daemon thread that the first ``log`` starts and ``close`` stops."""

    def __init__(self, out_dir: str, wandb_run=None,
                 save_pngs: bool = False):
        self.dir = os.path.join(out_dir, "structures")
        os.makedirs(self.dir, exist_ok=True)
        self.wandb_run = wandb_run
        self.save_pngs = save_pngs
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._error: Exception | None = None
        self._thread: threading.Thread | None = None

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write(*item)
            except Exception as e:  # kept for the train loop to raise
                self._error = e
                return

    def _raise_worker_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("the structure logger's worker failed") \
                from self._error

    def _write(self, step, name, seq_ids, pred_crd, true_crd, true_mask):
        seq_ids = _to_numpy(seq_ids)
        pred_crd = _to_numpy(pred_crd)
        true_crd = _to_numpy(true_crd)
        true_mask = _to_numpy(true_mask)
        sel = seq_ids != VOCAB.pad_id
        seq_str = VOCAB.ints2str(seq_ids[sel])
        li = int(sel.sum())
        sub = os.path.join(self.dir, name)
        os.makedirs(sub, exist_ok=True)
        pred_path = os.path.join(sub, f"{step:05d}_pred.pdb")
        PdbWriter(pred_crd[:li], seq_str).save_pdb(pred_path, title="pred")
        glb_path = os.path.join(sub, f"{step:05d}_pred.glb")
        save_glb(glb_path, pred_crd[:li], seq_ids[sel])
        true_path = os.path.join(sub, "true.pdb")
        if not os.path.exists(true_path):
            masked = np.where(true_mask[:li, :, None], true_crd[:li], np.nan)
            PdbWriter(masked, seq_str).save_pdb(true_path, title="true")
            save_glb(os.path.join(sub, "true.glb"), true_crd[:li],
                     seq_ids[sel], atom_mask=true_mask[:li])
        # one aligned scene: pred Kabsch-aligned onto true, both in one .glb
        align_rmsd = None
        scene_path = os.path.join(sub, f"{step:05d}_scene.glb")
        valid = true_mask[:li].reshape(-1)
        if valid.sum() >= 3 and np.isfinite(pred_crd[:li]).all():
            tf, align_rmsd = kabsch_align(
                pred_crd[:li].reshape(-1, 3)[valid],
                true_crd[:li].reshape(-1, 3)[valid])
            aligned = tf(pred_crd[:li].reshape(-1, 3)).reshape(li, -1, 3)
            save_glb_scene(scene_path, [
                (aligned, seq_ids[sel], None, None),
                (true_crd[:li], seq_ids[sel], true_mask[:li], _TRUE_COLOR),
            ])
        png_path = None
        if self.save_pngs:
            png_path = os.path.join(sub, f"{step:05d}.png")
            try:
                render_structure_png(png_path, pred_crd[:li], true_crd[:li],
                                     true_mask[:li])
            except Exception as e:  # an optional render must not end a run
                print(f"[structure-log] png render failed: {e}")
                png_path = None
        if self.wandb_run is not None:
            self._log_wandb(name, pred_path, glb_path, scene_path,
                            align_rmsd, png_path)

    def _log_wandb(self, name, pred_path, glb_path, scene_path, align_rmsd,
                   png_path) -> None:
        import wandb
        with open(glb_path, "rb") as f:
            payload = {f"{name}_mol": wandb.Molecule(pred_path),
                       f"{name}_3d": wandb.Object3D(f, file_type="glb")}
        if align_rmsd is not None:
            with open(scene_path, "rb") as f:
                payload[f"{name}_scene"] = wandb.Object3D(f, file_type="glb")
            payload[f"{name}_align_rmsd"] = align_rmsd
        if png_path:
            payload[f"{name}_png"] = wandb.Image(png_path)
        self.wandb_run.log(payload, commit=False)

    def log(self, step: int, name: str, seq_ids, pred_crd, true_crd,
            true_mask) -> None:
        """Hand one structure to the worker; dropped if 4 are waiting.

        seq_ids (L,), pred_crd (L, 14, 3), true_crd (L, 14, 3), true_mask
        (L, 14): numpy arrays or tensors on any device."""
        self._raise_worker_error()
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        try:
            self._q.put_nowait((step, name, seq_ids, pred_crd, true_crd,
                                true_mask))
        except queue.Full:
            pass

    def close(self) -> None:
        """Write what is waiting, then stop the worker."""
        timeout = CLOSE_TIMEOUT
        if self._thread is not None and self._thread.is_alive():
            try:
                self._q.put(None, timeout=timeout)
            except queue.Full:
                pass  # the worker died with a full queue: raised below
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError("the structure logger's worker did not "
                                   f"finish within {timeout} s")
        self._thread = None  # a later log() starts a new worker
        self._raise_worker_error()
