"""Group predicted/true structure pairs by alignment quality.

The port's counterpart of ptt_scripts/group_predictions.py, the PyMOL-free
rebuild of the reference's scripts/group_pymol_by_prediction.py:1-24. It
walks a predictions directory (the output of
``protein_transformer_tpu_torch.predict``: ``<id>_pred.pdb`` /
``<id>_true.pdb`` pairs, or ``<id>_recon.pdb`` in place of a prediction),
superposes each pair by a Kabsch fit on their shared atoms (numpy, on the
host) and writes:

* one multi-model PDB per pair, ``<bucket>/<id>_<rmsd:.2f>.pdb``
  (MODEL 1 = true, MODEL 2 = the aligned prediction);
* ``summary.tsv`` ranking all pairs by RMSD.

Buckets follow GDT-style thresholds: excellent (<2 A), good (<5 A),
fair (<10 A), poor (>=10 A).

Run: python -m protein_transformer_tpu_torch.scripts.group_predictions \
         <predictions_dir> [--out grouped]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from protein_transformer_tpu_torch.protein.pdb import parse_pdb_atoms


def kabsch(mobile: np.ndarray, target: np.ndarray):
    """Least-squares superposition: (rotation, t_mobile, t_target, rmsd)
    such that (mobile - t_mobile) @ rotation + t_target fits target (pymol
    cmd.align's final fit, without its sequence alignment: atoms are
    matched by name here)."""
    mu_m, mu_t = mobile.mean(0), target.mean(0)
    m, t = mobile - mu_m, target - mu_t
    u, _s, vt = np.linalg.svd(m.T @ t)
    d = np.sign(np.linalg.det(u @ vt))
    rot = u @ np.diag([1.0, 1.0, d]) @ vt
    fitted = m @ rot
    rmsd = float(np.sqrt(((fitted - t) ** 2).sum(-1).mean()))
    return rot, mu_m, mu_t, rmsd


def match_atoms(true_path: str, pred_path: str):
    """(true, predicted) coordinates of the atoms both files hold, keyed by
    (residue number, atom name), and every predicted coordinate; None when
    they share no atom."""
    tn, _tr, tnum, txyz = parse_pdb_atoms(true_path)
    pn, _pr, pnum, pxyz = parse_pdb_atoms(pred_path)
    t_index = {(num, name): i for i, (num, name) in enumerate(zip(tnum, tn))}
    pairs = [(t_index[(num, name)], j)
             for j, (num, name) in enumerate(zip(pnum, pn))
             if (num, name) in t_index]
    if not pairs:
        return None
    ti, pi = zip(*pairs)
    return txyz[list(ti)], pxyz[list(pi)], pxyz


def bucket_of(rmsd: float) -> str:
    if rmsd < 2.0:
        return "excellent"
    if rmsd < 5.0:
        return "good"
    if rmsd < 10.0:
        return "fair"
    return "poor"


def _shift_pdb_lines(path: str, rot, t_mobile, t_target) -> list[str]:
    """The file's lines, each ATOM line's coordinates replaced by their
    aligned positions."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("ATOM"):
                xyz = np.array([float(line[30:38]), float(line[38:46]),
                                float(line[46:54])])
                x, y, z = (xyz - t_mobile) @ rot + t_target
                line = (line[:30] + f"{x:8.3f}{y:8.3f}{z:8.3f}" + line[54:])
            out.append(line.rstrip("\n"))
    return out


def group_predictions(pred_dir: str, out_dir: str) -> list[tuple]:
    """[(id, rmsd, bucket, out_path)], best first."""
    results = []
    for true_path in sorted(glob.glob(os.path.join(pred_dir, "*_true.pdb"))):
        pid = os.path.basename(true_path)[: -len("_true.pdb")]
        pred_path = os.path.join(pred_dir, f"{pid}_pred.pdb")
        if not os.path.exists(pred_path):
            pred_path = os.path.join(pred_dir, f"{pid}_recon.pdb")
            if not os.path.exists(pred_path):
                continue
        matched = match_atoms(true_path, pred_path)
        if matched is None:
            continue
        t_shared, p_shared, _ = matched
        rot, mu_p, mu_t, rmsd = kabsch(p_shared, t_shared)
        bucket = bucket_of(rmsd)
        bucket_dir = os.path.join(out_dir, bucket)
        os.makedirs(bucket_dir, exist_ok=True)
        out_path = os.path.join(bucket_dir, f"{pid}_{rmsd:.2f}.pdb")
        with open(true_path) as f:
            true_lines = [ln.rstrip("\n") for ln in f
                          if not ln.startswith("END")]
        pred_lines = _shift_pdb_lines(pred_path, rot, mu_p, mu_t)
        with open(out_path, "w") as f:
            f.write("MODEL     1\n")
            f.write("\n".join(true_lines) + "\nENDMDL\n")
            f.write("MODEL     2\n")
            f.write("\n".join(ln for ln in pred_lines
                              if not ln.startswith("END")) + "\nENDMDL\n")
            f.write("END\n")
        results.append((pid, rmsd, bucket, out_path))
    results.sort(key=lambda r: r[1])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "summary.tsv"), "w") as f:
        f.write("id\trmsd\tbucket\tfile\n")
        for pid, rmsd, bucket, path in results:
            f.write(f"{pid}\t{rmsd:.3f}\t{bucket}\t{path}\n")
    return results


def main(argv=None) -> list[tuple]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("pred_dir", help="directory of *_pred.pdb/*_true.pdb pairs")
    p.add_argument("--out", default="grouped")
    args = p.parse_args(argv)
    results = group_predictions(args.pred_dir, args.out)
    for pid, rmsd, bucket, _path in results:
        print(f"{pid}\t{rmsd:.2f}\t{bucket}")
    print(f"{len(results)} pairs grouped under {args.out}/")
    return results


if __name__ == "__main__":
    main()
