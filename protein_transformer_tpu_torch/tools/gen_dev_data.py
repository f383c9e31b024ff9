"""Generate the development dataset (the committed ``examples/dev_data``).

The port's counterpart of the JAX package's ``tools/gen_dev_data.py``, with
the same draws. A tiny frozen dataset of secondary-structure-realistic
chains for overfit/dev runs, plus helix and helix+sheet ID-list files
(reference: data/development/helices.txt, helices_betasheets.txt). Chains
are Ramachandran-realistic synthetics pushed through the FULL offline path:
angles -> geometry build (on a GPU its sidechain kernel) -> PDB file on
disk -> parser -> measurement -> sin/cos -> create_data_dict -> native
shards (``data/convert.py`` format).

One interface difference from the JAX tool: ``--out`` has no default, so
that no run overwrites the committed ``examples/dev_data`` by accident.

    python -m protein_transformer_tpu_torch.tools.gen_dev_data \\
        --out /tmp/dev_data [--device cpu]

``--device cuda`` (the default) needs a GPU and raises without one.
``diff_from`` holds a generated directory against another, as the port's
tests and ``chip_smoke.py`` hold one against ``examples/dev_data``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from protein_transformer_tpu_torch.data.convert import convert
from protein_transformer_tpu_torch.data.dataset import load_dataset
from protein_transformer_tpu_torch.data.proteinnet import create_data_dict
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.protein import measure
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES)
from protein_transformer_tpu_torch.protein.geometry import build_coords
from protein_transformer_tpu_torch.protein.pdb import PdbWriter
from protein_transformer_tpu_torch.protein.vocab import STD_AAS, VOCAB

SEED = 20260817
ID_LISTS = ("helices.txt", "helices_betasheets.txt")


def realistic_angles(rng, length, p_hel, p_sheet):
    """Ramachandran-clustered angles with controllable H/E/L composition."""
    ang = np.zeros((length, NUM_PREDICTED_ANGLES), np.float32)
    kinds = []
    while len(kinds) < length:
        kind = rng.choice(["H", "E", "L"],
                          p=[p_hel, p_sheet, 1.0 - p_hel - p_sheet])
        kinds.extend([kind] * int(rng.integers(4, 12)))
    kinds = kinds[:length]
    for i, k in enumerate(kinds):
        if k == "H":
            phi, psi, jit = -1.0, -0.82, 0.08       # -57, -47 deg
        elif k == "E":
            phi, psi, jit = -2.43, 2.36, 0.15       # -139, 135 deg
        else:
            phi = rng.uniform(-2.8, -0.5)
            psi = rng.uniform(-np.pi, np.pi)
            jit = 0.01
        ang[i, 0] = phi + rng.normal(0, jit)
        ang[i, 1] = psi + rng.normal(0, jit)
    omega = np.pi + rng.normal(0, 0.03, length)
    ang[:, 2] = np.where(omega > np.pi, omega - 2 * np.pi, omega)
    ang[:, 3] = 1.94 + rng.normal(0, 0.017, length)
    ang[:, 4] = 2.03 + rng.normal(0, 0.017, length)
    ang[:, 5] = 2.13 + rng.normal(0, 0.017, length)
    rot = rng.choice([-np.pi / 3, np.pi / 3, np.pi], size=(length, 6))
    ang[:, 6:] = rot + rng.normal(0, 0.12, (length, 6))
    return ang


def make_chain(rng, pid, p_hel, p_sheet, tmp, device):
    """angles -> build -> PDB on disk -> parse -> measure (full path)."""
    length = int(rng.integers(24, 64))
    seq = "".join(rng.choice(list(STD_AAS), size=length))
    ids = np.array([VOCAB[c] for c in seq], np.int32)
    ang = realistic_angles(rng, length, p_hel, p_sheet)
    with torch.no_grad():
        crd = build_coords(torch.from_numpy(ang).to(device),
                           torch.from_numpy(ids).to(device)).cpu().numpy()
    pdb_path = os.path.join(tmp, f"{pid}.pdb")
    PdbWriter(crd, seq).save_pdb(pdb_path, title=pid)
    seq2, crd2 = measure.pdb_to_record(pdb_path)
    if seq2 != seq:
        raise RuntimeError(f"{pid}: the PDB file reads back as another "
                           "sequence")
    measured = measure.coords_to_angles(crd2, ids)
    # NaN radians propagate to NaN sin/cos -- the reference's convention
    # for immeasurable angles survives the transform unchanged
    sincos = measure.angles_to_sincos(measured).astype(np.float32)
    return seq, sincos, crd2.reshape(-1, 3).astype(np.float32)


def generate(out_dir, device):
    """Write the shards and the two ID lists to ``out_dir``."""
    rng = np.random.default_rng(SEED)
    helix_ids, mixed_ids = [], []
    chains = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(8):
            pid = f"HLX{i:02d}_1_A"
            chains[pid] = make_chain(rng, pid, 0.85, 0.0, tmp, device)
            helix_ids.append(pid)
        for i in range(8):
            pid = f"MIX{i:02d}_1_A"
            chains[pid] = make_chain(rng, pid, 0.45, 0.35, tmp, device)
            mixed_ids.append(pid)

    all_ids = helix_ids + mixed_ids
    order = rng.permutation(len(all_ids))
    train = [all_ids[i] for i in order[:12]]
    valid = [all_ids[i] for i in order[12:14]]
    test = [all_ids[i] for i in order[14:]]

    def split_of(ids):
        return {"seq": [chains[i][0] for i in ids],
                "ang": [chains[i][1] for i in ids],
                "crd": [chains[i][2] for i in ids],
                "ids": list(ids)}

    splits = {"train": split_of(train), "valid-70": split_of(valid),
              "test": split_of(test)}
    data = create_data_dict(splits, max_len=64)
    convert(data, out_dir)
    lists = (helix_ids, helix_ids[:4] + mixed_ids[:6])
    for name, ids in zip(ID_LISTS, lists):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("\n".join(ids) + "\n")
    return sum(len(s["seq"]) for s in splits.values())


def diff_from(reference_dir, out_dir) -> dict:
    """How far ``out_dir`` is from ``reference_dir``: raises unless both
    hold the same splits, ids, sequences, ID lists and NaN pattern of the
    angles; returns the largest coordinate difference (A, between the
    three-decimal values of the PDB files both were read from) and the
    largest per-angle mean squared error (rad^2, over every residue where
    the angle was measured)."""
    ref, got = load_dataset(reference_dir), load_dataset(out_dir)
    splits = [k for k in ref if isinstance(ref[k], dict) and "seq" in ref[k]]
    if splits != [k for k in got
                  if isinstance(got[k], dict) and "seq" in got[k]]:
        raise ValueError("the splits differ")
    for name in ID_LISTS:
        with open(os.path.join(reference_dir, name)) as a, \
                open(os.path.join(out_dir, name)) as b:
            if a.read() != b.read():
                raise ValueError(f"{name} differs")
    crd_err, diffs = 0.0, []
    for split in splits:
        a, b = ref[split], got[split]
        if a["ids"] != b["ids"] or a["seq"] != b["seq"]:
            raise ValueError(f"{split}: the ids or sequences differ")
        for pid, ca, cb, aa, ab in zip(a["ids"], a["crd"], b["crd"],
                                       a["ang"], b["ang"]):
            if not (np.array_equal(np.isnan(ca), np.isnan(cb))
                    and np.array_equal(np.isnan(aa), np.isnan(ab))):
                raise ValueError(f"{pid}: the missing atoms or angles "
                                 "differ")
            # the PDB file's decimals, exactly: a float32 of a three-decimal
            # number read back in float64 and rounded to three decimals
            ca, cb = (np.round(c.astype(np.float64), 3) for c in (ca, cb))
            crd_err = max(crd_err, float(np.nanmax(np.abs(ca - cb))))
            ra, rb = (np.arctan2(x[:, 1::2], x[:, 0::2]) for x in (aa, ab))
            diffs.append(np.angle(np.exp(1j * (rb - ra))))
    diffs = np.concatenate(diffs)
    ang_mse = max(float(np.mean(d[np.isfinite(d)] ** 2))
                  for d in diffs.T if np.isfinite(d).any())
    return {"max_coord_err": crd_err, "max_angle_mse": ang_mse}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory to write (the committed fixture is "
                         "examples/dev_data)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda needs a GPU and raises without one")
    args = ap.parse_args(argv)
    device = cuda_device() if args.device == "cuda" else torch.device("cpu")
    n = generate(args.out, device)
    print(f"wrote {n} chains to {args.out}")


if __name__ == "__main__":
    main()
