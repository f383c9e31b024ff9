"""Losses of the PyTorch port against the JAX package and the frozen goldens.

Tolerances are the repo's gates: angle MSE <= 1e-5, dRMSD and RMSD
<= 1e-3 A, and the goldens' own bounds from tests/test_losses.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_transformer_tpu import losses as JL
from protein_transformer_tpu.protein import geometry as jgeo
from protein_transformer_tpu.protein.constants import (
    NUM_PREDICTED_ANGLES, NUM_PREDICTED_COORDS)
from protein_transformer_tpu.protein.vocab import VOCAB
from protein_transformer_tpu_torch import losses as TL
from protein_transformer_tpu_torch.losses import DrmsdResults
from protein_transformer_tpu_torch.data.synthetic import random_angles
from protein_transformer_tpu_torch.protein import geometry as tgeo

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "losses.npz")


def t(x):
    return torch.tensor(np.asarray(x))


def reference_masks(true):
    """The reference's two-stage angle mask (as in tests/test_losses.py)."""
    row = (np.nan_to_num(true) != 0).any(axis=-1)
    return np.nan_to_num(true), row[..., None] & ~np.isnan(true)


def padded_batch(rng, lengths=(30, 22, 0), lmax=32):
    """Predictions, true coordinates and masks for a batch whose last row is
    a padded dummy (protein_mask False)."""
    bsz = len(lengths)
    seq = np.full((bsz, lmax), VOCAB.pad_id, np.int32)
    sincos = np.zeros((bsz, lmax, NUM_PREDICTED_ANGLES * 2), np.float32)
    for i, li in enumerate(lengths):
        seq[i, :li] = rng.integers(0, 20, li)
        sincos[i, :li] = rng.uniform(-1, 1, (li, 24))  # untrained-like output
    true_ang = np.stack([random_angles(rng, lmax) for _ in range(bsz)])
    true_crd = np.asarray(jgeo.build_coords_batch(jnp.asarray(true_ang),
                                                  jnp.asarray(seq)))
    atom_mask = ((seq != VOCAB.pad_id)[:, :, None]
                 & (rng.random((bsz, lmax, NUM_PREDICTED_COORDS)) > 0.1))
    protein_mask = np.array([li > 0 for li in lengths])
    return seq, sincos, true_crd, atom_mask, protein_mask


@pytest.mark.parametrize("bb,sc", [(False, False), (True, False),
                                   (False, True)])
def test_mse_over_angles_matches_jax_and_golden(bb, sc):
    g = np.load(GOLDEN)
    clean, mask = reference_masks(g["true"])
    got = float(TL.mse_over_angles(t(g["pred"]), t(clean), t(mask),
                                   bb_only=bb, sc_only=sc))
    want = float(JL.mse_over_angles(jnp.asarray(g["pred"]),
                                    jnp.asarray(clean), jnp.asarray(mask),
                                    bb_only=bb, sc_only=sc))
    key = "mse_bb" if bb else "mse_sc" if sc else "mse_full"
    assert abs(got - want) <= 1e-5
    assert abs(got - float(g[key])) < 1e-6


def test_drmsd_masked_matches_golden():
    g = np.load(GOLDEN)
    got = float(TL.drmsd_masked(t(g["a"]), t(g["b"]), t(g["mask"])))
    assert abs(got - float(g["drmsd"])) < 1e-4


@pytest.mark.parametrize("backbone_only", [False, True])
def test_compute_batch_drmsd_with_dummy_row(backbone_only):
    seq, sincos, crd, amask, pmask = padded_batch(np.random.default_rng(0))
    want = JL.compute_batch_drmsd(
        jnp.asarray(sincos), jnp.asarray(crd), jnp.asarray(seq),
        jnp.asarray(amask), jnp.asarray(pmask), backbone_only=backbone_only)
    got = TL.compute_batch_drmsd(t(sincos), t(crd), t(seq), t(amask),
                                 t(pmask), backbone_only=backbone_only)
    pred_crd = tgeo.build_coords_batch(
        tgeo.inverse_trig_transform(t(sincos)), t(seq))
    per = TL.per_protein_drmsd(pred_crd, t(crd), t(amask),
                               backbone_only=backbone_only)
    for name in DrmsdResults._fields:
        assert abs(float(getattr(got, name))
                   - float(getattr(want, name))) <= 1e-3
    assert torch.isfinite(torch.stack(list(per))).all()
    if backbone_only:
        assert float(got.drmsd) == float(got.drmsd_bb)


def test_combine_drmsd_mse():
    for d, mse, w in ((0.3, 0.02, 0.5), (1.7, 0.5, 0.2)):
        want = float(JL.combine_drmsd_mse(jnp.float32(d), jnp.float32(mse),
                                          w=w))
        got = float(TL.combine_drmsd_mse(torch.tensor(d), torch.tensor(mse),
                                         w=w))
        assert got == pytest.approx(want, rel=1e-6)


def test_batch_rmsd_matches_jax_with_dummy_row():
    seq, sincos, crd, amask, pmask = padded_batch(np.random.default_rng(1))
    rng = np.random.default_rng(2)
    pred = crd + rng.normal(0, 0.5, crd.shape).astype(np.float32)
    want = float(JL.batch_rmsd_jax(jnp.asarray(pred), jnp.asarray(crd),
                                   jnp.asarray(amask), jnp.asarray(pmask)))
    got = TL.batch_rmsd(t(pred), t(crd), t(amask), t(pmask))
    assert torch.isfinite(got)
    assert abs(float(got) - want) <= 1e-3


def test_kabsch_is_invariant_to_rigid_motion_and_reflection_safe():
    rng = np.random.default_rng(3)
    a = rng.normal(0, 5, (2, 40, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    b = a @ q.T.astype(np.float32) + rng.normal(0, 10, 3).astype(np.float32)
    w = np.ones((2, 40), bool)
    got = TL.kabsch_rmsd_masked(t(a), t(b), t(w))
    assert float(got.max()) < 1e-3
    mirrored = b * np.array([-1, 1, 1], np.float32)  # a reflection is no fit
    want = np.asarray(jax.vmap(JL.kabsch_rmsd_masked)(
        jnp.asarray(a), jnp.asarray(mirrored), jnp.asarray(w)))
    got_m = TL.kabsch_rmsd_masked(t(a), t(mirrored), t(w)).numpy()
    assert (got_m > 0.1).all()
    np.testing.assert_allclose(got_m, want, atol=1e-3)
