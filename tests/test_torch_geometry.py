"""NeRF and structure building of the PyTorch port against the JAX package.

Same inputs (numpy, from a seed) through both; coordinates must agree to
<= 1e-3 A, the repo's coordinate gate. The two prefix scans compose in
different tree orders, so they differ in the last fp32 bits, far below it.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_transformer_tpu.ops import nerf as jnerf
from protein_transformer_tpu.protein import geometry as jgeo
from protein_transformer_tpu.protein.constants import NUM_PREDICTED_ANGLES
from protein_transformer_tpu.protein.vocab import VOCAB
from protein_transformer_tpu_torch.data.synthetic import random_angles
from protein_transformer_tpu_torch.ops import nerf as tnerf
from protein_transformer_tpu_torch.protein import geometry as tgeo

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
ALL_AAS = "ACDEFGHIKLMNPQRSTVWY"
GATE = 1e-3  # A


def t(x):
    return torch.from_numpy(np.asarray(x))


def garbage_angles(rng, shape):
    """Full-range angles, as an untrained model emits: every bond angle in
    [-pi, pi], so sin(theta) < 0 for about half of them."""
    return rng.uniform(-np.pi, np.pi, shape).astype(np.float32)


def random_ids(rng, bsz, length):
    return rng.integers(0, len(ALL_AAS), (bsz, length)).astype(np.int32)


def test_nerf_matches_jax():
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(0, 3, (64, 3)).astype(np.float32) for _ in range(3))
    length = rng.uniform(1.0, 2.0, 64).astype(np.float32)
    theta, chi = garbage_angles(rng, (2, 64))
    want = np.asarray(jnerf.nerf(a, b, c, length, theta, chi))
    got = tnerf.nerf(t(a), t(b), t(c), t(length), t(theta), t(chi)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_extension_transform_matches_jax_including_negative_theta():
    rng = np.random.default_rng(1)
    length = rng.uniform(1.0, 2.0, 200).astype(np.float32)
    theta, chi = garbage_angles(rng, (2, 200))
    assert (theta < 0).sum() > 50
    jr, jt = jnerf.extension_transform(length, theta, chi)
    tr, tt = tnerf.extension_transform(t(length), t(theta), t(chi))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 7, 128])
def test_chain_positions_grouped_matches_jax(k):
    rng = np.random.default_rng(k)
    a, b, c = (rng.normal(0, 2, 3).astype(np.float32) for _ in range(3))
    lengths = rng.uniform(1.2, 1.6, (k, 3)).astype(np.float32)
    thetas, chis = garbage_angles(rng, (2, k, 3))
    r0 = jnerf.frame_from_points(a, b, c)
    want = np.asarray(jnerf.chain_positions_grouped(r0, c, lengths, thetas,
                                                    chis))
    tr0 = tnerf.frame_from_points(t(a), t(b), t(c))
    np.testing.assert_allclose(tr0.numpy(), np.asarray(r0), atol=1e-6)
    got = tnerf.chain_positions_grouped(tr0, t(c), t(lengths), t(thetas),
                                        t(chis)).numpy()
    assert np.abs(got - want).max() <= GATE


def test_build_backbone_matches_jax_on_garbage_angles():
    """The backbone scan at L=256 on full-range angles (theta < 0
    included), the association-order stress case."""
    rng = np.random.default_rng(2)
    ang = garbage_angles(rng, (2, 256, NUM_PREDICTED_ANGLES))
    got = tgeo.build_backbone(t(ang)).numpy()
    for i in range(2):
        want = np.asarray(jgeo.build_backbone(jnp.asarray(ang[i])))
        assert np.abs(got[i] - want).max() <= GATE


def test_build_coords_batch_matches_jax():
    """Batched (B, L) all-atom build vs the JAX vmap build at L=120.

    Physical angles: on full-range angles some sidechain frames are built
    from nearly collinear atoms, which amplifies fp32 rounding in both
    packages to ~1e-3 A against a float64 build; the backbone test above
    covers full-range angles."""
    rng = np.random.default_rng(2)
    ang = np.stack([random_angles(rng, 120) for _ in range(3)])
    ids = random_ids(rng, 3, 120)
    want = np.asarray(jgeo.build_coords_batch(jnp.asarray(ang),
                                              jnp.asarray(ids)))
    got = tgeo.build_coords_batch(t(ang), t(ids)).numpy()
    assert got.shape == (3, 120, 14, 3)
    assert np.abs(got - want).max() <= GATE


@pytest.mark.parametrize("golden", ["coords.npz", "realistic_coords.npz"])
def test_build_coords_matches_golden(golden):
    z = np.load(os.path.join(GOLDEN_DIR, golden))
    got = tgeo.build_coords_batch(t(z["ang"])[None], t(z["ids"])[None])[0]
    assert np.abs(got.numpy() - z["crd"]).max() <= GATE
    single = tgeo.build_coords(t(z["ang"]), t(z["ids"]))
    assert torch.equal(single, got)


def test_single_residue_and_all_padding_row():
    rng = np.random.default_rng(3)
    ang1 = garbage_angles(rng, (1, 1, NUM_PREDICTED_ANGLES))
    ids1 = random_ids(rng, 1, 1)
    want = np.asarray(jgeo.build_coords(jnp.asarray(ang1[0]),
                                        jnp.asarray(ids1[0])))
    got = tgeo.build_coords_batch(t(ang1), t(ids1))[0].numpy()
    assert np.abs(got - want).max() <= GATE

    ang = garbage_angles(rng, (2, 16, NUM_PREDICTED_ANGLES))
    ids = random_ids(rng, 2, 16)
    ang[1] = 0.0
    ids[1] = VOCAB.pad_id
    crd = tgeo.build_coords_batch(t(ang), t(ids)).numpy()
    assert np.isfinite(crd).all()
    assert (crd[1, :, 4:] == 0).all()  # pad residues have no sidechain


def test_trig_transforms_match_jax():
    rng = np.random.default_rng(4)
    ang = garbage_angles(rng, (2, 10, NUM_PREDICTED_ANGLES))
    sincos = tgeo.trig_transform(t(ang))
    np.testing.assert_allclose(sincos.numpy(),
                               np.asarray(jgeo.trig_transform(ang)), atol=1e-6)
    back = tgeo.inverse_trig_transform(sincos).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jgeo.inverse_trig_transform(jnp.asarray(sincos))),
        atol=1e-6)
    np.testing.assert_allclose(back, ang, atol=1e-5)
