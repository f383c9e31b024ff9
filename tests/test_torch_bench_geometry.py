"""The coordinate-build bench (tools/bench_geometry.py) on the CPU: its
input maker, and its refusal to time anything without a card. Its timings
come from the card only:

    python -m protein_transformer_tpu_torch.tools.bench_geometry --steps
"""
import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.protein.vocab import VOCAB
from protein_transformer_tpu_torch.tools import bench_geometry


@pytest.mark.parametrize("shape", bench_geometry.SHAPES,
                         ids=lambda s: f"B{s[0]}-L{s[1]}")
def test_inputs_are_seeded_padded_batches(shape):
    ang, seq = bench_geometry.geometry_inputs(*shape, seed=3)
    assert ang.shape == (*shape, 12) and ang.dtype == np.float32
    assert seq.shape == shape and seq.dtype == np.int64
    again = bench_geometry.geometry_inputs(*shape, seed=3)
    np.testing.assert_array_equal(ang, again[0])
    np.testing.assert_array_equal(seq, again[1])
    assert not np.array_equal(seq, bench_geometry.geometry_inputs(
        *shape, seed=4)[1])
    pad = seq == VOCAB.pad_id
    assert not pad[0].any()                       # the first row is full
    assert pad[1:].any(axis=1).all()              # the others end padded
    assert (pad.sum(1) <= shape[1] // 4).all()
    for row in pad:                               # a tail, not holes
        assert not (row[1:] < row[:-1]).any()
    assert (ang[pad] == 0).all()
    real = ~pad
    assert set(seq[real].tolist()) == set(range(20))
    assert (np.abs(ang[real]) <= np.pi).all()
    np.testing.assert_allclose(ang[real][:, 3:6].mean(0), (1.94, 2.03, 2.13),
                               atol=0.01)


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_geometry.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_geometry.main(["--steps"])


def test_wrapper_calls_catches_what_the_build_hands_each_kernel(monkeypatch):
    """On the CPU, with the two wrappers replaced by plain launchers: the
    arguments the build hands each wrapper are caught, and the wrappers are
    put back."""
    S = bench_geometry.S

    # as the real wrappers, they count their launches on the function that
    # the module's name holds
    def fwd(bb, angles, seq):
        S.sidechain_fwd_cuda.launches += 1
        return S.build_sidechains_torch(bb, angles, seq)

    def bwd(built, angles, seq, g_out):
        S.sidechain_bwd_cuda.launches += 1
        return built[..., :4, :] * 0, angles * 0

    fwd.launches = bwd.launches = 0

    monkeypatch.setattr(S, "sidechain_fwd_cuda", fwd)
    monkeypatch.setattr(S, "sidechain_bwd_cuda", bwd)
    ang, seq = (torch.from_numpy(a) for a in
                bench_geometry.geometry_inputs(2, 9))
    leaf = ang.clone().requires_grad_()

    def forward_backward():
        crd = bench_geometry.G.build_coords_batch(leaf, seq, "cuda")
        torch.autograd.grad(crd.sum(), leaf)

    caught = bench_geometry.wrapper_calls(forward_backward)
    assert S.sidechain_fwd_cuda is fwd and S.sidechain_bwd_cuda is bwd
    forward_backward()
    assert (fwd.launches, bwd.launches) == (1, 1)
    assert caught["k2a"][0] is fwd and caught["k2b"][0] is bwd
    bb, angles, ids = caught["k2a"][1]
    assert bb.shape == (2, 9, 4, 3) and torch.equal(angles, leaf)
    assert torch.equal(ids, seq)
    built, _, _, g_out = caught["k2b"][1]
    assert built.shape == g_out.shape == (2, 9, 14, 3)
