"""The superposition RMSD's CUDA kernel (K5, ``ops/kabsch.py``) and the
``impl`` choice of ``losses.kabsch_rmsd_masked`` / ``batch_rmsd``.

On the CPU: the choice of path, the wrapper's refusals (no fallback, no
cast, no gradient), and the tensor path against a float64 numpy Kabsch on
the cases the kernel is held to on the card. The tensor path against the
JAX package is ``tests/test_torch_losses.py``.

On a card only (``needs_cuda``): the kernel against the float64 numpy
Kabsch and the tensor path, to 1e-5 relative or 1e-5 A, on random batches
at N = 3 L and 14 L with dummy rows, an all-zero mask, one and two points,
collinear and coplanar sets, a mirrored set, a rigid motion and NaN input;
its launch count; and a flagship eval step at B = 32 x L = 500 without a
stream synchronisation:

    python -m pytest --noconftest -m needs_cuda tests/test_torch_kabsch.py
"""
import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch import losses as TL
from protein_transformer_tpu_torch.ops import kabsch as K

CPU = torch.device("cpu")


def kabsch_fp64(a, b, w) -> np.ndarray:
    """(B,) RMSD after the weighted Kabsch fit, per protein, in float64
    numpy with numpy's SVD and the determinant correction: the yardstick of
    the kernel and of the tensor path."""
    out = []
    for ap, bp, wp in zip(a.astype(np.float64), b.astype(np.float64),
                          w.astype(np.float64)):
        wp = wp[:, None]
        total = max(wp.sum(), 1.0)
        am, bm = (ap * wp).sum(0) / total, (bp * wp).sum(0) / total
        u, _, vt = np.linalg.svd(((ap - am) * wp).T @ ((bp - bm) * wp))
        u[:, 2] *= np.sign(np.linalg.det(u @ vt))
        diff = ((ap - am) @ (u @ vt) - (bp - bm)) * wp
        out.append(np.sqrt((diff ** 2).sum() / total))
    return np.array(out)


def rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def shaped(rng, kind, n):
    """(a, b) float32 (n, 3) of one kind of point set and a (n,) mask."""
    w = np.ones(n, bool)
    if kind == "collinear":
        a = np.outer(rng.normal(0, 5, n), rng.normal(size=3)) \
            + rng.normal(0, 20, 3)
    elif kind == "coplanar":
        a = rng.normal(0, 5, (n, 2)) @ rng.normal(size=(2, 3)) \
            + rng.normal(0, 20, 3)
    else:
        a = rng.normal(0, 10, (n, 3))
        w = rng.random(n) < 0.8
    b = a @ rotation(rng).T + rng.normal(0, 10, 3)
    if kind == "mirrored":
        b = b * np.array([-1, 1, 1])
    else:
        b = b + rng.normal(0, 0.5, b.shape)
    return a.astype(np.float32), b.astype(np.float32), w


EDGE_CASES = {"one point": ("random", 1), "two points": ("random", 2),
              "collinear": ("collinear", 40), "coplanar": ("coplanar", 40),
              "mirrored": ("mirrored", 40), "random": ("random", 300)}


def edge_batch(seed):
    """Every edge case, one a row, padded with masked points to one N, and
    a row whose mask is all zero."""
    rng = np.random.default_rng(seed)
    rows = [shaped(rng, kind, n) for kind, n in EDGE_CASES.values()]
    n_max = max(len(w) for _, _, w in rows)
    a = rng.normal(0, 10, (len(rows) + 1, n_max, 3)).astype(np.float32)
    b = rng.normal(0, 10, a.shape).astype(np.float32)
    w = np.zeros(a.shape[:2], bool)
    for i, (ra, rb, rw) in enumerate(rows):
        a[i, :len(rw)], b[i, :len(rw)], w[i, :len(rw)] = ra, rb, rw
    return a, b, w


def close(got, want, rel=1e-5, atol=1e-5):
    got = np.asarray(got, np.float64)
    assert np.all(np.abs(got - want)
                  <= np.maximum(rel * np.abs(want), atol)), \
        (got, want)


# ---------------------------------------------------------------------- CPU


def test_resolve_impl_picks_by_device():
    assert K.resolve_impl("auto", CPU) == "torch"
    assert K.resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert K.resolve_impl("cuda", CPU) == "cuda"
    assert K.resolve_impl("torch", torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="unknown Kabsch impl"):
        K.resolve_impl("svd", CPU)


def test_cuda_impl_on_cpu_tensors_raises_without_fallback():
    a, b, w = (torch.from_numpy(x) for x in edge_batch(0))
    before = K.kabsch_rmsd_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        TL.kabsch_rmsd_masked(a, b, w, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        TL.batch_rmsd(a.reshape(len(a), -1, 2, 3), b.reshape(len(b), -1, 2, 3),
                      w.reshape(len(w), -1, 2), impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        K.kabsch_rmsd_cuda(a, b, w)
    assert K.kabsch_rmsd_cuda.launches == before


def test_cuda_path_refuses_inputs_that_need_a_gradient():
    a, b, w = (torch.from_numpy(x) for x in edge_batch(0))
    with pytest.raises(RuntimeError, match="forward only"):
        K.kabsch_rmsd_cuda(a.requires_grad_(), b, w)
    with pytest.raises(RuntimeError, match="forward only"):
        TL.kabsch_rmsd_masked(a, b, w, impl="cuda")


@pytest.mark.parametrize("fault", ["float64 a", "int w", "float w", "shape",
                                   "w shape", "strided"])
def test_wrong_dtype_or_shape_raises(fault):
    a, b, w = (torch.from_numpy(x) for x in edge_batch(0))
    err, args = {
        "float64 a": (TypeError, (a.double(), b, w)),
        "int w": (TypeError, (a, b, w.int())),
        "float w": (TypeError, (a, b, w.float())),
        "shape": (ValueError, (a, b[:, 1:], w)),
        "w shape": (ValueError, (a, b, w[:, :, None])),
        "strided": (ValueError, (a[:, ::2], b[:, ::2], w[:, ::2])),
    }[fault]
    with pytest.raises(err):
        K.kabsch_rmsd_cuda(*args)


@pytest.mark.parametrize("w_dtype", [torch.bool, torch.float32])
def test_torch_path_matches_float64_kabsch_on_the_edge_cases(w_dtype):
    """The cases the kernel is held to on the card, through the tensor
    path: the float64 numpy Kabsch is the yardstick of both."""
    a, b, w = edge_batch(1)
    got = TL.kabsch_rmsd_masked(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(w).to(w_dtype), impl="torch")
    want = kabsch_fp64(a, b, w)
    close(got.numpy(), want, rel=1e-4, atol=1e-4)
    assert want[-1] == 0 and float(got[-1]) == 0
    assert want[list(EDGE_CASES).index("mirrored")] > 0.1


def test_eval_step_hands_its_drmsd_impl_to_the_superposition(monkeypatch):
    """The trainer's resolved --drmsd_impl picks the RMSD's path too, so a
    plain ("torch") trainer on a card runs no K5."""
    from protein_transformer_tpu_torch.config import TrainConfig
    from protein_transformer_tpu_torch.data.dataset import collate
    from protein_transformer_tpu_torch.data.synthetic import make_dataset
    from protein_transformer_tpu_torch.training.trainer import Trainer

    seen = []
    kabsch = TL.kabsch_rmsd_masked

    def recording(a, b, w, impl="auto"):
        seen.append(impl)
        return kabsch(a, b, w, impl)

    monkeypatch.setattr(TL, "kabsch_rmsd_masked", recording)
    data = make_dataset(n_train=2, n_eval=2, min_len=8, max_len=12, seed=0)
    cfg = TrainConfig(model="conv-enc|3|1", d_model=16, d_ff=32, n_heads=2,
                      n_layers=1, batch_size=2, loss="combined")
    tr = Trainer(cfg, device=CPU, data=data)
    split = next(iter(tr.dm.eval_splits))
    idx = next(tr.dm.eval_index_batches(split))
    batch = collate(tr.dm.eval_splits[split], idx, tr.cfg.bucket_sizes,
                    tr.dm.max_seq_len)
    params = tr.init_state(torch.Generator().manual_seed(0)).params
    tr.eval_step(params, batch)
    assert tr.drmsd_impl == "torch" and seen == ["torch"]


# ------------------------------------------------------------ card only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in arrays]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("atoms", [3, 14], ids=["backbone", "full-atom"])
@pytest.mark.parametrize("shape", [(4, 37), (32, 500)],
                         ids=lambda s: f"B{s[0]}-L{s[1]}")
def test_kernel_matches_float64_kabsch_on_card(cuda, shape, atoms):
    """Random predictions about true structures, 2% of the atoms missing,
    the last row a dummy (mask all zero): the kernel against the float64
    Kabsch and the tensor path."""
    bsz, length = shape
    rng = np.random.default_rng(bsz + length + atoms)
    n = atoms * length
    true = np.cumsum(rng.normal(0, 1.5, (bsz, n, 3)), axis=1)
    pred = true @ rotation(rng).T + rng.normal(0, 2.0, (bsz, n, 3)) + 30.0
    true, pred = true.astype(np.float32), pred.astype(np.float32)
    w = rng.random((bsz, n)) > 0.02
    w[-1] = False
    a, b, wt = on(cuda, pred, true, w)
    got = TL.kabsch_rmsd_masked(a, b, wt, impl="cuda")
    assert got.dtype == torch.float32 and got.shape == (bsz,)
    want = kabsch_fp64(pred, true, w)
    close(got.cpu().numpy(), want)
    assert float(got[-1]) == 0
    plain = TL.kabsch_rmsd_masked(a, b, wt, impl="torch")
    close(got.cpu().numpy(), plain.cpu().numpy().astype(np.float64))
    assert torch.equal(got, TL.kabsch_rmsd_masked(a, b, wt, impl="cuda"))


@pytest.mark.needs_cuda
def test_kernel_at_the_scoring_batch_within_1e6_of_float64_on_card(cuda):
    """B = 32 x N = 7,000, the scoring cell's full-atom batch."""
    rng = np.random.default_rng(7)
    true = np.cumsum(rng.normal(0, 1.5, (32, 7000, 3)), axis=1)
    pred = true @ rotation(rng).T + rng.normal(0, 3.0, true.shape)
    true, pred = true.astype(np.float32), pred.astype(np.float32)
    w = rng.random((32, 7000)) > 0.02
    got = K.kabsch_rmsd_cuda(*on(cuda, pred, true, w)).cpu().numpy()
    close(got, kabsch_fp64(pred, true, w), rel=1e-6, atol=0)


@pytest.mark.needs_cuda
def test_kernel_edge_cases_on_card(cuda):
    """One and two points, collinear and coplanar sets (H of rank 0 to 2), a
    mirror image (never fitted), an all-zero mask (0)."""
    a, b, w = edge_batch(1)
    got = K.kabsch_rmsd_cuda(*on(cuda, a, b, w)).cpu().numpy()
    want = kabsch_fp64(a, b, w)
    close(got, want)
    assert got[-1] == 0
    assert got[list(EDGE_CASES).index("one point")] == 0
    mirrored = list(EDGE_CASES).index("mirrored")
    assert got[mirrored] > 0.1


@pytest.mark.needs_cuda
@pytest.mark.parametrize("kind", ["random", "collinear", "coplanar"])
def test_kernel_reads_a_rigid_motion_as_zero_on_card(cuda, kind):
    rng = np.random.default_rng(5)
    a, _, _ = shaped(rng, kind, 500)
    b = (a.astype(np.float64) @ rotation(rng).T
         + rng.normal(0, 10, 3)).astype(np.float32)
    w = np.ones((1, 500), bool)
    got = K.kabsch_rmsd_cuda(*on(cuda, a[None], b[None], w))
    assert float(got[0]) < 1e-4


@pytest.mark.needs_cuda
def test_kernel_returns_nan_for_nan_input_on_card(cuda):
    a, b, w = edge_batch(2)
    a[0, 0, 1] = np.nan          # a weighted point
    b[2, -1, 0] = np.nan         # a masked one: it still reaches the centroid
    got = K.kabsch_rmsd_cuda(*on(cuda, a, b, w))
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    assert np.isnan(got[0]) and np.isnan(got[2])
    assert np.isfinite(np.delete(got, [0, 2])).all()


@pytest.mark.needs_cuda
def test_batch_rmsd_launches_once_a_call_on_card(cuda):
    a, b, w = on(cuda, *edge_batch(3))
    before = K.kabsch_rmsd_cuda.launches
    for _ in range(3):
        TL.batch_rmsd(a, b, w, torch.ones(len(a), dtype=torch.bool,
                                          device=cuda))
    assert K.kabsch_rmsd_cuda.launches == before + 3


@pytest.mark.needs_cuda
def test_flagship_eval_step_never_synchronises_on_card(cuda, tmp_path):
    """One eval step of the flagship at B = 32 x L = 500 on the store path,
    the batch's gather included, under set_sync_debug_mode("error"): the
    superposition waits for nothing."""
    from protein_transformer_tpu_torch.config import TrainConfig
    from protein_transformer_tpu_torch.data.synthetic import make_dataset
    from protein_transformer_tpu_torch.training.trainer import Trainer

    data = make_dataset(n_train=4, n_eval=64, min_len=495, max_len=500,
                        seed=4, device=cuda)
    cfg = TrainConfig(model="conv-enc|21,11,3|1,1,1", d_model=512, d_ff=2048,
                      n_heads=8, n_layers=6, batch_size=32, loss="combined",
                      device_data="true", log_structure_step=0,
                      log_val_struct_step=0, cluster=True, name="kabsch",
                      out_dir=str(tmp_path))
    tr = Trainer(cfg, device=cuda, data=data)
    params = tr.init_state(torch.Generator().manual_seed(0)).params
    stream = tr._eval_batch_stream("valid-70")
    _, first = next(stream)
    tr.eval_step(params, first)  # builds every kernel and table once
    torch.cuda.synchronize()
    before = K.kabsch_rmsd_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, batch = next(stream)
        out = tr.eval_step(params, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tuple(batch.seq.shape) == (32, 500)
    assert K.kabsch_rmsd_cuda.launches == before + 1
    assert torch.isfinite(out).all()
