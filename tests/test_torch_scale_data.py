"""The port's scale-data tools against the JAX package's root tools, and the
trainer's generator streams.

``protein_transformer_tpu_torch/tools/{gen_scale_data,oracle_floor,
stress_pipeline,gen_dev_data}.py`` are the port's copies of the root
``tools/`` of the same names, which compute through JAX. At one seed the
generators draw the same numbers: sequences, ids, angles and sin/cos equal
bit for bit; coordinates, built by the two packages' NeRF builders, within
1e-3 A on the real residues; the oracle floor's dRMSD per chain within
1e-3 A. The stress tool's batch plans equal the JAX DataModule's, and it
prints every stage's line. The dev fixture regenerated on the CPU matches
the committed ``examples/dev_data``: ids, sequences and ID lists equal,
coordinates within 1e-3 A (+1e-6) between the PDB files' three-decimal
values (a rounding flip at the third decimal is 1e-3 exactly), per-angle
MSE <= 1e-5 rad^2 with NaN where the fixture has NaN.

The trainer seeds four generator streams (dropout, sampling and the
probe's two) within the 32 bits a CPU generator keeps; their first draws
differ at rank 0 step 0 and at the largest rank and step, and the trainer
raises past them.

Shapes stay at L <= 64 with every chain padded to one shape, so that the
JAX builder compiles once a test. JAX is imported inside the fixtures, so
that the card-only tests collect where JAX is not installed:
``python -m pytest --noconftest -m needs_cuda tests/test_torch_scale_data.py``.

Cost: ~20 s in one worker (JAX compiles of the builder and the loss, one
subprocess of the generator).
"""
import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data import device_store as TDS
from protein_transformer_tpu_torch.data import synthetic as tsyn
from protein_transformer_tpu_torch.data.dataset import (
    DataModule, load_dataset)
from protein_transformer_tpu_torch.parallel.mesh import AxisGroup
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch
from protein_transformer_tpu_torch.tools import gen_dev_data as tdev
from protein_transformer_tpu_torch.tools import gen_scale_data as tgen
from protein_transformer_tpu_torch.tools import oracle_floor as toracle
from protein_transformer_tpu_torch.tools import stress_pipeline as tstress
from protein_transformer_tpu_torch.training import trainer as ttrainer
from protein_transformer_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV_DATA = os.path.join(ROOT, "examples", "dev_data")
CPU = torch.device("cpu")
SEED = 20260819
# four chains a split of 40-64 residues: every chunk pads to (4, 64)
SMALL = ["--n_train", "4", "--n_eval", "4", "--min_len", "40",
         "--max_len", "64"]
COORD_TOL = 1e-3
DEV_COORD_TOL = 1e-3 + 1e-6
ANGLE_MSE = 1e-5


@pytest.fixture(scope="module")
def jtools():
    """The JAX package's root tools, as modules."""
    pytest.importorskip("jax")
    sys.path.insert(0, ROOT)
    from tools import gen_scale_data, oracle_floor
    return gen_scale_data, oracle_floor


def run_main(main, argv, monkeypatch=None):
    """The lines ``main`` prints; a JAX tool's main reads sys.argv."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["tool", *argv])
            main()
    return out.getvalue().splitlines()


# ------------------------------------------------------------- generator

def test_chains_draw_the_jax_tools_bits(jtools):
    jgen, joracle = jtools
    rot = tgen._aa_rotamers(np.random.default_rng(SEED))
    np.testing.assert_array_equal(
        rot, jgen._aa_rotamers(np.random.default_rng(SEED)))
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for length in (1, 17, 64):
        got, want = tgen.gen_chain(a, length, rot), jgen.gen_chain(b, length,
                                                                   rot)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].dtype == want[2].dtype
    # the oracle's draws are the generator's, in the JAX oracle's order
    angs, ids = toracle.draw_pairs(2, 40, SEED)
    rng = np.random.default_rng(SEED)
    jrot = joracle._aa_rotamers(np.random.default_rng(SEED))
    for i in range(2):
        kinds, seq = joracle.sample_kinds_seq(rng, 40)
        want_ids = np.array([tgen.VOCAB[c] for c in seq], np.int32)
        np.testing.assert_array_equal(ids[i], want_ids)
        for j in range(2):
            np.testing.assert_array_equal(
                angs[i, j], joracle.sample_angles(rng, kinds, want_ids, jrot))


def test_build_split_matches_the_jax_tool(jtools):
    jgen, _ = jtools
    rot = tgen._aa_rotamers(np.random.default_rng(SEED))
    got = tgen.build_split(np.random.default_rng(1), 4, 40, 64, rot, "TRN")
    want = jgen.build_split(np.random.default_rng(1), 4, 40, 64, rot, "TRN")
    assert got["seq"] == want["seq"] and got["ids"] == want["ids"]
    for g, w in zip(got["ang"], want["ang"]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype == np.float32
    for g, w in zip(got["crd"], want["crd"]):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=COORD_TOL)


@pytest.fixture(scope="module")
def shards(jtools, tmp_path_factory):
    """The JAX tool's shards and the port's (on the CPU), from one seed."""
    jgen, _ = jtools
    where = tmp_path_factory.mktemp("scale")
    mp = pytest.MonkeyPatch()
    try:
        run_main(jgen.main, ["--out", str(where / "jax"), *SMALL], mp)
    finally:
        mp.undo()
    lines = run_main(tgen.main, ["--out", str(where / "port"), *SMALL,
                                 "--device", "cpu"])
    assert len(lines) == 1 and lines[0].startswith("wrote 12 chains (")
    assert lines[0].endswith(f"residues) to {where / 'port'}")
    return str(where / "jax"), str(where / "port")


def test_shards_load_equal_to_the_jax_tools(shards):
    want, got = (load_dataset(p) for p in shards)
    assert got["settings"]["max_len"] == want["settings"]["max_len"] == 64
    np.testing.assert_array_equal(got["settings"]["angle_means"],
                                  want["settings"]["angle_means"])
    assert got["settings"]["bin_data"] == want["settings"]["bin_data"]
    for split in ("train", "valid-70", "test"):
        g, w = got[split], want[split]
        assert g["ids"] == w["ids"] and g["seq"] == w["seq"]
        assert len(g["ids"]) == 4
        for a, b in zip(g["ang"], w["ang"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(g["crd"], w["crd"]):  # real residues only
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=COORD_TOL)


# ---------------------------------------------------------- oracle floor

def test_oracle_floor_matches_the_jax_tool(jtools):
    jgen, joracle = jtools
    import jax
    import jax.numpy as jnp

    from protein_transformer_tpu.losses import drmsd_masked
    # the JAX tool's loop, chain by chain, at --n 2 --len 40
    n, length = 2, 40
    rng = np.random.default_rng(SEED)
    rot = joracle._aa_rotamers(np.random.default_rng(SEED))
    build = jax.jit(jgen.build_coords_batch)
    want = []
    for _ in range(n):
        kinds, seq = joracle.sample_kinds_seq(rng, length)
        ids = np.array([tgen.VOCAB[c] for c in seq], np.int32)
        a1 = joracle.sample_angles(rng, kinds, ids, rot)
        a2 = joracle.sample_angles(rng, kinds, ids, rot)
        crd = np.asarray(build(jnp.asarray(np.stack([a1, a2])),
                               jnp.asarray(np.stack([ids, ids]))))
        crd = crd.reshape(2, -1, 3)
        valid = (np.linalg.norm(crd[0], axis=-1) > 1e-8) & \
                (np.linalg.norm(crd[1], axis=-1) > 1e-8)
        want.append(float(drmsd_masked(jnp.asarray(crd[0]),
                                       jnp.asarray(crd[1]),
                                       jnp.asarray(valid))))
    got = toracle.floor_values(n, length, SEED, CPU)
    assert got.shape == (n,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    line = run_main(toracle.main, ["--n", "2", "--len", "40",
                                   "--device", "cpu"])
    assert line == [toracle.summary_line(np.array(want), n, length)]
    assert line[0].startswith("conditional-resample dRMSD floor (n=2, L=40)")


# ---------------------------------------------------------------- stress

def test_stress_stages_and_plans_match_the_jax_data_module(tmp_path):
    from protein_transformer_tpu.config import TrainConfig as JConfig
    from protein_transformer_tpu.data import device_store as JDS
    from protein_transformer_tpu.data.dataset import DataModule as JDataModule
    from protein_transformer_tpu.data.dataset import (
        load_dataset as jload_dataset)
    out = str(tmp_path / "stress")
    lines = run_main(tstress.main, ["--n_train", "24", "--n_eval", "4",
                                    "--out", out, "--device", "cpu"])
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["stage"] for r in rows] == ["gen", "load", "split", "store",
                                          "plan", "collate"]
    assert all(r["seconds"] >= 0 for r in rows)
    by = {r["stage"]: r for r in rows}
    assert by["split"]["n_train"] == 24 and by["split"]["n_splits"] == 3
    assert by["store"]["store_nbytes"] == by["store"]["device_nbytes"] > 0
    assert by["plan"]["proteins"] == by["collate"]["proteins"] > 0

    kw = dict(name="stress", batch_size=8, train_only=False)
    dm = DataModule(load_dataset(out), TrainConfig(**kw).finalize())
    jdm = JDataModule(jload_dataset(out), JConfig(**kw).finalize())
    plans = {}
    for key, mod, ds, module in (("port", dm, dm.train, TDS),
                                 ("jax", jdm, jdm.train, JDS)):
        rng = np.random.default_rng(0)
        plans[key] = [module.plan_batch(ds, idx, mod.cfg.bucket_sizes,
                                        mod.max_seq_len, mod.batch_multiple)
                      for idx in mod.train_index_batches(rng)]
    assert len(plans["port"]) == len(plans["jax"]) == by["plan"]["batches"]
    for p, j in zip(plans["port"], plans["jax"]):
        np.testing.assert_array_equal(p.idx_padded, j.idx_padded)
        assert (p.lb, p.n_res, p.n_real) == (j.lb, j.n_res, j.n_real)
    assert sum(p.n_real for p in plans["jax"]) == by["plan"]["proteins"]


# ----------------------------------------------------------- dev fixture

def test_gen_dev_data_on_the_cpu_matches_the_committed_fixture(tmp_path):
    out = str(tmp_path / "dev")
    assert run_main(tdev.main, ["--out", out, "--device", "cpu"]) == [
        f"wrote 16 chains to {out}"]
    err = tdev.diff_from(DEV_DATA, out)
    assert err["max_coord_err"] <= DEV_COORD_TOL, err
    assert err["max_angle_mse"] <= ANGLE_MSE, err
    with pytest.raises(SystemExit):  # --out has no default
        with contextlib.redirect_stderr(io.StringIO()):
            tdev.main(["--device", "cpu"])


# ----------------------------------------------------------------- seeds

def first_draws(seed: int) -> torch.Tensor:
    return torch.rand(8, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("rank, step", [
    (0, 0), (ttrainer.MAX_DATA_RANKS - 1, ttrainer.MAX_STEPS - 1)])
def test_generator_streams_are_apart_on_the_cpu(rank, step):
    for seed in (0, 11_731, 2**32 - 1, 2**40 + 5):
        seeds = [ttrainer.stream_seed(seed, s, rank, step)
                 for s in ttrainer.SEED_STREAMS]
        assert all(0 <= s < 2**32 for s in seeds)
        draws = [first_draws(s) for s in seeds]
        for i in range(len(draws)):
            for j in range(i):
                assert not torch.equal(draws[i], draws[j]), (seed, i, j)
        # every other rank's and step's dropout stream too
        others = {ttrainer.stream_seed(seed, "dropout", r, t)
                  for r in (0, rank) for t in (0, step)}
        assert len(others | set(seeds)) == len(others) + 3
    # rank 0's dropout seeds are seed + step, as before the streams
    assert ttrainer.stream_seed(11_731, "dropout", 0, 7) == 11_738


def test_stream_seeds_raise_past_the_largest_rank_and_step():
    with pytest.raises(ValueError, match="64 ranks"):
        ttrainer.stream_seed(0, "dropout", ttrainer.MAX_DATA_RANKS, 0)
    with pytest.raises(ValueError, match=r"16777216 \(2\^24\) steps"):
        ttrainer.stream_seed(0, "sampling", 0, ttrainer.MAX_STEPS)


@pytest.fixture(scope="module")
def seeded_trainer(tmp_path_factory):
    data = tsyn.make_dataset(n_train=4, n_eval=1, min_len=20, max_len=30,
                             seed=0)
    cfg = TrainConfig(model="enc-only", d_model=16, d_ff=32, n_heads=2,
                      n_layers=1, batch_size=4, loss="mse", seed=5,
                      bucket_sizes=(32,), max_seq_len=32, optimizer="adam",
                      lr_scheduling="noam",
                      out_dir=str(tmp_path_factory.mktemp("seeds")))
    return Trainer(cfg, device=CPU, data=data)


def test_the_trainers_streams_draw_apart(seeded_trainer, monkeypatch):
    tr = seeded_trainer
    assert tr.dropout_generator.initial_seed() == 5
    # the sampling stream is no longer step 0's dropout stream
    assert not torch.equal(first_draws(tr.dropout_generator.initial_seed()),
                           first_draws(tr.sampling_generator.initial_seed()))
    # the probe reseeds on its own streams
    asked = []
    real = ttrainer.stream_seed

    def recording(*args):
        asked.append(args)
        return real(*args)

    monkeypatch.setattr(ttrainer, "stream_seed", recording)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state.step = 3
    tr._probe_gradients(state)
    assert asked == [(5, "probe_dropout", 0, 3), (5, "probe_sampling", 0, 3)]
    draws = [first_draws(real(5, s, 0, 3)) for s in ttrainer.SEED_STREAMS]
    assert len({tuple(d.tolist()) for d in draws}) == 4


def test_the_trainer_raises_past_the_largest_step_and_rank(seeded_trainer):
    tr = seeded_trainer
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = next(iter(tr.dm.train_batches(np.random.default_rng(0))))
    state.step = ttrainer.MAX_STEPS - 2
    state, _ = tr.train_step(state, batch)  # the last step the seeds keep
    assert state.step == ttrainer.MAX_STEPS - 1
    with pytest.raises(ValueError, match=r"\(2\^24\) steps"):
        tr.train_step(state, batch)
    assert state.step == ttrainer.MAX_STEPS - 1
    axis = tr.data_axis
    try:
        tr.data_axis = AxisGroup(2 * ttrainer.MAX_DATA_RANKS,
                                 ttrainer.MAX_DATA_RANKS)
        with pytest.raises(ValueError, match="64 ranks"):
            tr._seed("dropout", 0)
    finally:
        tr.data_axis = axis


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.needs_cuda
def test_card_build_matches_a_float64_plain_build(cuda):
    rot = tgen._aa_rotamers(np.random.default_rng(SEED))
    lengths, seqs, ids, angs = tgen.draw_split(np.random.default_rng(SEED),
                                               40, 50, 250, rot)
    got = tgen.build_chains(ids, angs, 250, cuda)
    for i, a, c in zip(ids, angs, got):
        with torch.no_grad():
            want = build_coords_batch(
                torch.from_numpy(a[None]).double(),
                torch.from_numpy(i[None]).long(), sidechain_impl="torch")[0]
        assert c.shape == (len(i), 14, 3)
        np.testing.assert_allclose(c, want.numpy(), rtol=0, atol=COORD_TOL)


@pytest.mark.needs_cuda
def test_oracle_floor_at_its_defaults_on_the_card(cuda):
    vals = toracle.floor_values(20, 150, SEED, cuda)
    for got, want in zip((np.mean(vals), np.median(vals), np.min(vals),
                          np.max(vals)), (27.59, 24.76, 11.66, 54.00)):
        assert abs(got - want) <= 0.01, (got, want)
