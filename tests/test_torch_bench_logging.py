"""``tools/bench_logging.py`` on the CPU, at a narrow width and one epoch
an arm after the warm-up: both arms report their figures (no device figure
off the card), only the logging arm writes structures, and the worker's
profile ranks its sites. The card runs it through ``chip_smoke.py`` phase
11 and by path against another checkout."""
import pytest
import torch

from protein_transformer_tpu_torch.tools import bench_logging


@pytest.fixture(autouse=True)
def one_thread():
    """The steps here are narrow: one intra-op thread runs them as fast as
    eight, and does not crawl when six test workers share the machine's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_both_arms_run_and_only_the_logging_arm_writes(monkeypatch):
    monkeypatch.setattr(bench_logging, "ORDER", ("off", "on"))
    results = bench_logging.run(torch.device("cpu"), d_model=16, layers=1,
                                length=16, repeat=1)
    assert results["card"] == "cpu"
    for arm in ("off", "on"):
        out = results[arm]
        assert len(out["ms_each"]) == 1 and out["ms"] > 0
        assert out["device_ops"] is None and out["device_ms"] is None
        assert out["loop_syncs"] == [] and out["worker_syncs"] == 0
        # the loop profile's phases of a training epoch
        assert {"dispatch", "structure log"} <= set(out["phases_ms"])
    assert results["off"]["files"] == 0
    # step 0 at least: a train structure and one of each validation split,
    # with the true structures' two files once a split
    assert results["on"]["files"] >= 8 * (3 + 2)


def test_writer_profile_ranks_the_workers_sites():
    out = bench_logging.writer_profile(lengths=(24,), calls=2)
    ms, sites = out[24]
    assert ms > 0 and len(sites) == 5
    assert all(own >= 0 and calls > 0 for _, own, calls in sites)
    assert sites == sorted(sites, key=lambda s: -s[1])
