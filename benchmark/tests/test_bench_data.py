"""The data maker and the weights: the same bits at one seed, others at
another, and the same set of lengths for every seed."""
from __future__ import annotations

import json

import numpy as np
import torch

from benchmark import proteins, spec, weights
from conftest import REPO

CPU = torch.device("cpu")
SPLIT = {"n": 40, "lengths": {"dist": "uniform", "min": 20, "max": 120}}


def _make(seed):
    return proteins.make(SPLIT, np.random.default_rng(seed), 0.02, CPU)


def _same(a, b) -> bool:
    return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(
        (a.lens, a.ids, a.sincos, a.crd), (b.lens, b.ids, b.sincos, b.crd)))


def test_proteins_repeat_bit_for_bit():
    assert _same(_make(2**31 + 5), _make(2**31 + 5))
    other = _make(2**31 + 6)
    assert not np.array_equal(_make(2**31 + 5).ids, other.ids)
    # every seed has the same lengths, in another order
    assert sorted(_make(1).lens) == sorted(other.lens)


def test_proteins_are_sound():
    p = _make(3)
    real = np.arange(p.ids.shape[1])[None] < p.lens[:, None]
    assert (p.ids[real] < 20).all() and (p.ids[~real] == proteins.PAD_ID).all()
    assert np.isfinite(p.sincos[real]).all()
    have = np.isfinite(p.crd).all(-1)
    assert have[real][:, :4].mean() > 0.95 and not have[~real].any()


def test_length_sets():
    cap = json.loads((REPO / "benchmark/traffic/l500_train.json")
                     .read_text())["splits"]["train"]
    lens = proteins.fixed_lengths(cap["lengths"], cap["n"])
    assert lens.min() == 490 and lens.max() == 500
    assert list(proteins.fixed_lengths(
        {"dist": "uniform", "min": 490, "max": 500}, 22)) == \
        sorted(list(range(490, 501)) * 2)


def test_weights_repeat_bit_for_bit():
    conf = spec.flat_config(json.loads(
        (REPO / "benchmark/configs/conv_enc_512.json").read_text()))
    conf.update(d_model=32, d_ff=64, n_layers=1)
    means = np.zeros(24, np.float32)
    a = weights.make(conf, 2**40 + 1, means, CPU)
    b = weights.make(conf, 2**40 + 1, means, CPU)
    c = weights.make(conf, 2**40 + 2, means, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convs.0.weight"], c["convs.0.weight"])
    w = a["layers.0.ff.w_1.weight"]
    assert float(w.abs().max()) <= weights.xavier_bound(tuple(w.shape))
    assert float(a["layers.0.attn.wq.bias"].abs().max()) == 0.0
