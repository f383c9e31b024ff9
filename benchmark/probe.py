"""What the harness reads of the program while it runs: wrappers on one
trainer instance, in the benchmark's own file.

``Probe`` replaces the instance's ``train_step`` and ``eval_step`` and its
data module's ``train_index_batches`` and ``eval_index_batches`` by
wrappers that call the originals and note, per step: the index array the
feed drew, the batch's (rows, length), its proteins' real lengths from
the benchmark's own proteins (``lens``: {split name: lengths}, so the
residue count is the yardstick's and not the program's), the host seconds
inside the call, and a CUDA event recorded on the stream when the call
returns (no synchronisation). A step whose index array the feed did not
draw through the wrapped methods raises: the program's feed has changed
under the benchmark. For the first ``capture`` training steps it also
keeps what the correctness comparison reads: each step's loss, the
optimizer's first moment after step 1 and the parameters after the last
captured step.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from protein_transformer_tpu_torch.training.trainer import METRIC_KEYS

LOSS = METRIC_KEYS.index("loss")


@dataclasses.dataclass
class Stretch:
    """The steps of one measured stretch."""
    kind: str
    steps: int = 0
    dispatch_s: float = 0.0
    n_res: int = 0
    shapes: list = dataclasses.field(default_factory=list)
    lens: list = dataclasses.field(default_factory=list)
    indices: list = dataclasses.field(default_factory=list)
    marks: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)
    seconds: float = 0.0

    def periods_ms(self) -> list:
        """Milliseconds between consecutive step returns: CUDA events on
        the card, host times after each (synchronous) call elsewhere."""
        if len(self.marks) < 2:
            return []
        if isinstance(self.marks[0], float):
            return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]
        self.marks[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]


class Probe:
    def __init__(self, trainer, lens: dict, capture: int = 0):
        self.trainer = trainer
        self.lens = lens
        self.cuda = trainer.device.type == "cuda"
        self._train_step = trainer.train_step
        self._eval_step = trainer.eval_step
        trainer.train_step = self.train_step
        trainer.eval_step = self.eval_step
        dm = trainer.dm
        for name in ("train_index_batches", "eval_index_batches"):
            setattr(dm, name, self._recording(getattr(dm, name)))
        self.pending: collections.deque = collections.deque()
        self.capture = capture
        self.calls = 0
        self.first: list = []       # (indices, (rows, length), loss tensor)
        self.mu1: list | None = None
        self.params_last: dict | None = None
        self.stretch: Stretch | None = None

    def _recording(self, method):
        def wrapped(*args, **kwargs):
            split = ("train" if method.__name__.startswith("train")
                     else args[0])
            for idx in method(*args, **kwargs):
                self.pending.append((np.asarray(idx), self.lens[split]))
                yield idx
        wrapped.__name__ = method.__name__
        return wrapped

    def start(self, kind: str) -> Stretch:
        self.stretch = Stretch(kind)
        return self.stretch

    def stop(self) -> Stretch:
        s, self.stretch = self.stretch, None
        return s

    def _note(self, kind, batch, seconds, idx, out=None) -> None:
        s = self.stretch
        if s is None or s.kind != kind:
            return
        if idx is None:
            raise RuntimeError(f"a {kind} step came with no index batch "
                               "drawn through the feed that the probe wraps")
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        s.marks.append(ev)
        s.steps += 1
        s.dispatch_s += seconds
        s.shapes.append(tuple(batch.seq.shape))
        s.indices.append(idx[0])
        s.lens.append(np.minimum(idx[1][idx[0]], batch.seq.shape[1]))
        s.n_res += int(s.lens[-1].sum())
        if out is not None:
            s.outputs.append(out)

    def train_step(self, state, batch, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._train_step(state, batch, *args, **kwargs)
        seconds = time.perf_counter() - t0
        idx = self.pending.popleft() if self.pending else None
        self.calls += 1
        if self.calls <= self.capture:
            new = out[0]
            self.first.append((None if idx is None else idx[0],
                               tuple(batch.seq.shape),
                               out[1][LOSS].detach().clone()))
            if self.calls == 1:
                self.mu1 = [m.detach().clone() for m in new.opt_state.mu]
            if self.calls == self.capture:
                self.params_last = {k: v.detach().clone()
                                    for k, v in new.params.items()}
        self._note("train", batch, seconds, idx)
        return out

    def eval_step(self, params, batch):
        t0 = time.perf_counter()
        out = self._eval_step(params, batch)
        seconds = time.perf_counter() - t0
        idx = self.pending.popleft() if self.pending else None
        self._note("eval", batch, seconds, idx, out)
        return out

    def raw_train_step(self, state, batch):
        """A training step that the probe does not count (warm-up)."""
        return self._train_step(state, batch)
