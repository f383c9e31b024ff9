"""Background batch prefetching (host collate + device transfer overlap).

Port of protein_transformer_tpu/data/prefetch.py. A daemon thread runs the
sampler + collate + (optional) transfer pipeline ahead of the training
loop, keeping a small bounded buffer, so that host input work and device
steps overlap (the reference overlaps them with one DataLoader worker
process).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

_SENTINEL = object()


def prefetch(iterator: Iterator, size: int = 2,
             transform: Optional[Callable] = None) -> Iterator:
    """Wrap an iterator with a background-thread buffer of `size` items.

    transform (e.g. a pinned, non-blocking copy to the device) runs on the
    background thread so transfers start before the consumer asks for the
    batch. Exceptions re-raise in the consumer.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    error: list = []

    def worker():
        try:
            for item in iterator:
                q.put(transform(item) if transform else item)
        except BaseException as e:  # re-raised in the consumer
            error.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if error:
                raise error[0]
            return
        yield item
