"""Background-thread prefetch: overlaps host image decode with device work
(port of the JAX package's `data/dataset.py::Prefetcher`)."""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

from unetdc_tpu_torch.utils import profiling


class Prefetcher:
    """Iterate `it` on a daemon thread, `depth` items ahead. An exception in
    the producer is re-raised in the consumer. With `wait_span`, each wait
    for an item is a span of that name while tracing, its item's position
    in the `index` id (e.g. "step")."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2,
                 wait_span: Optional[str] = None, index: str = "step"):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._wait_span = wait_span
        self._index = index
        self._n = 0

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # propagate into the consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        t0 = (time.perf_counter_ns()
              if self._wait_span and profiling.tracing() else None)
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        if t0 is not None:
            profiling.record(self._wait_span, t0, time.perf_counter_ns(),
                             **{self._index: self._n})
        self._n += 1
        return item
