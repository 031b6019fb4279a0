"""Background-thread prefetch: overlaps host image decode with device work
(port of the JAX package's `data/dataset.py::Prefetcher`)."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


class Prefetcher:
    """Iterate `it` on a daemon thread, `depth` items ahead. An exception in
    the producer is re-raised in the consumer."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

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
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
