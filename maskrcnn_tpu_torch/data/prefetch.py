"""Background-thread batch prefetcher.

The reference overlaps data loading with compute via MultithreadIterator
(reference train.py:124-126). Here a single daemon thread keeps a small
queue of ready batches ahead of the training loop — with one host core
feeding a TPU, overlapping the cv2/rasterization work with device steps is
the difference between compute-bound and input-bound training.
"""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    """Wraps any batch iterator with a depth-``size`` ready queue.

    Tracks starvation: ``starved`` counts the ``__next__`` calls that found
    the queue empty (the consumer outran the host pipeline — a training loop
    seeing this grow is input-bound, not device-bound), ``served`` the total
    batches delivered. The train CLI logs the ratio per report interval.
    """

    def __init__(self, iterator, size: int = 2):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=size)
        self._err: BaseException | None = None
        self.starved = 0
        self.served = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # surface loader errors on next()
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self._q.empty():
            self.starved += 1
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        self.served += 1
        return item
