"""Background-thread batch prefetching.

A single producer thread keeps a small queue of collated batches ahead of
the train step, so wav decoding and the fbank launch overlap the step.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class PrefetchIterator:
    """Wrap an iterator, materializing up to `depth` items ahead.

    Safe against early exits: the producer's queue puts time out and check a
    stop flag, so breaking out of a consuming loop (or dropping the
    iterator) releases the thread and its buffered batches instead of
    leaving it blocked in ``queue.put`` forever.  ``close()`` stops it
    explicitly; iterating again after exhaustion raises StopIteration.
    """

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        self._done = False

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as ex:  # noqa: BLE001 — re-raised in consumer
                self._err = ex
            finally:
                put(self._SENTINEL)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def close(self):
        """Stop the producer and drop buffered items."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __del__(self):  # release the thread if the consumer never finished
        self._stop.set()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            if self._stop.is_set():
                # close() suppresses the producer's sentinel enqueue, so a
                # blocking get() here would hang forever (confirmed repro:
                # next(); close(); next())
                self._done = True
                raise StopIteration
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                continue
        if item is self._SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class PrefetchBatches:
    """Background-collated batches with resume-safe sampler state.

    The producer thread advances the sampler ahead of consumption, so the
    sampler's own ``state_dict()`` would over-count consumed batches by up to
    ``depth``.  This wrapper snapshots the sampler state alongside each
    produced batch and reports the state as of the *last consumed* batch —
    checkpoints made mid-epoch resume exactly where training stopped.
    """

    def __init__(self, sampler, collate: Callable, depth: int = 2, limit: int = 0):
        """limit > 0 collates at most that many batches (no batch is
        collated that the consumer will not take)."""
        self._state = sampler.state_dict()

        def gen():
            for i, utts in enumerate(sampler):
                if limit and i >= limit:
                    return
                yield collate(utts), sampler.state_dict()

        self._it = PrefetchIterator(gen(), depth=depth)

    def __iter__(self):
        return self

    def __next__(self):
        batch, state = next(self._it)
        self._state = state
        return batch

    def close(self):
        """Release the producer thread (call after breaking out early)."""
        self._it.close()

    def state_dict(self):
        """Sampler state as of the last batch returned by ``__next__``."""
        return self._state
