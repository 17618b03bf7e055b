"""Per-instance bounded memoization for methods that build programs.

functools.lru_cache on a bound method keys a class-level cache by
``self``: every discarded instance (and the device weights and captured
graphs its closures hold) stays reachable for the life of the process.
``instance_cache`` stores the memo on the instance instead, so dropping the
object frees its programs, and bounds the memo so that a caller cycling
through distinct argument tuples (a server accepting custom sampling
parameters) cannot grow the number of programs without limit.

Keys are the normalized call signature (defaults applied), so
``f(16, 1.0, 0.5)`` and ``f(16, 1.0, 0.5, None)`` share one entry.
"""

from __future__ import annotations

import functools
import inspect
import threading
from collections import OrderedDict


class _Pending:
    """In-flight build marker: waiters block on ``event`` while exactly one
    caller runs the builder."""

    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None


def instance_cache(fn=None, *, maxsize: int = 32):
    """Decorator: memoize on ``self._memo_<name>`` (bounded LRU).

    Thread-safe: the server's dispatcher and its stream handlers share these
    builders.  Two first callers of one key build it once (the second waits
    on the first), while callers of different keys build side by side; only
    the memo bookkeeping runs under the instance lock."""

    def deco(f):
        sig = inspect.signature(f)
        attr = f"_memo_{f.__name__}"
        lock_attr = attr + "_lock"
        futures_attr = attr + "_futures"

        @functools.wraps(f)
        def wrapper(self, *args, **kwargs):
            bound = sig.bind(self, *args, **kwargs)
            bound.apply_defaults()
            key = (tuple(bound.arguments.items())[1:],)  # drop self
            # setdefault on the instance dict is atomic under the GIL
            lock = self.__dict__.setdefault(lock_attr, threading.Lock())
            with lock:
                memo = self.__dict__.setdefault(attr, OrderedDict())
                if key in memo:
                    memo.move_to_end(key)
                    return memo[key]
                futures = self.__dict__.setdefault(futures_attr, {})
                pending = futures.get(key)
                owner = pending is None
                if owner:
                    pending = futures[key] = _Pending()
            if not owner:
                pending.event.wait()
                if pending.error is not None:
                    # a fresh exception chained from the owner's: several
                    # waiter threads must not mutate one traceback at once
                    err = pending.error
                    try:
                        clone = type(err)(*err.args)
                    except Exception:  # noqa: BLE001 — exotic constructor
                        clone = RuntimeError(f"{f.__name__} build failed: {err!r}")
                    raise clone from err
                return pending.value
            try:
                value = f(self, *args, **kwargs)
            except BaseException as e:
                with lock:
                    futures.pop(key, None)
                pending.error = e
                pending.event.set()
                raise
            pending.value = value
            with lock:
                memo[key] = value
                if len(memo) > maxsize:
                    memo.popitem(last=False)
                futures.pop(key, None)
            pending.event.set()
            return value

        wrapper._memo_attr = attr
        return wrapper

    if fn is not None:
        return deco(fn)
    return deco
