"""Exponential backoff, shared by every retry ladder in the tree.

PodBackoff is the per-pod map (reference: pkg/scheduler/util/
backoff_utils.go:97-112 — 1s initial, doubling, 60s max, entries GC'd
after 2*maxDuration of idleness). JitteredLadder is the single-stream
variant used by the reflector's relist loop, the bind reconciler's
retry loop, and the store-path breaker's probe cooldown: each bump
yields `delay * (0.5 + jitter())` (full-jitter over [0.5x, 1.5x), so
concurrent ladders never synchronize) and doubles the base toward the
cap. Before this module owned it, the same three lines lived
copy-pasted in client/reflector.py and sched/reconciler.py and a
third unjittered copy in the autoscaler's duration doubling — one
shape, one place.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Tuple


def jittered(delay: float,
             jitter: Callable[[], float] = random.random) -> float:
    """Full-jitter: a uniform draw over [0.5x, 1.5x) of `delay`."""
    return delay * (0.5 + jitter())


def exp_step(delay: float, maximum: float) -> float:
    """One rung up the doubling ladder, capped at `maximum`."""
    return min(delay * 2.0, maximum)


class JitteredLadder:
    """A single jittered-exponential retry ladder.

    bump() returns the jittered wait for THIS failure and doubles the
    base (capped) for the next one; reset() drops back to the initial
    rung after a clean cycle. `delay` is the un-jittered base — tests
    assert ladder position against it without fighting the jitter.
    """

    __slots__ = ("initial", "maximum", "jitter", "delay")

    def __init__(self, initial: float, maximum: float,
                 jitter: Callable[[], float] = random.random):
        self.initial = initial
        self.maximum = maximum
        self.jitter = jitter
        self.delay = initial

    def bump(self) -> float:
        d = jittered(self.delay, self.jitter)
        self.delay = exp_step(self.delay, self.maximum)
        return d

    def reset(self) -> None:
        self.delay = self.initial


class _Entry:
    __slots__ = ("duration", "last_update")

    def __init__(self, duration: float, now: float):
        self.duration = duration
        self.last_update = now


class PodBackoff:
    def __init__(self, initial: float = 1.0, maximum: float = 60.0,
                 clock=time.monotonic):
        self.initial = initial
        self.maximum = maximum
        self.clock = clock
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()

    def get(self, pod_id: str) -> float:
        """Peek the current duration WITHOUT inflating it. Observing a
        pod's backoff (metrics, debug endpoints, a would-this-wait
        check) must not double it — the old single `get_backoff` entry
        point bumped on every read, so two observers could push a pod
        from 1s to 4s without a single failure."""
        with self._lock:
            e = self._entries.get(pod_id)
            return e.duration if e is not None else self.initial

    def bump(self, pod_id: str) -> float:
        """Record a failure: return the current duration and double it
        for next time (reference getBackoffTime + BackoffPod)."""
        now = self.clock()
        with self._lock:
            e = self._entries.get(pod_id)
            if e is None:
                e = _Entry(self.initial, now)
                self._entries[pod_id] = e
            d = e.duration
            e.duration = exp_step(e.duration, self.maximum)
            e.last_update = now
            return d

    def try_wait(self, pod_id: str) -> float:
        return self.bump(pod_id)

    def clear(self, pod_id: str):
        with self._lock:
            self._entries.pop(pod_id, None)

    def gc(self):
        """Drop entries idle for > 2*maximum (reference Gc())."""
        now = self.clock()
        with self._lock:
            for k in list(self._entries):
                if now - self._entries[k].last_update > 2 * self.maximum:
                    del self._entries[k]
