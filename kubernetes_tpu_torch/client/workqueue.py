"""Work queues: dedup + delaying + rate-limited retry.

Analog of client-go/util/workqueue: Type (queue.go:23 — dedup of dirty/
processing items), DelayingQueue (delaying_queue.go — AddAfter),
RateLimitingQueue (rate_limiting_queue.go — AddRateLimited/Forget) with
the per-item exponential failure limiter (default_rate_limiters.go:39,
5ms..1000s) every controller uses for retries.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional


class WorkQueue:
    """Dedup queue: an item added while queued is not duplicated; an item
    added while being processed is re-queued when done (workqueue/queue.go)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._queue: List[object] = []
        self._dirty = set()
        self._processing = set()
        self._shutting_down = False

    def add(self, item):
        with self._cond:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return
            self._queue.append(item)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None):
        """Returns item or None on shutdown/timeout. Caller must call done()."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._queue and not self._shutting_down:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return None
                self._cond.wait(left)
            if not self._queue:
                return None
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            return item

    def done(self, item):
        with self._cond:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._cond.notify()

    def shut_down(self):
        with self._cond:
            self._shutting_down = True
            self._cond.notify_all()

    def __len__(self):
        with self._cond:
            return len(self._queue)


class DelayingQueue(WorkQueue):
    """AddAfter support via a waiting heap drained by a background thread
    (delaying_queue.go waitingLoop)."""

    def __init__(self, clock=time.monotonic):
        super().__init__()
        self._clock = clock
        self._heap: List[tuple] = []
        self._heap_cond = threading.Condition()
        self._seq = 0
        self._stop = threading.Event()
        self._waiter = threading.Thread(target=self._waiting_loop,
                                        daemon=True, name="workqueue-delay")
        self._waiter.start()

    def add_after(self, item, delay: float):
        if delay <= 0:
            return self.add(item)
        with self._heap_cond:
            self._seq += 1
            heapq.heappush(self._heap, (self._clock() + delay, self._seq, item))
            self._heap_cond.notify()

    def _waiting_loop(self):
        while not self._stop.is_set():
            with self._heap_cond:
                now = self._clock()
                while self._heap and self._heap[0][0] <= now:
                    _, _, item = heapq.heappop(self._heap)
                    self.add(item)
                wait = (self._heap[0][0] - now) if self._heap else 1.0
                self._heap_cond.wait(min(wait, 1.0))

    def shut_down(self):
        self._stop.set()
        with self._heap_cond:
            self._heap_cond.notify_all()
        super().shut_down()


class ItemExponentialFailureRateLimiter:
    """5ms * 2^failures capped at max_delay (default_rate_limiters.go:39;
    controllers use 5ms..1000s)."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        self.base_delay = base_delay
        self.max_delay = max_delay
        self._failures: Dict[object, int] = {}
        self._lock = threading.Lock()

    def when(self, item) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
            return min(self.base_delay * (2 ** n), self.max_delay)

    def forget(self, item):
        with self._lock:
            self._failures.pop(item, None)

    def num_requeues(self, item) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class RateLimitingQueue(DelayingQueue):
    def __init__(self, rate_limiter: Optional[ItemExponentialFailureRateLimiter] = None,
                 clock=time.monotonic):
        super().__init__(clock=clock)
        self.rate_limiter = rate_limiter or ItemExponentialFailureRateLimiter()

    def add_rate_limited(self, item):
        self.add_after(item, self.rate_limiter.when(item))

    def forget(self, item):
        self.rate_limiter.forget(item)
