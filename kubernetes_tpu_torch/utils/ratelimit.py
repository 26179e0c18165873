"""Token-bucket rate limiter.

Reference: client-go util/flowcontrol/throttle.go
NewTokenBucketRateLimiter — the limiter behind the node lifecycle
controller's per-zone RateLimitedTimedQueue (zonePodEvictor /
zoneNoExecuteTainter in node_lifecycle_controller.go). Tokens accrue at
`qps` up to `burst`; TryAccept consumes one without blocking. The
controller swaps a zone's rate as the zone's health state changes
(SwapLimiter), so the SAME queue drains at the primary rate in a
healthy zone, at the secondary rate in a partially-disrupted one, and
not at all (qps 0) while eviction is suspended.

Clock-injectable so tests drive the drain deterministically: the
bucket refills from the difference between successive clock readings,
never from wall time.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class TokenBucket:
    """Non-blocking token bucket. qps <= 0 means "never admit" (the
    suspended / halted eviction states), not "unlimited"."""

    def __init__(self, qps: float, burst: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.burst = float(max(burst, 1.0))
        self._qps = float(qps)
        self._tokens = self.burst  # starts full, like flowcontrol's bucket
        self._last = clock()
        self._lock = threading.Lock()

    @property
    def qps(self) -> float:
        return self._qps

    def _refill(self, now: float) -> None:
        if now > self._last and self._qps > 0:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self._qps)
        self._last = max(self._last, now)

    def try_take(self, now: Optional[float] = None, n: float = 1.0) -> bool:
        """TryAccept: consume n tokens if available, never block."""
        now = now if now is not None else self.clock()
        with self._lock:
            self._refill(now)
            if self._qps <= 0 or self._tokens < n:
                return False
            self._tokens -= n
            return True

    def available(self, now: Optional[float] = None) -> float:
        now = now if now is not None else self.clock()
        with self._lock:
            self._refill(now)
            return self._tokens if self._qps > 0 else 0.0

    def swap_rate(self, qps: float, now: Optional[float] = None) -> None:
        """SwapLimiter: change the refill rate in place. Accrued tokens
        are kept (capped at burst) — entering a slower state must not
        grant a fresh burst, and recovering to a faster one must not
        confiscate what already accrued."""
        now = now if now is not None else self.clock()
        with self._lock:
            self._refill(now)
            if self._qps <= 0 and qps > 0:
                # while qps<=0 no tokens accrued; restart accrual from now
                self._last = now
            self._qps = float(qps)
