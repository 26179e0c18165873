"""Store-path circuit breaker: the control-plane outage detector.

A copy of kubernetes_tpu/sched/storehealth.py: StorePathBreaker with its
states CONNECTED, DEGRADED and DISCONNECTED, STATE_CODES, the jittered
probe deadline (utils/backoff.py `jittered`) and snapshot(). The port's
Scheduler feeds it from the bind reconciler's per-attempt callbacks and
the truth GET (`_pod_truth`); the port has no RemoteStore yet, so no
reflector LIST feeds it.

Mirrors the device-path breaker's shape (sched/breaker.py: CLOSED ->
OPEN -> HALF_OPEN) for the OTHER critical dependency — the API store.
Consecutive RemoteStore failures/timeouts across GET/LIST/bind walk
the state machine:

    CONNECTED     every store op succeeding; failures reset to 0
    DEGRADED      at least one consecutive failure (or a half-open
                  probe in flight): ops still attempted
    DISCONNECTED  `threshold` consecutive failures: the scheduler
                  stops POSTing binds and spools them into the intent
                  journal instead (disconnected-mode scheduling),
                  while scoring/assuming continues against the cache

Unlike the device breaker's fixed cooldown, the probe deadline here is
JITTERED (utils/backoff.jittered, uniform [0.5x, 1.5x) of cooldown):
a fleet of schedulers recovering from one apiserver outage must not
stampede it with synchronized probes — the same reason client-go
jitters its reflector relists. allow() admits exactly one probe per
elapsed deadline (transitioning to DEGRADED); a probe failure re-trips
with a fresh jittered deadline, a success reconnects and fires
on_reconnect (the scheduler drains the spool there).

The state lands on the `scheduler_store_breaker_state` gauge
(0=connected, 1=degraded, 2=disconnected) via on_state; per-op errors
are counted by the owner into `store_errors_total{op}`.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

from ..utils.backoff import jittered

CONNECTED = "connected"
DEGRADED = "degraded"
DISCONNECTED = "disconnected"

STATE_CODES = {CONNECTED: 0, DEGRADED: 1, DISCONNECTED: 2}


class StorePathBreaker:
    def __init__(self, threshold: int = 3, cooldown: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 jitter: Callable[[], float] = random.random,
                 on_reconnect: Optional[Callable[[], None]] = None,
                 on_trip: Optional[Callable[[], None]] = None,
                 on_state: Optional[Callable[[str], None]] = None):
        self.threshold = max(1, threshold)
        self.cooldown = cooldown
        self.clock = clock
        self.jitter = jitter
        self.on_reconnect = on_reconnect
        self.on_trip = on_trip
        self.on_state = on_state
        self.state = CONNECTED
        self.failures = 0  # consecutive failures across GET/LIST/bind
        self.trips = 0
        self.tripped_at = 0.0
        self.retry_at = 0.0  # jittered probe deadline while DISCONNECTED
        self._probing = False

    def _transition(self, state: str) -> None:
        self.state = state
        if self.on_state is not None:
            self.on_state(state)

    def allow(self) -> bool:
        """May a store op be attempted right now? While DISCONNECTED,
        True exactly once per elapsed jittered deadline — that attempt
        IS the probe (state moves to DEGRADED until it resolves)."""
        if self.state != DISCONNECTED:
            return True
        if self.clock() >= self.retry_at:
            self._probing = True
            self._transition(DEGRADED)
            return True
        return False

    def record_failure(self) -> None:
        self.failures += 1
        if self._probing:
            self._trip()  # the probe itself failed: fresh jittered wait
        elif self.state != DISCONNECTED and self.failures >= self.threshold:
            self._trip()
        elif self.state == CONNECTED:
            self._transition(DEGRADED)

    def record_success(self) -> None:
        self.failures = 0
        self._probing = False
        if self.state != CONNECTED:
            self._transition(CONNECTED)
            if self.on_reconnect is not None:
                self.on_reconnect()

    def _trip(self) -> None:
        self._probing = False
        self._transition(DISCONNECTED)
        self.tripped_at = self.clock()
        self.retry_at = self.tripped_at + jittered(self.cooldown, self.jitter)
        self.trips += 1
        if self.on_trip is not None:
            self.on_trip()

    def snapshot(self) -> dict:
        """The /debug/store view of this breaker."""
        now = self.clock()
        return {
            "state": self.state,
            "failures": self.failures,
            "trips": self.trips,
            "probe_in_s": (round(max(0.0, self.retry_at - now), 3)
                           if self.state == DISCONNECTED else 0.0),
        }
