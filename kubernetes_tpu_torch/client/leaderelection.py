"""Leader election via a lease-record lock object.

A copy of kubernetes_tpu/client/leaderelection.py; its relative imports resolve in this
package.

Analog of client-go/tools/leaderelection/leaderelection.go:70: candidates
race to create/renew a LeaseRecord; the holder renews every retry_period,
others acquire when renew_time + lease_duration has expired. Optimistic
concurrency comes from the store's resourceVersion compare-and-swap
(resourcelock's Update on the annotation-carrying object).

Failover semantics (beyond leaderelection.go, whose Run returns after
one leadership and expects the process to exit — OnStoppedLeading is
documented as the hook to crash from): run() here LOOPS — lose the
lease, fire on_stopped_leading, go back to candidate mode, and fire
on_started_leading again on re-acquisition. That cycle is what lets the
scheduler warm-restart: dormant on loss (informers stay hot), a
recovery pass + resume on re-acquisition, instead of a cold process
restart and a full relist storm.

Renew/acquire attempts are hardened: any store/transport error during
the attempt — including the `lease.renew` chaos fault point — counts as
a failed renewal (the renew_deadline clock keeps running), never as a
crashed elector thread. An apiserver flap shorter than renew_deadline
therefore costs nothing; a longer one demotes the leader cleanly.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..api import types as api
from ..runtime.store import Conflict
from ..utils import faultpoints


class LeaderElector:
    def __init__(self, store, identity: str, lock_name: str = "kube-scheduler",
                 lease_duration: float = 15.0, renew_deadline: float = 10.0,
                 retry_period: float = 2.0, clock=time.time,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None):
        self.store = store
        self.identity = identity
        self.lock_name = lock_name
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.clock = clock
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.is_leader = False
        self.leaderships = 0  # acquisitions over this elector's lifetime
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lock record access (resourcelock analog) ------------------------------

    def _get(self) -> Optional[api.LeaseRecord]:
        for ns in ("default", ""):
            rec = self.store.get("leases", ns, self.lock_name)
            if rec is not None:
                return rec
        return None

    def _try_acquire_or_renew(self) -> bool:
        """leaderelection.go:221 tryAcquireOrRenew, hardened: transport
        and store errors are a failed attempt, not a crashed elector —
        the reference gets the same effect from wrapping every lock
        access in error returns that tryAcquireOrRenew maps to false."""
        try:
            # chaos seam: `raise` models the apiserver rejecting/failing
            # the renew round trip, `latency` a slow one that eats into
            # the renew_deadline budget
            faultpoints.fire("lease.renew")
            return self._acquire_or_renew_once()
        except (Conflict, KeyError):
            return False
        except Exception as e:
            logging.getLogger(__name__).warning(
                "lease acquire/renew attempt failed for %s: %s: %s",
                self.identity, type(e).__name__, e)
            return False

    def _acquire_or_renew_once(self) -> bool:
        now = self.clock()
        rec = self._get()
        if rec is None:
            rec = api.LeaseRecord(
                metadata=api.ObjectMeta(name=self.lock_name),
                holder_identity=self.identity,
                lease_duration_seconds=self.lease_duration,
                acquire_time=now, renew_time=now)
            try:
                self.store.create("leases", rec)
                return True
            except Conflict:
                return False
        if rec.holder_identity != self.identity:
            if now < rec.renew_time + rec.lease_duration_seconds:
                return False  # held by a live leader
            transitions = rec.leader_transitions + 1
            acquire = now
        else:
            transitions = rec.leader_transitions
            acquire = rec.acquire_time
        new = api.LeaseRecord(
            metadata=rec.metadata, holder_identity=self.identity,
            lease_duration_seconds=self.lease_duration,
            acquire_time=acquire, renew_time=now,
            leader_transitions=transitions)
        try:
            self.store.update("leases", new,
                              expect_rv=rec.metadata.resource_version)
            return True
        except (Conflict, KeyError):
            return False

    # -- run loop --------------------------------------------------------------

    def run(self):
        """Candidate -> leader -> demoted -> candidate, until stop():
        acquire (blocking), fire on_started_leading, renew every
        retry_period until renewal has failed for renew_deadline, fire
        on_stopped_leading, and go back to acquiring. Each full cycle is
        one warm-restart opportunity for the callbacks' owner."""
        while not self._stop.is_set():
            if not self._acquire():
                return  # stopped while a candidate
            self.is_leader = True
            self.leaderships += 1
            if self.on_started_leading:
                self.on_started_leading()
            self._renew_until_lost()
            self.is_leader = False
            if self.on_stopped_leading:
                self.on_stopped_leading()

    def _acquire(self) -> bool:
        """Block until the lease is acquired; False = stopped first."""
        while not self._stop.is_set():
            if self._try_acquire_or_renew():
                return True
            self._stop.wait(self.retry_period)
        return False

    def _renew_until_lost(self):
        """Renew until stop() or the lease is lost: renewals failing for
        longer than renew_deadline (leaderelection.go:263 renew loop)."""
        last_renew = self.clock()
        while not self._stop.is_set():
            self._stop.wait(self.retry_period)
            if self._stop.is_set():
                return
            if self._try_acquire_or_renew():
                last_renew = self.clock()
            elif self.clock() - last_renew > self.renew_deadline:
                logging.getLogger(__name__).warning(
                    "leader %s lost the %s lease: no successful renew in "
                    "%.1fs (deadline %.1fs)", self.identity, self.lock_name,
                    self.clock() - last_renew, self.renew_deadline)
                return

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"leaderelection-{self.identity}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
