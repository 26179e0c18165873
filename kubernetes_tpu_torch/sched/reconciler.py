"""Bind reconciler: retry the bind POST, then resolve its ambiguity.

A copy of kubernetes_tpu/sched/reconciler.py: BindReconciler and its
outcomes BOUND, CONFIRMED, ORPHANED and GONE, over the port's
runtime/store.Conflict, utils/tracing and utils/backoff.JitteredLadder.
The port's Scheduler sends every bind through it (sched/scheduler.py
`_bind_and_finish` and the spool drain `_flush_intent`).

The reference handles a failed bind with forget-on-error
(scheduler.go:409-432: ForgetPod + the error handler's backoff requeue)
and simply TOLERATES the succeeded-but-response-lost case — the
re-scheduled pod's second bind 409s against the first, the pod
eventually confirms through the informer, and the stale assumption ages
out via the 30s TTL. That tolerance costs a TTL's worth of phantom
capacity per lost response; at wave scale (128 binds in flight behind
one apiserver flap) it stalls whole nodes.

This reconciler closes the ambiguity instead:

  1. the POST is retried under a jittered exponential backoff, each
     attempt bounded by the transport's per-attempt deadline
     (RemoteStore.bind_timeout) — transient flaps never surface at all
     (`bind_retries_total` counts the extra attempts);
  2. when retries exhaust, the pod is GET-ed from API truth (bypassing
     any local mirror — the mirror's staleness is exactly what's in
     question): nodeName set means the bind LANDED and only the
     response was lost -> confirm the assumption; nodeName unset means
     it never landed -> forget and backoff-requeue; pod gone means a
     racing delete -> forget, nothing to requeue.

Every outcome therefore ends in exactly one of {assumption confirmed,
assumption forgotten}: capacity can neither double-bind nor leak. Only
when API truth is itself unreachable does the reconciler fall back to
the reference's behavior (forget + requeue) — the server's 409-on-
conflicting-bind remains the serialization point that makes that safe.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple

from ..runtime.store import Conflict
from ..utils import tracing
from ..utils.backoff import JitteredLadder

log = logging.getLogger(__name__)

# outcomes of reconcile()
BOUND = "bound"          # a POST attempt succeeded
CONFIRMED = "confirmed"  # retries exhausted, but API truth shows the bind landed
ORPHANED = "orphaned"    # API truth shows no binding -> forget + requeue
GONE = "gone"            # pod deleted from API truth -> forget, no requeue


class BindReconciler:
    def __init__(self, get_truth: Callable[[object], Optional[object]],
                 metrics=None, max_attempts: int = 3,
                 base_delay: float = 0.05, max_delay: float = 1.0,
                 sleep: Callable[[float], None] = time.sleep,
                 jitter: Callable[[], float] = random.random,
                 on_transport_error: Optional[Callable[[], None]] = None,
                 on_transport_ok: Optional[Callable[[], None]] = None):
        """get_truth(pod) -> the pod from API truth (None if deleted);
        must bypass local mirrors and raise when truth is unreachable.
        on_transport_error/on_transport_ok fire once per POST attempt
        that failed on transport / succeeded — the store-path breaker's
        consecutive-failure feed (definitive 409/404 answers count as
        the store ANSWERING, so they fire on_transport_ok)."""
        self.get_truth = get_truth
        self.metrics = metrics
        self.max_attempts = max(1, max_attempts)
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.sleep = sleep
        self.jitter = jitter
        self.on_transport_error = on_transport_error
        self.on_transport_ok = on_transport_ok

    def reconcile(self, pod, node_name: str,
                  attempt: Callable[[], None]) -> Tuple[str, Optional[object]]:
        """Run `attempt` (one bind POST) under the retry policy, then
        resolve any remaining ambiguity against API truth. Returns
        (outcome, truth_pod_or_None); the caller owns the cache/queue
        consequences of each outcome."""
        ladder = JitteredLadder(self.base_delay, self.max_delay,
                                jitter=self.jitter)
        last_exc: Optional[BaseException] = None
        for i in range(self.max_attempts):
            if i > 0:
                if self.metrics is not None:
                    self.metrics.bind_retries.inc()
                # span event so a pod's trace shows every extra POST it
                # cost (flight recorder; no-op when tracing is off)
                tracing.event("bind_retry", pod=f"{pod.namespace}/{pod.name}",
                              attempt=i + 1,
                              error=type(last_exc).__name__
                              if last_exc is not None else "")
                self.sleep(ladder.bump())
            try:
                attempt()
                if self.on_transport_ok is not None:
                    self.on_transport_ok()
                return BOUND, None
            except (Conflict, KeyError) as e:
                # a definitive server answer (409 already-bound, 404
                # pod gone), not a transport fault: retrying the POST
                # can't change it — go straight to truth resolution
                if self.on_transport_ok is not None:
                    self.on_transport_ok()
                last_exc = e
                break
            except Exception as e:  # noqa: BLE001 — transport errors retry
                if self.on_transport_error is not None:
                    self.on_transport_error()
                last_exc = e
        # retries exhausted: the POST may or may not have landed (a lost
        # RESPONSE is indistinguishable from a lost REQUEST out here) —
        # ask the server which world this is
        try:
            truth = self.get_truth(pod)
        except Exception as e:  # truth unreachable: reference fallback
            log.warning(
                "bind of %s/%s -> %s failed after %d attempts (%s: %s) and "
                "API truth is unreachable (%s: %s); orphaned without truth "
                "— the scheduler spools the intent (outage mode) or falls "
                "back to forget-on-error", pod.namespace, pod.name,
                node_name, self.max_attempts, type(last_exc).__name__,
                last_exc, type(e).__name__, e)
            return ORPHANED, None
        if truth is None:
            return GONE, None
        if truth.spec.node_name:
            # the bind landed (ours, or — if nodeName differs — someone
            # else's that ours 409ed against); either way the assumption
            # must converge to API truth, not be rolled back
            log.info(
                "bind of %s/%s resolved as landed on %s after a lost "
                "response (%d attempts, last error %s: %s)",
                pod.namespace, pod.name, truth.spec.node_name,
                self.max_attempts, type(last_exc).__name__, last_exc)
            return CONFIRMED, truth
        log.warning(
            "bind of %s/%s -> %s never landed (%d attempts, last error "
            "%s: %s); forgetting the assumption and requeueing",
            pod.namespace, pod.name, node_name, self.max_attempts,
            type(last_exc).__name__, last_exc)
        return ORPHANED, truth
