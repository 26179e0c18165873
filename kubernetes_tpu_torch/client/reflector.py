"""Reflector + remote informer store.

A copy of kubernetes_tpu/client/reflector.py; its relative imports resolve in this
package.

Reflector is the list+watch resync loop (client-go/tools/cache/
reflector.go:49 ListAndWatch): list to seed, then watch from the list's
resourceVersion, relist on 410 Gone. It feeds either plain handlers or a
RemoteStore — an ObjectStore-shaped facade that lets every in-process
component (Scheduler, controllers, kubelets) run unchanged against the
HTTP apiserver: reads hit the local mirror (informer cache), writes go
over REST, and watch callbacks fire from reflector threads (the
sharedProcessor fan-out, shared_informer.go:375).

Stream hardening (the reference's reflector.go backoffManager +
timeoutSeconds jitter, grown here after the device-path hardening left
this loop as the last silent failure path):

  * relist errors back off exponentially with +/-50% jitter (the old
    fixed 0.5s sleep hammered a flapping apiserver in lockstep with
    every OTHER reflector in the fleet) and are LOGGED with traceback +
    counted in scheduling_errors_total{stage=reflector} — a reflector
    dying quietly starves the scheduler of events with no signal;
  * a staleness watchdog forces a full relist when the watch stream has
    produced nothing past `stale_after` — a wedged-but-open stream (half
    -closed TCP, a proxy eating frames) otherwise looks identical to a
    quiet cluster forever (`watch_stale_total`);
  * every list+watch cycle is counted (`reflector_relists_total`) and
    chaos-drivable via the `reflector.relist` fault point.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..api import scheme
from ..api import types as api
from ..runtime.store import ADDED, DELETED, MODIFIED, Conflict, Event
from ..utils import faultpoints
from ..utils.backoff import exp_step, jittered
from .rest import APIStatusError, RESTClient


class Reflector:
    def __init__(self, client: RESTClient, plural: str,
                 on_event: Callable[[Event], None],
                 relist_backoff: float = 0.5,
                 max_relist_backoff: float = 30.0,
                 stale_after: float = 60.0,
                 watch_timeout: float = 10.0,
                 list_timeout: Optional[float] = None,
                 metrics=None,
                 health=None,
                 clock: Callable[[], float] = time.monotonic,
                 jitter: Callable[[], float] = random.random):
        self.client = client
        self.plural = plural
        self.on_event = on_event
        self.relist_backoff = relist_backoff
        self.max_relist_backoff = max_relist_backoff
        # per-relist budget for the LIST request (None = the client's
        # socket default): a hung LIST during an apiserver outage must
        # fail within the cycle so the backoff ladder and staleness
        # accounting keep moving
        self.list_timeout = list_timeout
        # optional sched.storehealth.StorePathBreaker: relist outcomes
        # feed the consecutive-failure count on the LIST path
        self.health = health
        # watchdog deadline: a stream with no events for this long is
        # declared stale and torn down for a relist. Must exceed the
        # per-stream server timeout (watch_timeout) by a healthy margin
        # or an idle cluster would relist every cycle.
        self.stale_after = stale_after
        self.watch_timeout = watch_timeout
        self.metrics = metrics  # utils.metrics.Metrics (or None)
        self.clock = clock
        self.jitter = jitter
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the live rung of the relist ladder — exposed (not a run()
        # local) so outage tests can assert the ladder capped at
        # max_relist_backoff and that the first post-heal relist reset it
        self.backoff = relist_backoff
        self.last_sync_rv = 0
        self.synced = threading.Event()  # set after the first list completes
        self.relists = 0       # list+watch cycles entered
        self.stale_relists = 0  # of those, forced by the staleness watchdog
        self._known: Dict[str, object] = {}

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def start(self) -> "Reflector":
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name=f"reflector-{self.plural}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _record_error(self, exc: BaseException):
        """A failed list+watch cycle is never silent: traceback to the
        log, stage=reflector into the labelled error series (matching
        the bind/wave/extender attribution), and — when a store-
        path breaker is wired — one consecutive-failure tick on the
        LIST path."""
        if self.metrics is not None:
            self.metrics.scheduling_errors.labels(stage="reflector").inc()
            self.metrics.store_errors.labels(op="list").inc()
        if self.health is not None:
            self.health.record_failure()
        logging.getLogger(__name__).error(
            "reflector %s: list+watch failed: %s: %s", self.plural,
            type(exc).__name__, exc, exc_info=exc)

    def _backoff_wait(self, backoff: float) -> float:
        """Sleep a jittered backoff (interruptible by stop()) and return
        the next, doubled backoff (utils/backoff.py — the one shared
        ladder shape). Jitter spans 0.5x-1.5x so a fleet of reflectors
        knocked over by one apiserver flap doesn't relist in lockstep
        forever after."""
        self._stop.wait(jittered(backoff, self.jitter))
        return exp_step(backoff, self.max_relist_backoff)

    def run(self):
        self.backoff = self.relist_backoff
        while not self._stop.is_set():
            try:
                # chaos seam: a `raise` here fails the whole cycle before
                # the list — the repeated-relist-failure scenario the
                # exponential backoff exists for
                faultpoints.fire("reflector.relist")
                self._list_and_watch()
                self.backoff = self.relist_backoff  # clean cycle: reset
            except APIStatusError as e:
                if e.code == 410:
                    # expected expiry: relist immediately, and a clean
                    # list resets the backoff ladder
                    self.backoff = self.relist_backoff
                    continue
                self._record_error(e)
                self.backoff = self._backoff_wait(self.backoff)
            except Exception as e:
                self._record_error(e)
                self.backoff = self._backoff_wait(self.backoff)

    def _list(self):
        faultpoints.fire("store.outage", payload=("list", self.plural))
        if self.list_timeout is not None:
            return self.client.list(self.plural, timeout=self.list_timeout)
        return self.client.list(self.plural)

    def _list_and_watch(self):
        self.relists += 1
        if self.metrics is not None:
            self.metrics.reflector_relists.inc()
        items, rv = self._list()
        if self.health is not None:
            self.health.record_success()  # the store answered a LIST
        # delta replay against the known set (DeltaFIFO Replace semantics,
        # tools/cache/delta_fifo.go Replace: sync adds + implicit deletes)
        new_keys = set()
        for obj in items:
            key = self._key(obj)
            new_keys.add(key)
            old = self._known.get(key)
            if old is None:
                self.on_event(Event(ADDED, self.plural, obj))
            elif old.metadata.resource_version != obj.metadata.resource_version:
                self.on_event(Event(MODIFIED, self.plural, obj, old=old))
            self._known[key] = obj
        for key in list(self._known):
            if key not in new_keys:
                self.on_event(Event(DELETED, self.plural, self._known.pop(key)))
        self.last_sync_rv = rv
        self.synced.set()
        last_progress = self.clock()
        while not self._stop.is_set():
            if self.clock() - last_progress > self.stale_after:
                # staleness watchdog: streams keep opening cleanly but
                # deliver nothing — indistinguishable from an idle
                # cluster except by relisting and comparing. Tear the
                # cycle down; run() re-enters with a fresh list.
                self.stale_relists += 1
                if self.metrics is not None:
                    self.metrics.watch_stale.inc()
                logging.getLogger(__name__).warning(
                    "reflector %s: watch quiet past %.1fs staleness "
                    "deadline; forcing a relist", self.plural,
                    self.stale_after)
                return
            # the stream ends on server timeoutSeconds; re-arm from last rv
            for etype, obj in self.client.watch(
                    self.plural, resource_version=rv,
                    timeout_seconds=self.watch_timeout, stop=self._stop):
                last_progress = self.clock()
                rv = max(rv, obj.metadata.resource_version)
                self.last_sync_rv = rv
                key = self._key(obj)
                if etype == DELETED:
                    self._known.pop(key, None)
                    self.on_event(Event(DELETED, self.plural, obj))
                elif key in self._known:
                    old = self._known[key]
                    self._known[key] = obj
                    if etype == ADDED or \
                            old.metadata.resource_version != obj.metadata.resource_version:
                        self.on_event(Event(MODIFIED, self.plural, obj, old=old))
                else:
                    self._known[key] = obj
                    self.on_event(Event(ADDED, self.plural, obj))


class RemoteStore:
    """ObjectStore facade backed by the HTTP apiserver.

    Components written against runtime.ObjectStore (scheduler, controllers,
    kubelet) run unchanged: list/get serve from reflector-maintained local
    mirrors; create/update/delete/bind go over REST; watch() handlers fire
    from the reflector threads. mirror(kind) must be called (or implied by
    watch()) before reads of that kind."""

    # binds are real HTTP posts and watch events arrive on reflector
    # threads with no store lock held during handler dispatch — safe (and
    # worthwhile) to post binds from the scheduler's worker pool
    async_bind_safe = True

    # per-attempt deadline on the bind POST: a hung bind must surface as
    # a retryable error inside the reconciler's budget, not stall a
    # binder thread for the full 30s default socket timeout
    bind_timeout = 5.0

    # per-relist deadline on the reflector LIST: during an outage the
    # relist must fail fast enough that the backoff ladder (capped at
    # 30s) is what paces recovery, not the socket default stacked on it
    list_timeout = 15.0

    def __init__(self, client: RESTClient, metrics=None,
                 stale_after: float = 60.0):
        self.client = client
        # shared utils.metrics.Metrics registry: reflector relist/stale
        # counters and stage=reflector errors land next to the
        # scheduler's own series on the same /metrics endpoint
        self.metrics = metrics
        self.stale_after = stale_after
        # optional sched.storehealth.StorePathBreaker, assigned by the
        # CLI after the scheduler is built (the scheduler owns the
        # breaker; this store feeds it from the write + LIST paths —
        # bind outcomes are fed by the reconciler seam instead, so one
        # failed POST is never double-counted)
        self.health = None
        self._lock = threading.RLock()
        self._mirrors: Dict[str, Dict[str, object]] = {}
        self._watchers: List[tuple] = []
        self._reflectors: Dict[str, Reflector] = {}

    # -- mirror management -----------------------------------------------------

    def mirror(self, kind: str) -> "RemoteStore":
        with self._lock:
            if kind in self._reflectors:
                return self
            self._mirrors[kind] = {}
            refl = Reflector(self.client, kind, self._on_event,
                             metrics=self.metrics,
                             stale_after=self.stale_after,
                             list_timeout=self.list_timeout,
                             health=self.health)
            self._reflectors[kind] = refl
            refl.start()
        return self

    def set_health(self, breaker) -> None:
        """Wire a StorePathBreaker after construction (the scheduler —
        which owns the breaker — is built against an already-mirroring
        store, so existing reflectors must pick it up too)."""
        with self._lock:
            self.health = breaker
            for refl in self._reflectors.values():
                refl.health = breaker

    def stop(self):
        for refl in self._reflectors.values():
            refl.stop()

    def wait_for_sync(self, timeout: float = 5.0) -> bool:
        """True if every mirror completed its initial list (informer
        HasSynced). rv is not the sentinel — an empty store lists at rv=0."""
        deadline = time.monotonic() + timeout
        ok = True
        for refl in list(self._reflectors.values()):
            left = max(0.0, deadline - time.monotonic())
            ok = refl.synced.wait(left) and ok
        return ok

    def _on_event(self, ev: Event):
        with self._lock:
            objs = self._mirrors.setdefault(ev.kind, {})
            key = f"{ev.obj.metadata.namespace}/{ev.obj.metadata.name}"
            if ev.type == DELETED:
                objs.pop(key, None)
            else:
                objs[key] = ev.obj
            watchers = list(self._watchers)
        for kind, fn in watchers:
            if kind is None or kind == ev.kind:
                fn(ev)

    # -- ObjectStore interface -------------------------------------------------

    def watch(self, kind: Optional[str], fn: Callable[[Event], None]):
        if kind is not None:
            self.mirror(kind)
        with self._lock:
            self._watchers.append((kind, fn))

    def unwatch(self, fn: Callable[[Event], None]):
        with self._lock:
            # equality, not identity: bound methods are recreated per
            # attribute access and only compare equal
            self._watchers = [(k, f) for k, f in self._watchers
                              if f != fn]

    def list(self, kind: str, namespace: Optional[str] = None) -> List[object]:
        self.mirror(kind)
        with self._lock:
            objs = self._mirrors.get(kind, {})
            if namespace is None:
                return list(objs.values())
            prefix = namespace + "/"
            return [o for k, o in objs.items() if k.startswith(prefix)]

    def get(self, kind: str, namespace: str, name: str):
        self.mirror(kind)
        with self._lock:
            return self._mirrors.get(kind, {}).get(f"{namespace}/{name}")

    def count(self, kind: str) -> int:
        return len(self.list(kind))

    @property
    def latest_resource_version(self) -> int:
        with self._lock:
            return max((r.last_sync_rv for r in self._reflectors.values()),
                       default=0)

    def _guard(self, op: str, fn):
        """Run one REST op under store-path accounting: the
        `store.outage` fault point fires first (raise = severed
        transport, latency = a slow apiserver), transport failures
        count into store_errors_total{op} and the breaker's consecutive
        count, and ANY server answer — including a 409/404
        APIStatusError — counts as the store being reachable."""
        faultpoints.fire("store.outage", payload=op)
        try:
            out = fn()
        except APIStatusError:
            if self.health is not None:
                self.health.record_success()
            raise
        except Exception:
            if self.metrics is not None:
                self.metrics.store_errors.labels(op=op).inc()
            if self.health is not None:
                self.health.record_failure()
            raise
        if self.health is not None:
            self.health.record_success()
        return out

    def create(self, kind: str, obj) -> object:
        try:
            return self._guard("create", lambda: self.client.create(kind, obj))
        except APIStatusError as e:
            if e.code == 409:
                raise Conflict(str(e))
            raise

    def update(self, kind: str, obj, expect_rv: Optional[int] = None) -> object:
        import copy
        obj = copy.copy(obj)
        obj.metadata = copy.copy(obj.metadata)
        if expect_rv is not None:
            # carry the CAS revision on the wire object so the server's
            # resourceVersion check enforces it (GuaranteedUpdate contract)
            obj.metadata.resource_version = expect_rv
            try:
                return self.client.update(kind, obj)
            except APIStatusError as e:
                if e.code == 409:
                    raise Conflict(str(e))
                raise
        # expect_rv=None: last-writer-wins like ObjectStore.update, but
        # via refetch-and-retry CAS (NativeObjectStore.update parity) so
        # writes stay properly serialized — a stale mirror rv must not
        # 409 into Conflict-swallowing callers (they'd silently drop the
        # write), and skipping the rv check entirely would let a single
        # round trip clobber unseen concurrent revisions without even
        # ordering them
        for _ in range(16):
            try:
                return self.client.update(kind, obj)
            except APIStatusError as e:
                if e.code != 409:
                    raise
                try:
                    cur = self.client.get(kind, obj.metadata.namespace,
                                          obj.metadata.name)
                except APIStatusError as ge:
                    if ge.code == 404:
                        # deleted between the 409 and the refetch: callers
                        # expect ObjectStore.update's KeyError here
                        raise KeyError(
                            f"{kind} {obj.metadata.name} not found")
                    raise
                obj.metadata.resource_version = \
                    cur.metadata.resource_version
        raise Conflict(f"{kind} {obj.metadata.name}: CAS retries exhausted")

    def delete(self, kind: str, namespace: str, name: str):
        try:
            self._guard("delete",
                        lambda: self.client.delete(kind, namespace, name))
        except APIStatusError as e:
            if e.code == 404:
                raise KeyError(f"{kind} {namespace}/{name} not found")
            raise

    def bind(self, pod: api.Pod, node_name: str):
        # no breaker recording and no store.outage fire here: bind
        # outcomes are fed to the breaker by the scheduler's reconciler
        # seam (per POST attempt), and the fault point fires at the
        # scheduler's bind/truth seams — both cover this path AND the
        # in-process ObjectStore; doubling them here would double-count
        # failures and burn injected `times` budgets twice per attempt
        try:
            self.client.bind(pod.metadata.namespace, pod.metadata.name,
                             node_name, timeout=self.bind_timeout)
        except APIStatusError as e:
            if e.code == 409:
                raise Conflict(str(e))
            if e.code == 404:
                raise KeyError(f"pod {pod.full_name()} not found")
            raise

    def set_pod_condition(self, pod: api.Pod, cond):
        try:
            self.client.patch("pods", pod.metadata.namespace, pod.metadata.name,
                              {"status": {"conditions": [list(cond)]}})
        except APIStatusError:
            pass

    def set_nominated_node(self, pod: api.Pod, node_name: str):
        try:
            self.client.patch("pods", pod.metadata.namespace, pod.metadata.name,
                              {"status": {"nominatedNodeName": node_name}})
        except APIStatusError:
            pass
