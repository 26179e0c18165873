"""In-process object store with watch fan-out.

The framework's analog of the reference's storage + API + informer edge
for in-process use (test/integration's in-process apiserver,
framework/master_utils.go:108, plus the fake clientset object tracker,
client-go/testing/fixture.go). State-machine replication through etcd
watch fan-out (SURVEY.md §2.2) becomes: a versioned object map whose
mutations synchronously fan out to registered watchers — informers —
in resourceVersion order. Components stay level-triggered: a watcher
can always relist and resync.

The /bind subresource (pkg/registry/core/pod/storage BindingREST) is
`bind()`: it sets spec.nodeName and emits the MODIFIED event the
scheduler cache consumes to confirm its assumption
(factory.go:608 addPodToCache -> cache.AddPod).
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..api import types as api
from ..utils import faultpoints

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass
class Event:
    type: str
    kind: str
    obj: object
    old: Optional[object] = None
    resource_version: int = 0


WatchFn = Callable[[Event], None]


# generation maintenance lives in runtime/generation.py
from .generation import GenerationTracker


class Conflict(Exception):
    """Optimistic-concurrency failure (etcd3 ModRevision mismatch,
    reference storage/etcd3/store.go:262 GuaranteedUpdate)."""


class ObjectStore:
    # Watch events are dispatched synchronously UNDER self._lock (the
    # determinism contract informers and tests rely on); callers must not
    # post mutations from worker threads while another thread holds a lock
    # the handlers need — the scheduler keys its async-bind decision off
    # this flag.
    async_bind_safe = False

    def __init__(self):
        self._lock = threading.RLock()
        self._objects: Dict[str, Dict[str, object]] = {}
        self._rv = 0
        self._watchers: List[Tuple[Optional[str], WatchFn]] = []
        # spec-fingerprint/generation bookkeeping (shared helper —
        # callers mutate stored objects in place, so spec changes can
        # only be detected against an independent snapshot)
        self._generation = GenerationTracker()

    @staticmethod
    def _key(obj) -> str:
        meta = obj.metadata
        return f"{meta.namespace}/{meta.name}"

    def _notify(self, ev: Event):
        # chaos seam (kubernetes_tpu/runtime/store.py:84): a `drop`-mode
        # fault loses this event for EVERY watcher — the lost-watch-
        # delivery scenario reflector relists (and, for the scheduler's
        # tensor mirror, the snapshot scrubber) exist to recover from
        if faultpoints.fire("watch.deliver", payload=ev):
            return
        for kind, fn in list(self._watchers):
            if kind is None or kind == ev.kind:
                fn(ev)

    # -- watch ----------------------------------------------------------------

    def watch(self, kind: Optional[str], fn: WatchFn):
        with self._lock:
            self._watchers.append((kind, fn))

    def unwatch(self, fn: WatchFn):
        """Deregister a watcher by handler identity — a stopped
        component (e.g. a replaced apiserver's broadcaster) must not
        keep receiving every future event forever."""
        with self._lock:
            # equality, not identity: bound methods are recreated per
            # attribute access and only compare equal
            self._watchers = [(k, f) for k, f in self._watchers
                              if f != fn]

    # -- CRUD (reference: registry/generic/registry/store.go) -----------------

    def create(self, kind: str, obj) -> object:
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            key = self._key(obj)
            if key in objs:
                raise Conflict(f"{kind} {key} already exists")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            self._generation.on_create(kind, obj)
            objs[key] = obj
            ev = Event(ADDED, kind, obj, resource_version=self._rv)
            self._notify(ev)
            return obj

    def update(self, kind: str, obj, expect_rv: Optional[int] = None) -> object:
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            key = self._key(obj)
            old = objs.get(key)
            if old is None:
                raise KeyError(f"{kind} {key} not found")
            if expect_rv is not None and old.metadata.resource_version != expect_rv:
                raise Conflict(
                    f"{kind} {key}: rv {old.metadata.resource_version} != {expect_rv}")
            self._rv += 1
            obj.metadata.resource_version = self._rv
            # NOTE: `old` is usually the same in-place-mutated object the
            # caller passed; the tracker compares against its stored
            # fingerprint, never against `old`'s current state
            self._generation.on_update(kind, obj, old)
            objs[key] = obj
            self._notify(Event(MODIFIED, kind, obj, old=old, resource_version=self._rv))
            return obj

    def delete(self, kind: str, namespace: str, name: str) -> object:
        with self._lock:
            objs = self._objects.setdefault(kind, {})
            key = f"{namespace}/{name}"
            old = objs.pop(key, None)
            if old is None:
                raise KeyError(f"{kind} {key} not found")
            self._generation.on_delete(kind, namespace, name)
            self._rv += 1
            # stamp the deletion revision (etcd delete ModRevision analog) so
            # watch clients advance past this event instead of replaying it
            old.metadata.resource_version = self._rv
            self._notify(Event(DELETED, kind, old, resource_version=self._rv))
            return old

    def get(self, kind: str, namespace: str, name: str):
        with self._lock:
            return self._objects.get(kind, {}).get(f"{namespace}/{name}")

    def list(self, kind: str, namespace: Optional[str] = None) -> List[object]:
        with self._lock:
            objs = self._objects.get(kind, {})
            if namespace is None:
                return list(objs.values())
            prefix = namespace + "/"
            return [o for k, o in objs.items() if k.startswith(prefix)]

    def count(self, kind: str) -> int:
        with self._lock:
            return len(self._objects.get(kind, {}))

    @property
    def latest_resource_version(self) -> int:
        """Monotonic global revision (analog of etcd's header revision,
        storage/etcd3/store.go) — usable as a cheap cache-invalidation key."""
        with self._lock:
            return self._rv

    # -- pod subresources ------------------------------------------------------

    def bind(self, pod: api.Pod, node_name: str):
        """POST pods/<name>/binding (reference: scheduler.go:409 bind ->
        registry/core/pod BindingREST.Create).

        Copy-on-write: the stored object is replaced, never mutated — the
        serialization boundary the reference gets from etcd. Without it,
        informers would see old==new aliases and bind confirmation
        (cache.AddPod) would never fire."""
        with self._lock:
            old = self.get("pods", pod.namespace, pod.name)
            if old is None:
                raise KeyError(f"pod {pod.full_name()} not found")
            if old.spec.node_name and old.spec.node_name != node_name:
                raise Conflict(
                    f"pod {pod.full_name()} already bound to {old.spec.node_name}")
            cur = api.with_node_name(old, node_name)
            cur.status.phase = "Pending"  # running once kubelet reports
            cur.metadata = copy.copy(old.metadata)
            self._rv += 1
            cur.metadata.resource_version = self._rv
            self._objects["pods"][self._key(cur)] = cur
            self._notify(Event(MODIFIED, "pods", cur, old=old,
                               resource_version=self._rv))

    def set_pod_condition(self, pod: api.Pod, cond: Tuple[str, str]):
        with self._lock:
            old = self.get("pods", pod.namespace, pod.name)
            if old is None:
                return
            cur = copy.deepcopy(old)
            cur.status.conditions = [c for c in cur.status.conditions
                                     if c[0] != cond[0]] + [cond]
            self._rv += 1
            cur.metadata.resource_version = self._rv
            self._objects["pods"][self._key(cur)] = cur
            self._notify(Event(MODIFIED, "pods", cur, old=old,
                               resource_version=self._rv))

    def set_nominated_node(self, pod: api.Pod, node_name: str):
        with self._lock:
            old = self.get("pods", pod.namespace, pod.name)
            if old is None:
                return
            cur = copy.deepcopy(old)
            cur.status.nominated_node_name = node_name
            self._rv += 1
            cur.metadata.resource_version = self._rv
            self._objects["pods"][self._key(cur)] = cur
            self._notify(Event(MODIFIED, "pods", cur, old=old,
                               resource_version=self._rv))
