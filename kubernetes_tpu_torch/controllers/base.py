"""Controller base: the informer + workqueue reconcile loop.

The shape every reference controller shares (e.g. pkg/controller/
replicaset/replica_set.go: informer handlers -> workqueue.Add(key) ->
N workers -> syncHandler(key) -> requeue with rate limit on error).
`sync_all()` drains the queue synchronously for deterministic tests —
the analog of driving the loop with a fake clock in unit tests.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, List, Optional

from ..api import types as api
from ..client.workqueue import RateLimitingQueue
from ..runtime.informer import SharedInformer
from ..runtime.store import ObjectStore


class Controller:
    name = "controller"

    def __init__(self, store: ObjectStore):
        self.store = store
        self.queue = RateLimitingQueue()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.sync_errors = 0

    # -- to override -----------------------------------------------------------

    def sync(self, key: str) -> None:
        """Reconcile one key ('namespace/name'). Raise to retry with backoff."""
        raise NotImplementedError

    def resync(self) -> None:
        """Periodic full relist hook (informer resync period analog)."""

    # -- plumbing --------------------------------------------------------------

    def enqueue(self, obj_or_key):
        if isinstance(obj_or_key, str):
            self.queue.add(obj_or_key)
        else:
            meta = obj_or_key.metadata
            self.queue.add(f"{meta.namespace}/{meta.name}")

    def informer(self, kind: str, enqueue_fn: Optional[Callable] = None,
                 **handlers) -> SharedInformer:
        """Wire an informer whose every event enqueues via enqueue_fn
        (default: the object's own key)."""
        inf = SharedInformer(self.store, kind)
        fn = enqueue_fn or self.enqueue
        if handlers:
            inf.add_event_handler(**handlers)
        else:
            inf.add_event_handler(on_add=fn,
                                  on_update=lambda o, n: fn(n),
                                  on_delete=fn)
        return inf

    def process_one(self, timeout: float = 0.0) -> bool:
        key = self.queue.get(timeout=timeout)
        if key is None:
            return False
        try:
            self.sync(key)
            self.queue.forget(key)
        except Exception:
            self.sync_errors += 1
            self.queue.add_rate_limited(key)
        finally:
            self.queue.done(key)
        return True

    def sync_all(self, max_iters: int = 1000) -> int:
        """Drain the queue synchronously (test/deterministic mode)."""
        n = 0
        while n < max_iters and self.process_one():
            n += 1
        return n

    def run(self, workers: int = 1, resync_period: float = 30.0):
        """Start background workers (controller Run(workers, stopCh)) and
        a periodic resync ticker — controllers whose state can change
        without a watch event (HPA forbidden windows, time-based
        lifecycles) re-enqueue themselves via resync()."""
        def worker():
            while not self._stop.is_set():
                self.process_one(timeout=0.2)

        for i in range(workers):
            t = threading.Thread(target=worker, daemon=True,
                                 name=f"{self.name}-{i}")
            t.start()
            self._threads.append(t)
        if resync_period > 0:
            def resyncer():
                while not self._stop.wait(resync_period):
                    try:
                        self.resync()
                    except Exception:
                        self.sync_errors += 1

            t = threading.Thread(target=resyncer, daemon=True,
                                 name=f"{self.name}-resync")
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        self.queue.shut_down()


# -- shared pod helpers (pkg/controller/controller_utils.go) -------------------


is_pod_active = api.is_pod_active  # canonical definition in api/types.py


def is_pod_ready(pod: api.Pod) -> bool:
    """pod has condition Ready=True (api pod helpers IsPodReady)."""
    for ctype, cstatus in pod.status.conditions:
        if ctype == "Ready":
            return cstatus == "True" or cstatus.startswith("True")
    return False


def pod_owned_by(pod: api.Pod, kind: str, name: str, uid: str = "") -> bool:
    for ref in pod.metadata.owner_references:
        if ref.controller and ref.kind == kind and ref.name == name and \
                (not uid or not ref.uid or ref.uid == uid):
            return True
    return False


def make_pod_from_template(template: api.PodTemplateSpec, owner_kind: str,
                           owner, name: str) -> api.Pod:
    """Instantiate a pod from a template with a controller owner reference
    (controller_utils.go GetPodFromTemplate)."""
    import copy
    spec = copy.deepcopy(template.spec) if template is not None else api.PodSpec()
    labels = dict(template.metadata.labels) if template is not None else {}
    return api.Pod(
        metadata=api.ObjectMeta(
            name=name, namespace=owner.metadata.namespace, labels=labels,
            owner_references=[api.OwnerReference(
                kind=owner_kind, name=owner.metadata.name,
                uid=owner.metadata.uid, controller=True)]),
        spec=spec)
