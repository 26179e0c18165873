"""HA apiserver endpoint reconciler.

A copy of kubernetes_tpu/server/reconciler.py; its relative imports
resolve in this package.

Reference: pkg/master/master.go:199-248 + the lease endpoint reconciler
(pkg/master/reconcilers/lease.go): every apiserver replica records its
own address under a refreshed lease in the shared store and rewrites the
"kubernetes" Endpoints object to the set of live replicas; a replica
that dies stops refreshing and is pruned by whichever replica
reconciles next. This is what makes `kubectl get endpoints kubernetes`
track a scale-out control plane.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

from ..api import types as api
from ..runtime.store import Conflict

LEASE_PREFIX = "apiserver-lease/"
ENDPOINTS_NAME = "kubernetes"


class EndpointReconciler:
    def __init__(self, store, addr: str, port: int, ttl: float = 15.0,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.addr = addr
        self.port = port
        self.ttl = ttl
        self.clock = clock
        self._stop = threading.Event()
        self._thread = None

    # -- one reconcile pass ----------------------------------------------------

    def reconcile(self):
        """Refresh our lease, prune expired ones, publish live addrs."""
        now = self.clock()
        ep = self.store.get("endpoints", "default", ENDPOINTS_NAME)
        created = ep is None
        if created:
            ep = api.Endpoints(metadata=api.ObjectMeta(
                name=ENDPOINTS_NAME, namespace="default"))
        leases: Dict[str, float] = {}
        for k, v in list(ep.metadata.annotations.items()):
            if k.startswith(LEASE_PREFIX):
                try:
                    leases[k[len(LEASE_PREFIX):]] = float(v)
                except ValueError:
                    pass
        leases[self.addr] = now
        live = sorted(a for a, t in leases.items() if now - t < self.ttl)
        ep.metadata.annotations = {
            **{k: v for k, v in ep.metadata.annotations.items()
               if not k.startswith(LEASE_PREFIX)},
            **{LEASE_PREFIX + a: str(t) for a, t in leases.items()
               if now - t < self.ttl}}
        ep.subsets = [api.EndpointSubset(
            addresses=[api.EndpointAddress(ip=a) for a in live],
            ports=[api.EndpointPort(name="https", port=self.port)])]
        try:
            if created:
                self.store.create("endpoints", ep)
            else:
                self.store.update("endpoints", ep)
        except (Conflict, KeyError):
            pass  # another replica won this round; next tick converges

    def remove(self):
        """Drop our own lease + address on clean shutdown."""
        ep = self.store.get("endpoints", "default", ENDPOINTS_NAME)
        if ep is None:
            return
        ep.metadata.annotations.pop(LEASE_PREFIX + self.addr, None)
        for ss in ep.subsets:
            ss.addresses = [a for a in ss.addresses if a.ip != self.addr]
        try:
            self.store.update("endpoints", ep)
        except (Conflict, KeyError):
            pass

    # -- background loop -------------------------------------------------------

    def start(self) -> "EndpointReconciler":
        self.reconcile()
        period = max(self.ttl / 3.0, 0.5)

        def loop():
            while not self._stop.wait(period):
                self.reconcile()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="endpoint-reconciler")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # an in-flight reconcile() would re-publish our lease right
            # after remove() pruned it — drain the loop first
            self._thread.join(timeout=5)
        self.remove()
