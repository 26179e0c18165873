"""Service LB controller: keep cloud load balancers in sync with Services.

A copy of kubernetes_tpu/controllers/service_lb.py; its relative imports
resolve in this package.

Reference: pkg/controller/service/service_controller.go — watches
Services and Nodes; for every type=LoadBalancer service it calls the
cloud's EnsureLoadBalancer with the current ready-node set and writes
the returned ingress into status.loadBalancer (:306 syncLoadBalancer);
when the type changes away or the service is deleted it tears the LB
down (:263); node-set changes fan out UpdateLoadBalancer to all LB
services (:640 nodeSyncLoop).
"""

from __future__ import annotations

import threading
from typing import Dict, List

from ..api import types as api
from ..cloud.provider import CloudProvider
from .base import Controller


def _lb_ready_nodes(nodes: List[api.Node]) -> List[api.Node]:
    """service_controller.go:615 getNodeConditionPredicate: schedulable,
    Ready nodes back the LB."""
    out = []
    for n in nodes:
        if n.spec.unschedulable:
            continue
        ready = any(c.type == api.NODE_READY and c.status == api.COND_TRUE
                    for c in n.status.conditions)
        if ready:
            out.append(n)
    return out


class ServiceLBController(Controller):
    name = "service-lb"

    def __init__(self, store, cloud: CloudProvider, cluster_name: str = "tpu"):
        super().__init__(store)
        lb = cloud.load_balancer()
        if lb is None:
            raise ValueError("cloud provider does not support load balancers")
        self.lb = lb
        self.cluster_name = cluster_name
        self._mu = threading.Lock()
        # services whose LB we ensured, by key — needed to tear down after
        # the object is gone (the ref keeps this in its serviceCache).
        # Seeded from persisted status so a restarted/failed-over instance
        # still tears down LBs it didn't create itself; a service deleted
        # while no instance was running is only reclaimed by a finalizer,
        # which the v1.11-era reference doesn't use either.
        self._ensured: Dict[str, api.Service] = {
            f"{s.metadata.namespace}/{s.metadata.name}": s
            for s in store.list("services")
            if s.status.load_balancer.ingress}
        self._last_nodes: List[str] = []
        self.informer("services",
                      on_add=self.enqueue,
                      on_update=lambda o, n: self.enqueue(n),
                      on_delete=self.enqueue)
        self.informer("nodes", enqueue_fn=lambda *_: self._node_sync())

    def _node_sync(self):
        """Node churn: if the ready-node set changed, re-enqueue every LB
        service (nodeSyncLoop)."""
        names = sorted(n.name for n in
                       _lb_ready_nodes(self.store.list("nodes")))
        with self._mu:
            if names == self._last_nodes:
                return
            self._last_nodes = names
            keys = list(self._ensured)
        for key in keys:
            self.enqueue(key)

    def resync(self):
        for svc in self.store.list("services"):
            self.enqueue(svc)

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        svc = self.store.get("services", ns, name)
        wants_lb = svc is not None and svc.spec.type == "LoadBalancer"
        with self._mu:
            had = key in self._ensured
            cached = self._ensured.get(key)
        if not wants_lb:
            if had:
                # deleted or type changed away: tear down (:263)
                self.lb.ensure_load_balancer_deleted(
                    self.cluster_name, cached if svc is None else svc)
                with self._mu:
                    self._ensured.pop(key, None)
                if svc is not None and svc.status.load_balancer.ingress:
                    svc.status.load_balancer = api.LoadBalancerStatus()
                    self.store.update("services", svc)
            return
        nodes = _lb_ready_nodes(self.store.list("nodes"))
        status = self.lb.ensure_load_balancer(self.cluster_name, svc, nodes)
        with self._mu:
            self._ensured[key] = svc
        ips = [(i.ip, i.hostname) for i in status.ingress]
        cur = [(i.ip, i.hostname) for i in svc.status.load_balancer.ingress]
        if ips != cur:
            svc.status.load_balancer = status
            self.store.update("services", svc)
