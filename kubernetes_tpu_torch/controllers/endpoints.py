"""Endpoints: service -> ready pod addresses.

A copy of kubernetes_tpu/controllers/endpoints.py; its relative imports
resolve in this package.

Reference: pkg/controller/endpoint/endpoints_controller.go
(syncService:397 — list pods matching the service selector, split by
readiness into addresses / notReadyAddresses, mirror service ports).
kube-proxy consumes the result to build its forwarding rules.
"""

from __future__ import annotations

from ..api import labels as lbl
from ..api import types as api
from ..runtime.store import Conflict
from .base import Controller, is_pod_active, is_pod_ready


def _pod_ip(pod: api.Pod) -> str:
    """The pod's address: status.podIP once the kubelet's network
    plugin assigned one (endpoints_controller.go reads exactly this);
    uid-hash fallback for pods no kubelet serves (pure control-plane
    tests)."""
    if pod.status.pod_ip:
        return pod.status.pod_ip
    from ..kubelet.network import HashIPPlugin

    return HashIPPlugin().setup_pod(pod.metadata.uid)


class EndpointsController(Controller):
    name = "endpoints"

    def __init__(self, store):
        super().__init__(store)
        self.informer("services")
        self.informer("pods",
                      on_add=self._pod_event,
                      on_update=self._pod_update,
                      on_delete=self._pod_event)

    def _pod_event(self, pod: api.Pod):
        labels = pod.metadata.labels or {}
        for svc in self.store.list("services", pod.metadata.namespace):
            if svc.selector and lbl.Selector.from_set(svc.selector).matches(labels):
                self.enqueue(svc)

    def _pod_update(self, old: api.Pod, new: api.Pod):
        # enqueue services matching the OLD labels too, so a relabeled pod
        # is removed from formerly-matching endpoints (reference updatePod)
        self._pod_event(old)
        self._pod_event(new)

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        svc = self.store.get("services", ns, name)
        if svc is None:
            try:
                self.store.delete("endpoints", ns, name)
            except KeyError:
                pass
            return
        if not svc.selector:
            return  # headless/manual endpoints are user-managed
        sel = lbl.Selector.from_set(svc.selector)
        ready, not_ready = [], []
        for pod in self.store.list("pods", ns):
            if not sel.matches(pod.metadata.labels or {}):
                continue
            if not is_pod_active(pod) or not pod.spec.node_name:
                continue
            addr = api.EndpointAddress(
                ip=_pod_ip(pod), node_name=pod.spec.node_name,
                target_pod=pod.full_name())
            (ready if is_pod_ready(pod) else not_ready).append(addr)
        ports = [api.EndpointPort(name=p.name, port=p.target_port or p.port,
                                  protocol=p.protocol)
                 for p in svc.spec.ports] or [api.EndpointPort(port=0)]
        subset = api.EndpointSubset(
            addresses=sorted(ready, key=lambda a: a.ip),
            not_ready_addresses=sorted(not_ready, key=lambda a: a.ip),
            ports=ports)
        existing = self.store.get("endpoints", ns, name)
        if existing is None:
            ep = api.Endpoints(metadata=api.ObjectMeta(name=name, namespace=ns),
                               subsets=[subset])
            try:
                self.store.create("endpoints", ep)
            except Conflict:
                pass
        else:
            if existing.subsets and _subsets_equal(existing.subsets[0], subset):
                return
            existing.subsets = [subset]
            try:
                self.store.update("endpoints", existing)
            except (Conflict, KeyError):
                pass


def _subsets_equal(a: api.EndpointSubset, b: api.EndpointSubset) -> bool:
    key = lambda addrs: [(x.ip, x.node_name) for x in addrs]  # noqa: E731
    return (key(a.addresses) == key(b.addresses)
            and key(a.not_ready_addresses) == key(b.not_ready_addresses)
            and [(p.name, p.port) for p in a.ports] ==
                [(p.name, p.port) for p in b.ports])
