"""Disruption controller: PDB status accounting.

A copy of kubernetes_tpu/controllers/disruption.py; its relative imports
resolve in this package.

Reference: pkg/controller/disruption/disruption.go (trySync:498 —
expectedCount from the pod's controller scale or minAvailable,
currentHealthy from ready pods, disruptionsAllowed = healthy - desired).
The scheduler's preemption consumes status.disruptionsAllowed
(generic_scheduler.go:228 ListPDBs -> filterPodsWithPDBViolation).
"""

from __future__ import annotations

from ..api import types as api
from ..runtime.store import Conflict
from .base import Controller, is_pod_active, is_pod_ready


class DisruptionController(Controller):
    name = "disruption"

    def __init__(self, store):
        super().__init__(store)
        self.informer("poddisruptionbudgets")
        self.informer("pods",
                      on_add=self._pod_event,
                      on_update=self._pod_update,
                      on_delete=self._pod_event)

    def _pod_update(self, old, new):
        # formerly-matching PDBs must recount when labels change
        self._pod_event(old)
        self._pod_event(new)

    def _pod_event(self, pod):
        labels = pod.metadata.labels or {}
        for pdb in self.store.list("poddisruptionbudgets",
                                   pod.metadata.namespace):
            sel = pdb.spec.selector
            if sel is not None and sel.matches(labels):
                self.enqueue(pdb)

    def _expected_count(self, pdb, pods) -> int:
        """expectedCount: from owning workloads' .spec.replicas, falling
        back to matched-pod count (disruption.go getExpectedPodCount)."""
        total = 0
        seen = set()
        for pod in pods:
            ref = next((r for r in pod.metadata.owner_references
                        if r.controller), None)
            if ref is None:
                total += 1
                continue
            key = (ref.kind, ref.name)
            if key in seen:
                continue
            seen.add(key)
            kind_map = {"ReplicaSet": "replicasets",
                        "ReplicationController": "replicationcontrollers",
                        "StatefulSet": "statefulsets",
                        "Deployment": "deployments"}
            plural = kind_map.get(ref.kind)
            owner = self.store.get(plural, pod.metadata.namespace, ref.name) \
                if plural else None
            total += owner.spec.replicas if owner is not None else 1
        return total

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        pdb = self.store.get("poddisruptionbudgets", ns, name)
        if pdb is None:
            return
        sel = pdb.spec.selector
        pods = [p for p in self.store.list("pods", ns)
                if sel is not None and sel.matches(p.metadata.labels or {})
                and is_pod_active(p)]
        healthy = sum(1 for p in pods if is_pod_ready(p))
        expected = self._expected_count(pdb, pods)
        if pdb.spec.min_available is not None:
            desired = pdb.spec.min_available
        elif pdb.spec.max_unavailable is not None:
            desired = max(0, expected - pdb.spec.max_unavailable)
        else:
            desired = expected
        allowed = max(0, healthy - desired)
        st = pdb.status
        if (st.current_healthy, st.desired_healthy, st.expected_pods,
                st.disruptions_allowed) == (healthy, desired, expected, allowed):
            return
        st.current_healthy = healthy
        st.desired_healthy = desired
        st.expected_pods = expected
        st.disruptions_allowed = allowed
        try:
            self.store.update("poddisruptionbudgets", pdb)
        except (Conflict, KeyError):
            pass
