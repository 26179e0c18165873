"""ReplicaSet / ReplicationController reconciliation.

A copy of kubernetes_tpu/controllers/replicaset.py; its relative imports
resolve in this package.

Reference: pkg/controller/replicaset/replica_set.go (syncReplicaSet:562
manageReplicas:459) and pkg/controller/replication/ (same logic over the
RC shape). Diff desired vs. actual matching pods: create missing with
owner refs, delete surplus preferring not-ready/pending victims
(controller_utils.go ActivePods sort), then update status.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

from ..api import labels as lbl
from ..api import types as api
from ..runtime.store import Conflict
from .base import (Controller, is_pod_active, is_pod_ready,
                   make_pod_from_template, pod_owned_by)

_suffix = itertools.count(1)


def _victim_order(pod: api.Pod):
    """Deletion preference: pending before running, not-ready before ready
    (controller_utils.go ActivePods Less)."""
    return (pod.status.phase == "Running",  # False sorts first
            is_pod_ready(pod))


class _WorkloadSyncer(Controller):
    """Shared RS/RC sync over an adapter (kind, selector_fn)."""

    kind = "replicasets"
    owner_kind = "ReplicaSet"

    def __init__(self, store):
        super().__init__(store)
        self.informer(self.kind)
        # pod events enqueue the owning workload (replica_set.go addPod)
        self.pod_informer = self.informer(
            "pods",
            on_add=self._pod_event, on_update=lambda o, n: self._pod_event(n),
            on_delete=self._pod_event)

    def _pod_event(self, pod: api.Pod):
        for ref in pod.metadata.owner_references:
            if ref.controller and ref.kind == self.owner_kind:
                self.queue.add(f"{pod.metadata.namespace}/{ref.name}")

    def _selector(self, obj) -> Optional[lbl.Selector]:
        raise NotImplementedError

    def _template(self, obj) -> Optional[api.PodTemplateSpec]:
        return obj.spec.template

    def _replicas(self, obj) -> int:
        return obj.spec.replicas

    def _matching_pods(self, obj) -> List[api.Pod]:
        sel = self._selector(obj)
        out = []
        for pod in self.store.list("pods", obj.metadata.namespace):
            if not is_pod_active(pod):
                continue
            owned = pod_owned_by(pod, self.owner_kind, obj.metadata.name,
                                 obj.metadata.uid)
            if owned or (sel is not None and not pod.metadata.owner_references
                         and sel.matches(pod.metadata.labels or {})):
                out.append(pod)
        return out

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        obj = self.store.get(self.kind, ns, name)
        if obj is None:
            return  # deleted; pods are cleaned by the garbage collector
        pods = self._matching_pods(obj)
        want = self._replicas(obj)
        diff = want - len(pods)
        if diff > 0:
            template = self._template(obj)
            for _ in range(diff):
                pod = make_pod_from_template(
                    template, self.owner_kind, obj,
                    f"{name}-{next(_suffix):05d}")
                try:
                    self.store.create("pods", pod)
                except Conflict:
                    pass
        elif diff < 0:
            victims = sorted(pods, key=_victim_order)[:-diff]
            for pod in victims:
                try:
                    self.store.delete("pods", pod.metadata.namespace,
                                      pod.metadata.name)
                except KeyError:
                    pass
        self._update_status(obj, pods if diff <= 0 else
                            self._matching_pods(obj))

    def _update_status(self, obj, pods: List[api.Pod]):
        ready = sum(1 for p in pods if is_pod_ready(p))
        st = obj.status
        if (st.replicas, st.ready_replicas) == (len(pods), ready):
            return
        st.replicas = len(pods)
        st.ready_replicas = ready
        if hasattr(st, "available_replicas"):
            st.available_replicas = ready
        try:
            self.store.update(self.kind, obj)
        except (Conflict, KeyError):
            raise  # retry via rate-limited requeue


class ReplicaSetController(_WorkloadSyncer):
    name = "replicaset"
    kind = "replicasets"
    owner_kind = "ReplicaSet"

    def _selector(self, obj):
        return obj.spec.selector.to_selector() if obj.spec.selector else None


class ReplicationControllerController(_WorkloadSyncer):
    name = "replicationcontroller"
    kind = "replicationcontrollers"
    owner_kind = "ReplicationController"

    def _selector(self, obj):
        if obj.spec.selector:
            return lbl.Selector.from_set(obj.spec.selector)
        return None
