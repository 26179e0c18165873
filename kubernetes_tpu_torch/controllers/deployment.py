"""Deployment -> ReplicaSet rollout management.

A copy of kubernetes_tpu/controllers/deployment.py; its relative imports
resolve in this package.

Reference: pkg/controller/deployment/deployment_controller.go
(syncDeployment:560) + rolling.go (rolloutRolling: scale up the new RS
within maxSurge, scale down olds within maxUnavailable) + sync.go
(getNewReplicaSet: RS per pod-template hash). Recreate strategy scales
olds to zero before creating the new RS (recreate.go).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..api import scheme
from ..api import types as api
from ..api.labels import LabelSelector
from ..runtime.store import Conflict
from .base import Controller

HASH_LABEL = "pod-template-hash"
# rollout history bookkeeping (deployment/util/deployment_util.go:36
# RevisionAnnotation): each RS keeps the revision it served; the
# deployment carries the current one; `kubectl rollout undo` resolves a
# revision back to its RS's template
REVISION_ANNOTATION = "deployment.kubernetes.io/revision"


def template_hash(template: api.PodTemplateSpec) -> str:
    """Stable hash of the pod template (util/hash ComputeHash analog)."""
    enc = scheme.encode(template)
    enc.get("metadata", {}).pop("uid", None)
    return scheme.stable_hash(enc, 10)


class DeploymentController(Controller):
    name = "deployment"

    def __init__(self, store):
        super().__init__(store)
        self.informer("deployments")
        self.informer("replicasets",
                      on_add=self._rs_event,
                      on_update=lambda o, n: self._rs_event(n),
                      on_delete=self._rs_event)

    def _rs_event(self, rs):
        for ref in rs.metadata.owner_references:
            if ref.controller and ref.kind == "Deployment":
                self.queue.add(f"{rs.metadata.namespace}/{ref.name}")

    # -- RS management ---------------------------------------------------------

    def _owned_replicasets(self, dep) -> List[api.ReplicaSet]:
        out = []
        for rs in self.store.list("replicasets", dep.metadata.namespace):
            if any(r.controller and r.kind == "Deployment"
                   and r.name == dep.metadata.name
                   for r in rs.metadata.owner_references):
                out.append(rs)
        return out

    def _new_and_old(self, dep) -> Tuple[Optional[api.ReplicaSet],
                                         List[api.ReplicaSet]]:
        h = template_hash(dep.spec.template)
        new, old = None, []
        for rs in self._owned_replicasets(dep):
            if (rs.metadata.labels or {}).get(HASH_LABEL) == h:
                new = rs
            else:
                old.append(rs)
        return new, old

    def _create_new_rs(self, dep) -> api.ReplicaSet:
        import copy
        h = template_hash(dep.spec.template)
        template = copy.deepcopy(dep.spec.template)
        template.metadata.labels = dict(template.metadata.labels or {})
        template.metadata.labels[HASH_LABEL] = h
        base_sel = dep.spec.selector or LabelSelector()
        sel = LabelSelector(
            match_labels={**dict(base_sel.match_labels), HASH_LABEL: h},
            match_expressions=base_sel.match_expressions)
        rs = api.ReplicaSet(
            metadata=api.ObjectMeta(
                name=f"{dep.metadata.name}-{h}",
                namespace=dep.metadata.namespace,
                labels=dict(template.metadata.labels),
                owner_references=[api.OwnerReference(
                    kind="Deployment", name=dep.metadata.name,
                    uid=dep.metadata.uid, controller=True)]),
            spec=api.ReplicaSetSpec(replicas=0, selector=sel,
                                    template=template))
        try:
            return self.store.create("replicasets", rs)
        except Conflict:
            return self.store.get("replicasets", dep.metadata.namespace,
                                  rs.metadata.name)

    def _scale(self, rs: api.ReplicaSet, replicas: int):
        if rs.spec.replicas == replicas:
            return
        rs.spec.replicas = replicas
        self.store.update("replicasets", rs)

    # -- sync ------------------------------------------------------------------

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        dep = self.store.get("deployments", ns, name)
        if dep is None:
            return
        if dep.spec.paused:
            return
        new_rs, old_rss = self._new_and_old(dep)
        if new_rs is None:
            new_rs = self._create_new_rs(dep)
        self._ensure_revision(dep, new_rs, old_rss)
        want = dep.spec.replicas
        if dep.spec.strategy.type == "Recreate":
            # scale olds to zero first; only then bring up the new RS
            if any(rs.spec.replicas > 0 or rs.status.replicas > 0
                   for rs in old_rss):
                for rs in old_rss:
                    self._scale(rs, 0)
                raise RuntimeError("waiting for old replicasets to scale down")
            self._scale(new_rs, want)
        else:
            # pure scale-down (deployment/sync.go scale(): replica-count
            # changes apply before rollout arithmetic — without this, a
            # deployment shrunk by the HPA never scales its new RS down)
            if new_rs.spec.replicas > want:
                self._scale(new_rs, want)
            # RollingUpdate (deployment/rolling.go): total <= want+maxSurge;
            # available >= want-maxUnavailable
            max_surge = dep.spec.strategy.max_surge
            max_unavailable = dep.spec.strategy.max_unavailable
            total = new_rs.spec.replicas + sum(r.spec.replicas for r in old_rss)
            # scale up new within the surge budget
            up_room = want + max_surge - total
            if up_room > 0 and new_rs.spec.replicas < want:
                self._scale(new_rs, min(want, new_rs.spec.replicas + up_room))
            # scale down olds while keeping availability
            ready = new_rs.status.ready_replicas + \
                sum(r.status.ready_replicas for r in old_rss)
            down_room = ready - (want - max_unavailable)
            for rs in sorted(old_rss, key=lambda r: r.spec.replicas,
                             reverse=True):
                if down_room <= 0:
                    break
                step = min(rs.spec.replicas, down_room)
                if step > 0:
                    self._scale(rs, rs.spec.replicas - step)
                    down_room -= step
        self._update_status(dep, new_rs, old_rss)
        if any(rs.spec.replicas > 0 for rs in old_rss) or \
                new_rs.spec.replicas != want:
            raise RuntimeError("rollout in progress")  # requeue to continue

    def _ensure_revision(self, dep, new_rs, old_rss):
        """deployment_util.go:180 SetNewReplicaSetAnnotations: the RS
        serving the current template gets maxOldRevision+1 (an undo that
        re-selects an old RS bumps it to the newest revision); the
        deployment mirrors the current revision."""
        max_old = max([int(rs.metadata.annotations.get(
            REVISION_ANNOTATION, 0)) for rs in old_rss] + [0])
        cur = int(new_rs.metadata.annotations.get(REVISION_ANNOTATION, 0))
        if cur <= max_old:
            new_rs.metadata.annotations[REVISION_ANNOTATION] = str(max_old + 1)
            try:
                self.store.update("replicasets", new_rs)
            except (Conflict, KeyError):
                return
        rev = new_rs.metadata.annotations[REVISION_ANNOTATION]
        if dep.metadata.annotations.get(REVISION_ANNOTATION) != rev:
            dep.metadata.annotations[REVISION_ANNOTATION] = rev
            try:
                self.store.update("deployments", dep)
            except (Conflict, KeyError):
                pass

    def _update_status(self, dep, new_rs, old_rss):
        all_rs = [new_rs] + old_rss
        st = dep.status
        new_st = api.DeploymentStatus(
            replicas=sum(r.status.replicas for r in all_rs),
            updated_replicas=new_rs.status.replicas,
            ready_replicas=sum(r.status.ready_replicas for r in all_rs),
            available_replicas=sum(r.status.ready_replicas for r in all_rs),
            unavailable_replicas=max(
                0, dep.spec.replicas - sum(r.status.ready_replicas
                                           for r in all_rs)),
            observed_generation=dep.metadata.generation)
        if (st.replicas, st.updated_replicas, st.ready_replicas,
                st.observed_generation) == \
                (new_st.replicas, new_st.updated_replicas,
                 new_st.ready_replicas, new_st.observed_generation):
            return
        dep.status = new_st
        try:
            self.store.update("deployments", dep)
        except (Conflict, KeyError):
            pass
