"""StatefulSet: ordered pods with stable identities.

A copy of kubernetes_tpu/controllers/statefulset.py; its relative imports
resolve in this package.

Reference: pkg/controller/statefulset/stateful_set_control.go
(UpdateStatefulSet: ordinal-ordered create/scale; OrderedReady waits for
predecessor readiness before creating the next replica; Parallel does
not). Pod names are <set>-<ordinal> — the stable network identity.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api import types as api
from ..runtime.store import Conflict
from .base import (Controller, is_pod_active, is_pod_ready,
                   make_pod_from_template)
from .history import REV_LABEL


class StatefulSetController(Controller):
    name = "statefulset"

    def __init__(self, store):
        super().__init__(store)
        self.informer("statefulsets")
        self.informer("pods",
                      on_add=self._pod_event,
                      on_update=lambda o, n: self._pod_event(n),
                      on_delete=self._pod_event)

    def _pod_event(self, pod):
        for ref in pod.metadata.owner_references:
            if ref.controller and ref.kind == "StatefulSet":
                self.queue.add(f"{pod.metadata.namespace}/{ref.name}")

    def _pods_by_ordinal(self, ss) -> Dict[int, api.Pod]:
        out: Dict[int, api.Pod] = {}
        prefix = ss.metadata.name + "-"
        for pod in self.store.list("pods", ss.metadata.namespace):
            if not pod.metadata.name.startswith(prefix):
                continue
            if not any(r.controller and r.kind == "StatefulSet"
                       and r.name == ss.metadata.name
                       for r in pod.metadata.owner_references):
                continue
            suffix = pod.metadata.name[len(prefix):]
            if suffix.isdigit():
                out[int(suffix)] = pod
        return out

    def sync(self, key: str):
        from . import history

        ns, name = key.split("/", 1)
        ss = self.store.get("statefulsets", ns, name)
        if ss is None:
            return
        # getStatefulSetRevisions (stateful_set_control.go:315): the
        # update revision snapshots the current template; currentRevision
        # trails it until the rollout completes
        revisions = history.list_revisions(self.store, ss, "StatefulSet")
        rev = history.sync_revision(self.store, ss, "StatefulSet",
                                    ss.spec.template, revisions=revisions)
        rev_hash = (rev.metadata.labels or {}).get(
            REV_LABEL, "")
        pods = self._pods_by_ordinal(ss)
        want = ss.spec.replicas
        ordered = ss.spec.pod_management_policy != "Parallel"
        # create missing ordinals in order; under OrderedReady stop at the
        # first not-ready predecessor (stateful_set_control.go:433)
        for i in range(want):
            pod = pods.get(i)
            if pod is None:
                # newVersionedStatefulSetPod: ordinals below the
                # RollingUpdate partition are rebuilt from the CURRENT
                # revision's snapshot, not the update template — a
                # restart must not advance a pinned ordinal
                template, use_hash = self._template_for_ordinal(
                    ss, i, rev_hash)
                new = make_pod_from_template(template, "StatefulSet",
                                             ss, f"{name}-{i}")
                new.metadata.labels["statefulset.kubernetes.io/pod-name"] = \
                    new.metadata.name
                new.metadata.labels[REV_LABEL] = use_hash
                self._ensure_claims(ss, new, i)
                try:
                    self.store.create("pods", new)
                except Conflict:
                    pass
                if ordered:
                    raise RuntimeError(f"waiting for ordinal {i}")
            elif ordered and not (is_pod_active(pod) and is_pod_ready(pod)):
                # predecessor not ready: halt rollout here
                break
        # scale down from the top ordinal (reverse order)
        for i in sorted((o for o in pods if o >= want), reverse=True):
            pod = pods[i]
            try:
                self.store.delete("pods", pod.metadata.namespace,
                                  pod.metadata.name)
            except KeyError:
                pass
            if ordered:
                raise RuntimeError(f"scaling down ordinal {i}")
        self._rolling_update(ss, pods, want, rev_hash)
        self._update_status(ss, pods, rev, rev_hash)
        history.truncate_history(
            self.store, ss, "StatefulSet",
            live_hashes={(p.metadata.labels or {}).get(
                REV_LABEL) for p in pods.values()
                if is_pod_active(p)},
            keep_names={rev.metadata.name, ss.status.current_revision},
            revisions=revisions)

    def _template_for_ordinal(self, ss, ordinal, rev_hash):
        """Template + revision hash a missing ordinal should be rebuilt
        from: the current revision's snapshot below the RollingUpdate
        partition, the update template otherwise
        (stateful_set_control.go newVersionedStatefulSetPod)."""
        from ..api import scheme
        from . import history

        strat = ss.spec.update_strategy
        cur_name = ss.status.current_revision
        if (strat.type != "RollingUpdate" or ordinal >= strat.partition
                or not cur_name):
            return ss.spec.template, rev_hash
        cur = self.store.get("controllerrevisions", ss.metadata.namespace,
                             cur_name)
        if cur is None:
            return ss.spec.template, rev_hash
        template = scheme.decode(api.PodTemplateSpec,
                                 cur.data["spec"]["template"])
        return template, (cur.metadata.labels or {}).get(
            history.REV_LABEL, rev_hash)

    def _rolling_update(self, ss, pods, want, rev_hash):
        """updateStatefulSet (stateful_set_control.go:520): under
        RollingUpdate, delete the highest-ordinal pod whose revision is
        stale, never touching ordinals below spec.updateStrategy.
        partition, and only one at a time while every replica is
        healthy (monotonic rollout). The create pass above recreates the
        ordinal at the update revision. OnDelete leaves stale pods for
        the operator."""
        if ss.spec.update_strategy.type != "RollingUpdate":
            return
        live = [p for o, p in pods.items() if o < want and is_pod_active(p)]
        if len(live) < want or not all(is_pod_ready(p) for p in live):
            return  # unhealthy replica: halt the rollout, don't compound
        partition = ss.spec.update_strategy.partition
        for i in sorted((o for o in pods if o < want), reverse=True):
            if i < partition:
                break
            p = pods[i]
            if (p.metadata.labels or {}).get(
                    REV_LABEL) != rev_hash:
                try:
                    self.store.delete("pods", p.metadata.namespace,
                                      p.metadata.name)
                except KeyError:
                    pass
                del pods[i]
                raise RuntimeError(f"rolling ordinal {i} to new revision")

    def _ensure_claims(self, ss, pod: api.Pod, ordinal: int):
        """volumeClaimTemplates (stateful_set_utils.go updateStorage +
        stateful_pod_control.go createPersistentVolumeClaims): mint the
        per-ordinal PVC `<template>-<set>-<ordinal>` if absent and mount
        it into the pod under the template's name. Claims survive
        scale-down/delete (the reference never reaps them)."""
        import copy

        for tmpl in ss.spec.volume_claim_templates:
            claim_name = f"{tmpl.metadata.name}-{ss.metadata.name}-{ordinal}"
            if self.store.get("persistentvolumeclaims",
                              ss.metadata.namespace, claim_name) is None:
                pvc = api.PersistentVolumeClaim(
                    metadata=api.ObjectMeta(
                        name=claim_name,
                        namespace=ss.metadata.namespace,
                        labels=dict(pod.metadata.labels or {})),
                    spec=copy.deepcopy(tmpl.spec))
                try:
                    self.store.create("persistentvolumeclaims", pvc)
                except Conflict:
                    pass
            # updateStorage semantics: a template volume of the SAME
            # name is REPLACED by the claim mount (not duplicated —
            # duplicate names fail pod validation)
            pod.spec.volumes = [v for v in pod.spec.volumes
                                if v.name != tmpl.metadata.name] + [
                api.Volume(name=tmpl.metadata.name, pvc_name=claim_name)]

    def _update_status(self, ss, pods, rev=None, rev_hash=""):
        live = [p for p in pods.values() if is_pod_active(p)]
        ready = sum(1 for p in live if is_pod_ready(p))
        updated = sum(1 for p in live if (p.metadata.labels or {}).get(
            REV_LABEL) == rev_hash)
        st = ss.status
        update_rev = rev.metadata.name if rev else st.update_revision
        # completeRollingUpdate: currentRevision catches up once every
        # replica serves the update revision AND is Ready — a rolled-
        # but-broken replica keeps the rollout in progress
        # (stateful_set_control.go completeRollingUpdate)
        current_rev = st.current_revision or update_rev
        if updated == len(live) == ready == ss.spec.replicas:
            current_rev = update_rev
        # currentReplicas counts pods at the CURRENT revision (apps/v1
        # semantics) — it shrinks as the rolling update advances
        cur_hash = rev_hash
        if current_rev != update_rev:
            cur_obj = self.store.get("controllerrevisions",
                                     ss.metadata.namespace, current_rev)
            cur_hash = (cur_obj.metadata.labels or {}).get(
                REV_LABEL, "") if cur_obj else ""
        current = sum(1 for p in live if (p.metadata.labels or {}).get(
            REV_LABEL) == cur_hash)
        gen = ss.metadata.generation
        if (st.replicas, st.ready_replicas, st.updated_replicas,
                st.current_replicas, st.current_revision,
                st.update_revision, st.observed_generation) == \
                (len(live), ready, updated, current, current_rev,
                 update_rev, gen):
            return
        st.replicas = len(live)
        st.ready_replicas = ready
        st.current_replicas = current
        st.updated_replicas = updated
        st.observed_generation = gen
        st.current_revision = current_rev
        st.update_revision = update_rev
        try:
            self.store.update("statefulsets", ss)
        except (Conflict, KeyError):
            pass
