"""DaemonSet: one pod per eligible node.

A copy of kubernetes_tpu/controllers/daemonset.py; its relative imports
resolve in this package.

Reference: pkg/controller/daemon/daemon_controller.go (syncDaemonSet:
1075 manage:754 — nodesShouldRunDaemonPod:1206 decides per node via the
scheduler's own GeneralPredicates + taint checks; daemon pods are
created with spec.nodeName pre-set, bypassing the scheduler in 1.11).
"""

from __future__ import annotations

from typing import List

from ..api import types as api
from ..runtime.store import Conflict
from ..plugins import golden
from ..state.node_info import NodeInfo
from .base import (Controller, is_pod_active, is_pod_ready,
                   make_pod_from_template, pod_owned_by)
from .history import REV_LABEL
from .nodelifecycle import TAINT_NOT_READY, TAINT_UNREACHABLE


def add_daemon_tolerations(pod: api.Pod) -> api.Pod:
    """Stamp the not-ready/unreachable NoExecute tolerations on a daemon
    pod (1.11 daemon_controller.go util.AddOrUpdateDaemonPodTolerations):
    a daemon pod exists BECAUSE of its node — evicting it off a failed
    node just respawns it there in a loop, so it tolerates its own
    node's failure taints forever (no tolerationSeconds). Existing
    (key, effect)-matching tolerations are left alone."""
    for key in (TAINT_NOT_READY, TAINT_UNREACHABLE):
        if not any(t.key in ("", key) and t.effect in ("", api.NO_EXECUTE)
                   for t in pod.spec.tolerations):
            pod.spec.tolerations.append(api.Toleration(
                key=key, operator=api.TOLERATION_OP_EXISTS,
                effect=api.NO_EXECUTE))
    return pod


class DaemonSetController(Controller):
    name = "daemonset"

    def __init__(self, store):
        super().__init__(store)
        self.informer("daemonsets")
        self.informer("nodes", enqueue_fn=lambda o: self._all_dirty())
        self.informer("pods",
                      on_add=self._pod_event,
                      on_update=lambda o, n: self._pod_event(n),
                      on_delete=self._pod_event)

    def _all_dirty(self):
        for ds in self.store.list("daemonsets"):
            self.enqueue(ds)

    def _pod_event(self, pod):
        for ref in pod.metadata.owner_references:
            if ref.controller and ref.kind == "DaemonSet":
                self.queue.add(f"{pod.metadata.namespace}/{ref.name}")

    def _should_run(self, ds, node: api.Node) -> bool:
        """nodesShouldRunDaemonPod: simulate the daemon pod on the node —
        GeneralPredicates (incl. resource fit against existing pods),
        taints (daemon pods tolerate memory/disk-pressure implicitly in
        1.11), schedulability (daemon_controller.go:1206)."""
        if node.spec.unschedulable:
            return False
        pod = add_daemon_tolerations(make_pod_from_template(
            ds.spec.template, "DaemonSet", ds, "sim"))
        pod.spec.node_name = node.metadata.name
        ni = NodeInfo(node)
        for existing in self.store.list("pods"):
            if existing.spec.node_name == node.metadata.name and \
                    is_pod_active(existing) and not pod_owned_by(
                        existing, "DaemonSet", ds.metadata.name):
                ni.add_pod(existing)
        ok, _ = golden.general_predicates(pod, ni)
        if not ok:
            return False
        ok, _ = golden.pod_tolerates_node_taints(pod, ni)
        if not ok:
            return False
        ok, _ = golden.check_node_condition(pod, ni)
        return ok

    def sync(self, key: str):
        from . import history

        ns, name = key.split("/", 1)
        ds = self.store.get("daemonsets", ns, name)
        if ds is None:
            return
        # rollout history (daemon/update.go constructHistory): snapshot
        # the current template as a ControllerRevision and reap history
        # beyond the limit; live revisions (a pod still wears the hash)
        # are never reaped. The revision hash is ALSO the staleness
        # label — one content hash drives update decisions and history,
        # like the reference's controller-revision-hash
        revisions = history.list_revisions(self.store, ds, "DaemonSet")
        rev = history.sync_revision(self.store, ds, "DaemonSet",
                                    ds.spec.template, revisions=revisions)
        cur_hash = (rev.metadata.labels or {}).get(REV_LABEL, "")
        nodes = self.store.list("nodes")
        owned: List[api.Pod] = [
            p for p in self.store.list("pods", ns)
            if any(r.controller and r.kind == "DaemonSet" and r.name == name
                   for r in p.metadata.owner_references)]
        history.truncate_history(
            self.store, ds, "DaemonSet",
            live_hashes={(p.metadata.labels or {}).get(REV_LABEL)
                         for p in owned if is_pod_active(p)},
            keep_names={rev.metadata.name},
            revisions=revisions)
        by_node = {}
        for p in owned:
            by_node.setdefault(p.spec.node_name, []).append(p)
        desired = 0
        scheduled = 0
        misscheduled = 0
        updated = 0
        unavailable = 0
        stale_ready: List[api.Pod] = []
        for node in nodes:
            should = self._should_run(ds, node)
            have = [p for p in by_node.pop(node.metadata.name, [])
                    if is_pod_active(p)]
            if should:
                desired += 1
                if have:
                    scheduled += 1
                    # dedupe keeps a CURRENT-hash pod when one exists —
                    # deleting the fresh replacement instead of the
                    # stale duplicate would churn an extra round
                    have.sort(key=lambda p: (p.metadata.labels or {})
                              .get(REV_LABEL) != cur_hash)
                    for extra in have[1:]:
                        self._delete(extra)
                    p = have[0]
                    p_hash = (p.metadata.labels or {}).get(REV_LABEL)
                    if p_hash == cur_hash:
                        updated += 1
                        if not is_pod_ready(p):
                            unavailable += 1
                    elif not is_pod_ready(p):
                        # a stale not-ready pod costs nothing to replace
                        # (update.go rollingUpdate deletes these first)
                        unavailable += 1
                        if ds.spec.update_strategy.type != "OnDelete":
                            self._delete(p)
                    else:
                        stale_ready.append(p)
                else:
                    unavailable += 1
                    pod = add_daemon_tolerations(make_pod_from_template(
                        ds.spec.template, "DaemonSet", ds,
                        f"{name}-{node.metadata.name}"))
                    pod.spec.node_name = node.metadata.name
                    pod.metadata.labels = dict(
                        pod.metadata.labels or {},
                        **{REV_LABEL: cur_hash})
                    try:
                        self.store.create("pods", pod)
                    except Conflict:
                        pass
            else:
                for p in have:
                    misscheduled += 1
                    self._delete(p)
        # RollingUpdate (daemon/update.go): replace READY stale pods
        # only within the maxUnavailable budget; the manage pass above
        # recreates them at the new hash on the next sync
        if ds.spec.update_strategy.type != "OnDelete":
            budget = max(
                0, ds.spec.update_strategy.max_unavailable - unavailable)
            for p in stale_ready[:budget]:
                self._delete(p)
        for orphans in by_node.values():  # pods on deleted nodes
            for p in orphans:
                self._delete(p)
        self._update_status(ds, desired, scheduled, misscheduled, updated)

    def _delete(self, pod):
        try:
            self.store.delete("pods", pod.metadata.namespace, pod.metadata.name)
        except KeyError:
            pass

    def _update_status(self, ds, desired, scheduled, misscheduled,
                       updated=0):
        st = ds.status
        ready = 0
        for p in self.store.list("pods", ds.metadata.namespace):
            if any(r.controller and r.kind == "DaemonSet"
                   and r.name == ds.metadata.name
                   for r in p.metadata.owner_references) and is_pod_ready(p):
                ready += 1
        gen = ds.metadata.generation
        if (st.desired_number_scheduled, st.current_number_scheduled,
                st.number_misscheduled, st.number_ready,
                st.updated_number_scheduled, st.observed_generation) == \
                (desired, scheduled, misscheduled, ready, updated, gen):
            return
        st.desired_number_scheduled = desired
        st.current_number_scheduled = scheduled
        st.number_misscheduled = misscheduled
        st.number_ready = ready
        st.updated_number_scheduled = updated
        st.observed_generation = gen
        try:
            self.store.update("daemonsets", ds)
        except (Conflict, KeyError):
            pass
