"""Cluster autoscaler: elastic NodeGroups driven by on-device what-ifs.

A copy of kubernetes_tpu/controllers/clusterautoscaler.py over the
port's simulate (both what-ifs run the port's wave and gang on the
scheduler's device, so on the card they launch the taint/port kernel),
featurizer, PDB check and PodBackoff, with the reference's fault points
(`autoscaler.simulate` in ops/simulate.py, `cloud.resize` in
cloud/provider.py). While the scheduler's device-path breaker is OPEN
the what-ifs run on the numpy twin (`_simulate_backend`), so a tripped
card is never dispatched to; a sticky CUDA error (an illegal address, a
device-side assert) keeps that breaker from closing until the process
restarts, and the autoscaler then stays on the twin.

Reference: kubernetes/autoscaler cluster-autoscaler — RunOnce loops
ScaleUp (estimate which node-group expansion makes the pending pods
feasible) and ScaleDown (find under-utilized nodes whose residents
re-fit elsewhere, then cordon/drain/delete). The reference's
`simulator/` package does both by cloning NodeInfos host-side and
re-running predicates pod by pod; here both what-ifs run on the device
path through `ops/simulate.py` — virtual template rows appended to a
shadow snapshot for scale-up, the gang all-or-nothing plane for the
scale-down joint re-placement proof.

Wiring:
  * feeds off the scheduler's unschedulable map
    (`Scheduler.pending_unschedulable`) and its featurization hook
    (`Scheduler.shadow_featurizer`) so what-if rows encode exactly like
    live ones;
  * NodeGroup membership of live nodes is inferred from the
    `beta.kubernetes.io/instance-type` label the cloud-node controller
    stamps (cloud/provider.py LABEL_INSTANCE_TYPE);
  * respects per-group cooldowns after successful resizes and
    exponential backoff (utils/backoff.py) after cloud failures — a
    failed resize can never double a scale-up: the failed call mutated
    nothing and the group is ineligible until the deadline;
  * emits `TriggeredScaleUp` events on the helped pods and `ScaleDown`
    on removed nodes through client/record.py;
  * scale-down marks the node `spec.unschedulable` (cordon — visible as
    Ready,SchedulingDisabled in `kubectl get nodes`), drains residents
    through the store delete path (their controllers recreate them; the
    refit proof already guaranteed a home), then calls the cloud's
    `delete_nodes` and removes the Node object. A cloud failure after
    the cordon leaves a consistent cluster: the node stays cordoned and
    present (no orphan snapshot rows) and the drain resumes after the
    group's backoff.

Cost note: a what-if rebuilds the shadow snapshot host-side —
O(nodes + resident pods) re-featurization under the scheduler lock —
so both directions gate it hard: scale-up only when unschedulable pods
AND eligible groups exist, scale-down only after a candidate survives
every cheap filter (group membership, bounds, cooldown, threshold,
replication, PDBs). Passes with nothing to do never take the build
path, and the controller's resync cadence bounds how often the
expensive ones can fire.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import types as api
from ..client.record import EventRecorder
from ..cloud.provider import LABEL_INSTANCE_TYPE, NodeGroup
from ..ops import encoding as enc
from ..ops import simulate
from ..state.featurize import PodFeaturizer
from ..sched.preemption import _pods_violating_pdb
from ..utils.backoff import PodBackoff
from .base import Controller

LOG = logging.getLogger(__name__)

# Stamped on a node when its drain begins (cordon) and gone only when
# the node is: the durable analog of the reference's
# ToBeDeletedByClusterAutoscaler taint. Without it, a restart between
# cordon and cloud delete would leave the node permanently cordoned —
# the scan's "someone else's cordon: hands off" rule would skip it
# forever (the in-memory _draining set dies with the process).
ANN_SCALE_DOWN = "cluster-autoscaler.kubernetes.io/scale-down-in-progress"


def _replicated(pod: api.Pod) -> bool:
    """Something will recreate this pod after a drain delete (reference
    drain.GetPodsForDeletion: only replicated pods are safely movable —
    a bare pod would be silently destroyed)."""
    return any(ref.controller for ref in pod.metadata.owner_references)


def pick_expansion(options: List[Tuple[NodeGroup, int, int]]
                   ) -> Optional[Tuple[NodeGroup, int]]:
    """Choose one expansion from (group, pods_helped, nodes_needed)
    options: most pods helped first, then cheapest total price, then
    group name for determinism (the reference's `least-waste`/`price`
    expander family collapsed to one rule). Returns (group, nodes)."""
    best = None
    for g, helped, nodes in options:
        if helped <= 0 or nodes <= 0:
            continue
        key = (-helped, g.price * nodes, g.name)
        if best is None or key < best[0]:
            best = (key, g, nodes)
    return None if best is None else (best[1], best[2])


class ClusterAutoscaler(Controller):
    name = "cluster-autoscaler"

    def __init__(self, store, cloud, scheduler, *,
                 utilization_threshold: float = 0.5,
                 scale_up_cooldown: float = 10.0,
                 scale_down_cooldown: float = 60.0,
                 max_virtual_per_group: int = 8,
                 max_pods_per_pass: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None):
        super().__init__(store)
        self.cloud = cloud
        self.scheduler = scheduler
        self.utilization_threshold = utilization_threshold
        self.scale_up_cooldown = scale_up_cooldown
        self.scale_down_cooldown = scale_down_cooldown
        self.max_virtual_per_group = max_virtual_per_group
        self.max_pods_per_pass = max_pods_per_pass
        self.clock = clock
        self.metrics = metrics if metrics is not None else getattr(
            scheduler, "metrics", None)
        self.recorder = EventRecorder(store, "cluster-autoscaler")
        self.backoff = PodBackoff(clock=clock)
        self._cooldown_until: Dict[str, float] = {}  # group -> deadline
        self._retry_at: Dict[str, float] = {}  # group -> backoff deadline
        # nodes we cordoned for removal whose cloud delete hasn't landed
        # yet — picked up again on the next pass regardless of
        # utilization so a mid-drain cloud fault can't strand them
        self._draining: Set[str] = set()
        # introspection for tests/debugging
        self.last_verdict: Optional[simulate.SimulationVerdict] = None
        self.last_scale_up: Optional[Tuple[str, int, List[str]]] = None
        self.last_scale_down: Optional[str] = None

    # -- controller plumbing (periodic RunOnce) --------------------------------

    def resync(self):
        self.enqueue("~/autoscale")

    def sync(self, key: str):
        self.run_once()

    # -- the RunOnce loop ------------------------------------------------------

    def run_once(self) -> Dict[str, int]:
        """One autoscaler pass (reference StaticAutoscaler.RunOnce):
        scale-up first; scale-down only on passes that didn't expand —
        removing capacity while pods are pending would churn."""
        out = {"scaled_up": 0, "scaled_down": 0}
        ng = self.cloud.node_groups() if self.cloud is not None else None
        if ng is None or self.scheduler is None:
            return out
        out["scaled_up"] = self._scale_up(ng)
        if out["scaled_up"] == 0:
            out["scaled_down"] = self._scale_down(ng)
        return out

    def _simulate_backend(self, has_ipa: bool) -> str:
        """What-if execution backend: the numpy host twin while the
        scheduler's device-path breaker is open (a tripped runtime must
        not be dispatched to — the what-if would fail, log, and skip the
        resize every pass), the device otherwise. has_ipa shadows still
        attempt the device, as the reference's do (a failure is caught
        and the pass skipped)."""
        from ..sched.breaker import OPEN

        sched = self.scheduler
        if (not has_ipa and sched is not None
                and getattr(sched, "breaker", None) is not None
                and sched.breaker.state == OPEN):
            return "host"
        return "device"

    # -- scale-up --------------------------------------------------------------

    def _eligible_groups(self, ng, now: float) -> List[NodeGroup]:
        out = []
        for g in ng.groups():
            if g.target_size >= g.max_size:
                continue
            if now < self._cooldown_until.get(g.name, 0.0):
                continue
            if now < self._retry_at.get(g.name, 0.0):
                continue
            out.append(g)
        return out

    def _scale_up(self, ng) -> int:
        now = self.clock()
        sched = self.scheduler
        pending = [p for p in sched.pending_unschedulable()
                   if not PodFeaturizer.needs_host_path(p)]
        if not pending:
            return 0
        pending = pending[:self.max_pods_per_pass]
        groups = self._eligible_groups(ng, now)
        if not groups:
            return 0
        try:
            # under the scheduler lock: a consistent cache view and the
            # shared-vocab interning serialized against live waves; the
            # device pass itself runs after release (scratch tensors
            # only — a first-compile must not stall scheduling)
            with sched._mu:
                virtual: List = []
                vgroups: List[NodeGroup] = []
                for g in groups:
                    k = min(g.max_size - g.target_size,
                            self.max_virtual_per_group, len(pending))
                    infos = simulate.virtual_node_infos(g, k)
                    virtual.extend(infos)
                    vgroups.extend([g] * k)
                shadow, n_real = simulate.shadow_snapshot(
                    sched.cache, sched.snapshot, virtual=virtual)
                feat = sched.shadow_featurizer(shadow)
                pb = feat.featurize(pending)
                has_ipa = bool(shadow.has_affinity_terms
                               or pb.ra_has.any() or pb.rn_has.any()
                               or (pb.pa_w != 0).any())
            verdict = simulate.simulate_placements(
                shadow, pb, weights=sched.profile.weights(),
                num_zones=shadow.caps.Z,
                num_label_values=shadow.num_label_values,
                has_ipa=has_ipa,
                backend=self._simulate_backend(has_ipa),
                device=sched.device)
        except Exception as e:
            if self.metrics is not None:
                self.metrics.scheduling_errors.labels(
                    stage="autoscaler").inc()
            LOG.error("scale-up simulation failed: %s: %s",
                      type(e).__name__, e, exc_info=e)
            return 0
        verdict = verdict._replace(n_real=n_real)
        self.last_verdict = verdict
        # demand: pods the scan packed onto virtual rows AND for which
        # no real row is even statically feasible — a pod with a real
        # home (just parked in backoff) must not buy new machines
        helped: Dict[str, List[api.Pod]] = {}
        rows_used: Dict[str, Set[int]] = {}
        for i, pod in enumerate(pending):
            row = int(verdict.chosen[i])
            if row < n_real:
                continue
            if verdict.feasible[i, :n_real].any():
                continue
            g = vgroups[row - n_real]
            helped.setdefault(g.name, []).append(pod)
            rows_used.setdefault(g.name, set()).add(row)
        options = [(g, len(helped.get(g.name, ())),
                    len(rows_used.get(g.name, ())))
                   for g in groups]
        pick = pick_expansion(options)
        if pick is None:
            return 0
        group, need = pick
        try:
            new_names = ng.increase_size(group.name, need)
        except Exception as e:
            # the failed call mutated nothing; the group backs off so a
            # flapping cloud API can't be hammered into a double resize
            self._retry_at[group.name] = now + self.backoff.bump(
                "scaleup:" + group.name)
            if self.metrics is not None:
                self.metrics.scheduling_errors.labels(
                    stage="autoscaler").inc()
            LOG.error("increase_size(%s, %d) failed: %s: %s",
                      group.name, need, type(e).__name__, e)
            return 0
        self.backoff.clear("scaleup:" + group.name)
        self._cooldown_until[group.name] = now + self.scale_up_cooldown
        self.last_scale_up = (group.name, need, new_names)
        if self.metrics is not None:
            self.metrics.autoscaler_scale_ups.inc(need)
        for pod in helped[group.name]:
            self.recorder.event(
                pod, "Normal", "TriggeredScaleUp",
                f"pod triggered scale-up: [{group.name} "
                f"{group.target_size - need}->{group.target_size}]")
        LOG.info("scaled up group %s by %d (pods helped: %d)",
                 group.name, need, len(helped[group.name]))
        return need

    # -- scale-down ------------------------------------------------------------

    def _abort_drain(self, name: str) -> None:
        """Cancel an in-progress scale-down: clear the durable drain
        intent and uncordon so the node returns to service instead of
        sitting cordoned forever and (via the draining-first resume
        rule) shadowing every other candidate. No-op for a node this
        controller never cordoned."""
        self._draining.discard(name)
        node = (self.store.get("nodes", "default", name)
                or self.store.get("nodes", "", name))
        if node is None:
            return
        ann = node.metadata.annotations or {}
        if ANN_SCALE_DOWN not in ann:
            return  # not our cordon (or never cordoned): hands off
        ann.pop(ANN_SCALE_DOWN, None)
        node.spec.unschedulable = False
        self.store.update("nodes", node)
        LOG.info("aborted scale-down of node %s (conditions changed "
                 "since the cordon); node uncordoned", name)

    @staticmethod
    def node_utilization(snapshot, idx: Optional[int]) -> float:
        """max(cpu, memory) requested/allocatable straight from the
        snapshot's resource tensors — no host-cache walk."""
        if idx is None:
            return 0.0
        alloc = snapshot.alloc[idx]
        req = snapshot.requested[idx]
        out = 0.0
        for col in (enc.RES_CPU, enc.RES_MEM):
            if alloc[col] > 0:
                out = max(out, float(req[col]) / float(alloc[col]))
        return out

    def _scale_down(self, ng) -> int:
        now = self.clock()
        sched = self.scheduler
        groups_by_type = {g.instance_type: g for g in ng.groups()}
        pdbs = list(self.store.list("poddisruptionbudgets"))
        cand = None
        sim_args = None
        # under the scheduler lock: the candidate scan over a consistent
        # cache view, the shadow build, and the featurize (shared-vocab
        # interning must serialize with live waves). The device pass
        # itself runs AFTER release — it only touches scratch tensors,
        # and its first-compile-per-shape cost must not stall scheduling.
        with sched._mu:
            live = sched.snapshot
            for name, ni in sched.cache.node_infos.items():
                node = ni.node
                if node is None:
                    continue
                g = groups_by_type.get(
                    (node.metadata.labels or {}).get(LABEL_INSTANCE_TYPE, ""))
                if g is None:
                    continue  # not an autoscaled node
                # drain intent is durable (the node annotation) so a
                # restart mid-drain resumes instead of orphaning a
                # cordoned node behind the hands-off rule below
                draining = (name in self._draining
                            or ANN_SCALE_DOWN in (node.metadata.annotations
                                                  or {}))
                if node.spec.unschedulable and not draining:
                    continue  # someone else's cordon: hands off
                if now < self._retry_at.get(g.name, 0.0):
                    continue
                util = self.node_utilization(live, live.node_index.get(name))
                residents = [p for p in ni.pods
                             if p.metadata.deletion_timestamp is None]
                if not draining:
                    if g.target_size <= g.min_size:
                        continue
                    if now < self._cooldown_until.get(g.name, 0.0):
                        continue  # post-resize settle window
                    if util >= self.utilization_threshold:
                        continue
                    # only replicated pods survive a drain delete (their
                    # controller recreates them) — a bare pod pins the
                    # node (reference drain.GetPodsForDeletion)
                    if any(not _replicated(p) for p in residents):
                        continue
                    # the drain deletes every resident at once: any pod
                    # whose PDB has no disruptions left pins the node
                    violating, _ok = _pods_violating_pdb(residents, pdbs)
                    if violating:
                        continue
                if any(PodFeaturizer.needs_host_path(p) for p in residents):
                    continue  # can't prove the refit on device: keep it
                if cand is None or util < cand[0] or draining:
                    cand = (util, name, g, residents)
                    if draining:
                        break  # finish an interrupted drain first
            if cand is None:
                return 0
            util, name, g, residents = cand
            if residents:
                try:
                    shadow, _ = simulate.shadow_snapshot(
                        sched.cache, live, exclude={name})
                    feat = sched.shadow_featurizer(shadow)
                    free = [simulate.strip_node_name(p) for p in residents]
                    pb = feat.featurize(free)
                    has_ipa = bool(shadow.has_affinity_terms
                                   or pb.ra_has.any() or pb.rn_has.any()
                                   or (pb.pa_w != 0).any())
                    sim_args = (shadow, pb, has_ipa)
                except Exception as e:
                    if self.metrics is not None:
                        self.metrics.scheduling_errors.labels(
                            stage="autoscaler").inc()
                    LOG.error("scale-down featurization failed: %s: %s",
                              type(e).__name__, e, exc_info=e)
                    return 0
        if sim_args is not None:
            # joint re-placement proof on the remaining cluster, outside
            # the scheduler lock (scratch tensors only)
            shadow, pb, has_ipa = sim_args
            try:
                ok, _chosen = simulate.simulate_refit(
                    shadow, pb, len(residents),
                    weights=sched.profile.weights(),
                    num_zones=shadow.caps.Z,
                    num_label_values=shadow.num_label_values,
                    has_ipa=has_ipa,
                    backend=self._simulate_backend(has_ipa),
                    device=sched.device)
            except Exception as e:
                if self.metrics is not None:
                    self.metrics.scheduling_errors.labels(
                        stage="autoscaler").inc()
                LOG.error("scale-down simulation failed: %s: %s",
                          type(e).__name__, e, exc_info=e)
                return 0
            if not ok:
                # residents can't all re-fit: the node stays. A RESUMED
                # drain failing this proof (capacity shrank since the
                # cordon) must abort — leaving the annotation would
                # re-select this node every pass (starving other
                # candidates) and hold it cordoned forever.
                self._abort_drain(name)
                return 0
        # a resumed drain must re-check the min floor — the group may
        # have shrunk below it since the cordon (another drain landed)
        if g.target_size - 1 < g.min_size:
            self._abort_drain(name)
            return 0
        # API mutations OUTSIDE the scheduler lock: the informer fan-out
        # of each write re-enters the scheduler's handlers
        node = (self.store.get("nodes", "default", name)
                or self.store.get("nodes", "", name))
        if node is None:
            self._draining.discard(name)
            return 0
        if not node.spec.unschedulable:
            node.spec.unschedulable = True  # cordon: SchedulingDisabled
            node.metadata.annotations[ANN_SCALE_DOWN] = "true"
            self.store.update("nodes", node)
        self._draining.add(name)
        # the refit ran BEFORE the cordon landed: a concurrent wave may
        # have bound new pods to the still-schedulable node in that
        # window. Re-read residents now that the cordon stops further
        # binds — any newcomer was never part of the proof, so the drain
        # aborts (uncordon) rather than orphan it onto a deleted node.
        with sched._mu:
            ni_now = sched.cache.node_infos.get(name)
            now_res = ([p for p in ni_now.pods
                        if p.metadata.deletion_timestamp is None]
                       if ni_now is not None else [])
        proved = {p.uid for p in residents}
        if any(p.uid not in proved for p in now_res):
            self._abort_drain(name)
            return 0
        for p in residents:
            try:
                self.store.delete("pods", p.namespace, p.metadata.name)
            except KeyError:
                pass  # already gone
        try:
            ng.delete_nodes(g.name, [name])
        except Exception as e:
            # consistent failure mode: the node stays cordoned + present
            # (no orphan snapshot rows — the Node object still backs its
            # row) and the drain resumes after the group's backoff
            self._retry_at[g.name] = now + self.backoff.bump(
                "scaledown:" + g.name)
            if self.metrics is not None:
                self.metrics.scheduling_errors.labels(
                    stage="autoscaler").inc()
            LOG.error("delete_nodes(%s, [%s]) failed: %s: %s",
                      g.name, name, type(e).__name__, e)
            return 0
        self.backoff.clear("scaledown:" + g.name)
        try:
            self.store.delete("nodes", node.metadata.namespace, name)
        except KeyError:
            pass
        self._draining.discard(name)
        self._cooldown_until[g.name] = now + self.scale_down_cooldown
        self.last_scale_down = name
        if self.metrics is not None:
            self.metrics.autoscaler_scale_downs.inc()
        self.recorder.event(
            node, "Normal", "ScaleDown",
            f"node removed by cluster autoscaler "
            f"(utilization {util:.2f} < {self.utilization_threshold:.2f})")
        LOG.info("scaled down: removed node %s from group %s "
                 "(utilization %.2f)", name, g.name, util)
        return 1
