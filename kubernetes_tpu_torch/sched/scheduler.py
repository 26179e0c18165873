"""The scheduler: watch, queue, device rounds, gangs, preemption, commit.

A lean counterpart of the JAX package's Scheduler
(kubernetes_tpu/sched/scheduler.py), its device calls ported.
`schedule_pending` follows the JAX loop (:1213-1271): it runs the
device-resident pipeline (`_schedule_pipelined`) and runs it again after
progress — placements, or preemptions the pipeline performed — and when
a pass makes none it switches to the per-wave loop (`run_once`) for the
rest of the drain. A pipeline pass

  1. pops the whole backlog (sched/queue.py `pop_wave`, which never
     splits a gang);
  2. places each gang all-or-nothing, one device dispatch a gang
     (ops/gang.py `schedule_gang`, the taint/host-port kernel launched
     once), committing it through a group-wide exact recheck; a gang
     that fails parks as a unit with one shared backoff and preempts;
  3. runs one device round over the other pods (`_run_pipeline`:
     featurize in numpy, upload the snapshot, ops/kernel.py
     `schedule_round` with the taint/port kernel launched once, one
     fetch of `chosen`, exact int64 recheck, assume and bind);
  4. preempts for the round's failures in chunks of `wave_size`
     (`_pipeline_preempt`): one what-if launch a chunk (ops/preempt.py,
     the kernel csrc/preempt_whatif.cu, and the taint/port kernel for
     its static masks), then the exact victim selection on the first
     PREEMPT_HOST_CANDIDATES ranked nodes (sched/preemption.py), and
     the evictions.

The per-wave loop (`_run_wave`) schedules one wave and attributes each
failure (`_handle_failure`): a FitError on the pod, host preemption
(sched/preemption.py `preempt`), and a park with backoff
(utils/backoff.py `PodBackoff`, on the scheduler's `clock`).

Pods whose required pod (anti-)affinity terms of one kind span more than
one topology key cannot be encoded for the device (ops/affinity.py
keeps one topology key a term group). The pipeline, the per-wave loop
and the gang path send them through the exact host path
(`_schedule_host_batch`, kubernetes_tpu/sched/scheduler.py:3334): one
pod at a time over plugins/golden.py's predicates, the profile's host
filters, the golden scores and the profile's host scores, host
preemption on failure. Its cost is O(nodes x bound
pods) a pod (the golden anchor scan). Gang members take it one at a
time, without atomicity, as in the JAX package.

`device_preemption = False` (the JAX scheduler's attribute of the same
name) sends the batched what-if of `_pipeline_preempt` through the numpy
twin (ops/preempt.py `preemption_stats_host`) instead of the what-if
kernel; the rounds still run on the device. It is a switch the caller
sets: with it True, a failing what-if raises.

Pods are ordered by (-priority, arrival seq), as the JAX scheduling
queue orders them. A round places at most PIPELINE_MAX_WAVES waves of
`wave_size` pods (PIPELINE_MAX_WAVES_IPA when inter-pod affinity is in
play anywhere); the rest go back to the queue before the round runs.

`metrics` (utils/metrics.py, a plain attribute a caller may replace)
takes the JAX scheduler's observations on the paths the port has: pod
and e2e scheduling latency, binding latency, pods scheduled and failed,
schedule attempts, waves by path, unschedulable reasons, preemption
attempts, evaluation time and victims, gang attempts and wait, and bind
errors. `warm_pipeline` runs one round without a fetch, outside a
measured window.

The profile (plugins/registry.py `Profile`; `default_profile(store)`
unless one is given, or one built from a Policy file by
`Registry.profile_from_policy`) supplies the weights, the scheduler
name, the preemption switch and the host plugins. Its host filters
(NoDiskConflict and the volume predicates of plugins/volumes.py, or a
Policy's own) run on the host before each per-wave and gang dispatch
(`_host_plugin_mask`, through the equivalence cache of
sched/equivalence.py when the EnableEquivalenceClassCache gate is on)
and reach the device as its `extra` mask; its host scores as the
pre-weighted `extra_scores` (`_host_score_matrix`). A pipeline pass
whose wave needs either hands its whole backlog to the per-wave loop,
and a profile with host scores skips the pipeline, as the JAX scheduler
does. With the VolumeScheduling gate on, a commit binds the pod's
unbound claims first (sched/volume_binder.py) and a failed bind or a
rolled-back gang unbinds them.

Left out with no stand-in: the circuit breakers, the bind journal and
the reconciler's retries, extenders (a profile with extenders raises
NotImplementedError), tracing, the mesh, the memory governor, poison
quarantine and load shedding; the series of that machinery (breaker,
store, mesh, HBM, shedding, poison, spool) stay at zero in `metrics`.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import labels as lbl
from ..api import types as api
from ..ops import encoding as enc
from ..ops.gang import schedule_gang
from ..ops.kernel import schedule_round, schedule_wave
from ..ops.preempt import (PreemptStats, preemption_stats,
                           preemption_stats_host, victim_levels)
from ..ops.scores import W_INTERPOD, stack_weights
from ..ops.taint_ports import taint_ports_masks
from ..plugins import golden
from ..plugins.registry import Profile, default_profile
from ..runtime.store import ADDED, DELETED, MODIFIED, Conflict, Event, ObjectStore
from ..state.cache import SchedulerCache
from ..state.featurize import PodFeaturizer
from ..state.snapshot import Snapshot
from ..utils.backoff import PodBackoff
from ..utils.feature_gates import FeatureGates
from ..utils.metrics import Metrics, bounded_label
from .equivalence import EquivalenceCache, equivalence_class
from .errors import REASON_KEYS, REASONS, FitError, insufficient_resource_reason
from .gang import GangDirectory
from .preemption import (GangGuard, PreemptionResult,
                         get_lower_priority_nominated_pods,
                         pod_eligible_to_preempt_others, pick_one_node,
                         preempt, select_victims_on_node)
from .queue import SchedulingQueue
from .volume_binder import VolumeBinder

# Max chained waves per device-resident round; rounds are bucketed per
# power-of-two wave count (a fixed W would make small rounds pay for 128
# waves). Longer backlogs run multiple rounds. A round with inter-pod
# affinity anywhere (bound or pending) is capped lower, as the JAX
# scheduler caps it: the placements depend on where each round ends.
PIPELINE_MAX_WAVES = 128
PIPELINE_MAX_WAVES_IPA = 64
# batched preemption: candidate priority levels of the what-if, and the
# exact victim validations a failed pod gets (its top-ranked nodes)
PREEMPT_LEVELS = 8
PREEMPT_HOST_CANDIDATES = 8


def pipeline_bucket(n_waves: int, lo: int = 4,
                    hi: int = PIPELINE_MAX_WAVES) -> int:
    """Smallest power-of-two wave-count >= n_waves (ceiling at hi) — the
    W of the round."""
    b = lo
    while b < n_waves and b < hi:
        b *= 2
    return b


def assemble_round(pbs, waves, pm_rows_all, term_rows_all, wbucket, tpp):
    """Stack per-wave PodBatches + staged row ids into the fixed-shape
    inputs of ops.kernel.schedule_round: batches padded to the bucket
    with zeroed (valid=False) waves, row ids padded with -1."""
    P = pbs[0].req.shape[0]
    pad_pb = enc.PodBatch(*[np.zeros_like(a) for a in pbs[0]])
    pbs_padded = list(pbs) + [pad_pb] * (wbucket - len(pbs))
    pbs_stacked = enc.PodBatch(*[np.stack(arrs)
                                 for arrs in zip(*pbs_padded)])
    pm_rows = np.full((wbucket, P), -1, np.int32)
    term_rows = np.full((wbucket, P, tpp), -1, np.int32)
    cursor = 0
    for wi, wv in enumerate(waves):
        n = len(wv)
        pm_rows[wi, :n] = pm_rows_all[cursor:cursor + n]
        term_rows[wi, :n] = term_rows_all[cursor:cursor + n]
        cursor += n
    return pbs_stacked, pm_rows, term_rows


class GroupLister:
    """Selectors of services/RCs/RSs/StatefulSets that select a pod
    (reference: priorities metadata getSelectors,
    algorithm/priorities/metadata.go + selector_spreading.go:230)."""

    def __init__(self, store: ObjectStore):
        self.store = store

    def __call__(self, pod: api.Pod) -> List[lbl.Selector]:
        out: List[lbl.Selector] = []
        for svc in self.store.list("services", pod.namespace):
            if svc.selector and lbl.Selector.from_set(svc.selector).matches(pod.metadata.labels):
                out.append(lbl.Selector.from_set(svc.selector))
        for rc in self.store.list("replicationcontrollers", pod.namespace):
            if rc.selector and lbl.Selector.from_set(rc.selector).matches(pod.metadata.labels):
                out.append(lbl.Selector.from_set(rc.selector))
        for rs in self.store.list("replicasets", pod.namespace):
            if rs.selector is not None:
                sel = rs.selector.to_selector()
                if sel.requirements and sel.matches(pod.metadata.labels):
                    out.append(sel)
        for ss in self.store.list("statefulsets", pod.namespace):
            if ss.selector is not None:
                sel = ss.selector.to_selector()
                if sel.requirements and sel.matches(pod.metadata.labels):
                    out.append(sel)
        return out


def _pod_has_ipa_terms(pod: api.Pod) -> bool:
    aff = pod.spec.affinity
    return aff is not None and (aff.pod_affinity is not None
                                or aff.pod_anti_affinity is not None)


class Scheduler:
    """Watches `store` for nodes, pods and PodGroups and schedules pending
    pods on `device` (None: the CUDA card; raises where there is none).
    `clock` drives backoff deadlines and assumed-pod expiry; `backoff`
    (default PodBackoff(clock=clock)) may also be replaced as an
    attribute, as the JAX scheduler's is, and so may `metrics` and
    `device_preemption`. `profile` (default `default_profile(store)`)
    and `features` (default FeatureGates()) are the JAX scheduler's
    arguments of the same names; disable_preemption=True turns
    preemption off as the profile's switch of the same name does."""

    # idle backoff entries are swept on this cadence (2x the backoff
    # ceiling matches the reference Gc()'s retention window)
    BACKOFF_GC_PERIOD = 120.0

    def __init__(self, store: ObjectStore, wave_size: int = 128,
                 caps: Optional[enc.Caps] = None, device=None,
                 clock=time.monotonic, backoff: Optional[PodBackoff] = None,
                 disable_preemption: bool = False,
                 profile: Optional[Profile] = None,
                 features: Optional[FeatureGates] = None):
        self.device = enc.resolve_device(device)
        self.store = store
        self.profile = profile or default_profile(store)
        if self.profile.extenders:
            raise NotImplementedError(
                "a profile with extenders needs the HTTP extenders, a later "
                "slice of the port")
        self.wave_size = wave_size
        self.features = features or FeatureGates()
        self.clock = clock
        self._disable_preemption = disable_preemption
        # the profile's weights: with no weightprofiles object, the JAX
        # WeightBook's dispatch view is these gating weights and their
        # stacked vector
        self.weights = self.profile.weights()
        # guards cache + snapshot against concurrent informer delivery;
        # RLock: the in-process store delivers bind events re-entrantly
        # on the committing thread
        self._mu = threading.RLock()
        self.cache = SchedulerCache(clock=clock)
        self.snapshot = Snapshot(caps=caps)
        self.featurizer = PodFeaturizer(self.snapshot, GroupLister(store))
        self.metrics = Metrics()
        self.queue = SchedulingQueue(
            clock=clock,
            pod_priority_enabled=self.features.enabled("PodPriority"))
        self.queue.on_gang_released = self._gang_released
        # gang (PodGroup) coscheduling: the queue parks incomplete gangs
        # and the pipeline routes complete ones through ops/gang.py
        self.gangs = GangDirectory(store)
        self.queue.gang_lookup = self.gangs.lookup
        self.backoff = backoff if backoff is not None else PodBackoff(
            clock=clock)
        self._next_backoff_gc = 0.0
        # preemptions performed by the batched pipeline path;
        # device_preemption=False sends the batched what-if through the
        # numpy twin instead of the what-if kernel
        self.pipeline_preemptions = 0
        self.device_preemption = True
        # the host plugins' caches: the equivalence cache (gated), the
        # claim binder, and the first-failing host filter per (pod, node)
        # of the last host mask, for FitError and preemption
        self.ecache = (EquivalenceCache()
                       if self.features.enabled("EnableEquivalenceClassCache")
                       else None)
        self.volume_binder = VolumeBinder(store)
        self._wave_host_fails: Dict[int, Dict[str, str]] = {}
        self._rr: Optional[torch.Tensor] = None  # round-robin counter
        self._last_path: Optional[str] = None
        self._wire()

    @property
    def disable_preemption(self) -> bool:
        """Preemption off: the constructor's switch, the profile's, or the
        PodPriority gate off."""
        return (self._disable_preemption or self.profile.disable_preemption
                or not self.features.enabled("PodPriority"))

    # -- watch handlers (reference: factory.go:191-295) -----------------------

    def _wire(self) -> None:
        self.store.watch("nodes", self._on_node_event)
        self.store.watch("pods", self._on_pod_event)
        for kind in ("services", "replicationcontrollers", "replicasets",
                     "statefulsets"):
            self.store.watch(kind, lambda ev: self._invalidate_features())
        # a PodGroup created/updated AFTER its pods may complete a gang
        # that was parked against a higher annotation-derived minMember
        self.store.watch("podgroups", self._on_podgroup_event)
        if self.ecache is not None:
            # targeted invalidation (kubernetes_tpu/sched/scheduler.py:
            # 564-577), under _mu so it never interleaves with a wave's
            # lookups and updates
            for kind in ("persistentvolumes", "persistentvolumeclaims"):
                self.store.watch(kind, self._on_volume_event)
            self.store.watch("services", self._on_service_event)
        # objects already in the store: nodes first, so their pods' rows
        # land against present node rows
        for node in self.store.list("nodes"):
            self._on_node_add(node)
        for pod in self.store.list("pods"):
            self._on_pod_add(pod)
        if self.store.list("podgroups"):
            self.queue.gang_reevaluate()

    def _on_node_event(self, ev: Event) -> None:
        if ev.type == DELETED:
            self._on_node_delete(ev.obj)
        else:
            self._on_node_add(ev.obj)

    def _on_pod_event(self, ev: Event) -> None:
        if ev.type == ADDED:
            self._on_pod_add(ev.obj)
        elif ev.type == MODIFIED:
            self._on_pod_update(ev.old if ev.old is not None else ev.obj,
                                ev.obj)
        elif ev.type == DELETED:
            self._on_pod_delete(ev.obj)

    def _on_podgroup_event(self, ev: Event) -> None:
        if ev.type in (ADDED, MODIFIED):
            self.queue.gang_reevaluate()

    def _on_volume_event(self, ev: Event) -> None:
        with self._mu:
            self.ecache.on_volume_event()

    def _on_service_event(self, ev: Event) -> None:
        with self._mu:
            self.ecache.on_service_event()

    def _responsible(self, pod: api.Pod) -> bool:
        return pod.spec.scheduler_name == self.profile.scheduler_name

    def _on_pod_add(self, pod: api.Pod) -> None:
        with self._mu:
            if pod.spec.node_name:
                if self.ecache is not None:
                    self.ecache.on_assigned_pod_event(pod.spec.node_name)
                self.cache.add_pod(pod)
                ni = self.cache.node_infos.get(pod.spec.node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.add_pod(pod)
                self.queue.assigned_pod_added(pod)
            elif self._responsible(pod) and pod.status.phase in ("", "Pending"):
                self.queue.add(pod)

    def _on_pod_update(self, old: api.Pod, new: api.Pod) -> None:
        with self._mu:
            if new.spec.node_name:
                if self.ecache is not None:
                    self.ecache.on_assigned_pod_event(new.spec.node_name)
                if old.spec.node_name:
                    self.cache.update_pod(old, new)
                else:
                    self.cache.add_pod(new)  # bind confirmation
                ni = self.cache.node_infos.get(new.spec.node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.add_pod(new)
                self.queue.assigned_pod_added(new)
            elif self._responsible(new):
                self.queue.update(old, new)

    def _on_pod_delete(self, pod: api.Pod) -> None:
        with self._mu:
            if pod.spec.node_name:
                if self.ecache is not None:
                    self.ecache.on_assigned_pod_event(pod.spec.node_name)
                self.cache.remove_pod(pod)
                ni = self.cache.node_infos.get(pod.spec.node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.remove_pod(pod)
                # a BOUND gang member leaving must shrink its gang's
                # member count, or a stale uid would open the admission
                # gate for a sub-minMember gang
                self.queue.gang_forget(pod)
                self.queue.move_all_to_active()
            else:
                self.queue.delete(pod)

    def _on_node_add(self, node: api.Node) -> None:
        with self._mu:
            if self.ecache is not None:
                self.ecache.on_node_event(node.name)
            self.cache.add_node(node)
            self.snapshot.set_node(self.cache.node_infos[node.name])
            self.queue.move_all_to_active()

    def _on_node_delete(self, node: api.Node) -> None:
        with self._mu:
            if self.ecache is not None:
                self.ecache.on_node_event(node.name)
            self.cache.remove_node(node)
            self.snapshot.remove_node(node.name)

    def _invalidate_features(self) -> None:
        # group membership may have changed -> equivalence rows are stale
        self.featurizer._cache.clear()

    # -- introspection ----------------------------------------------------------

    def pending_count(self) -> int:
        """Pods pending in any area of the queue (active, backoff,
        unschedulable, gang waiting)."""
        return self.queue.pending_count()

    def unschedulable_pods(self) -> List[api.Pod]:
        return self.queue.unschedulable_pods()

    def wave_path(self) -> str:
        """What the most recent device program ran: 'cuda' when the
        taint/port kernel launched, 'torch-cpu' on the CPU, 'unresolved'
        before any."""
        return self._last_path or "unresolved"

    def _note_path(self, launches0: int) -> None:
        self._last_path = ("cuda" if taint_ports_masks.launches > launches0
                           else "torch-cpu")

    def _weight_vec(self) -> torch.Tensor:
        return enc.weight_vec_to_torch(stack_weights(self.weights),
                                       self.device)

    # -- metrics (kubernetes_tpu/sched/scheduler.py:851, :1165) -----------------

    def _gang_released(self, key: str, waited: float) -> None:
        self.metrics.gang_wait_seconds.observe(waited)

    def _count_unschedulable(self, err: FitError) -> None:
        """scheduler_unschedulable_reasons_total{predicate}: one increment
        per (failed pod, first-fail predicate); free-text reasons bucket
        into "Other"."""
        for reason, count in err.failed_predicates.items():
            if not count:
                continue
            if reason.startswith("Insufficient "):
                pred = "PodFitsResources"
            else:
                pred = bounded_label(REASON_KEYS.get(reason, reason),
                                     REASONS)
            self.metrics.unschedulable_reasons.labels(predicate=pred).inc()

    # -- the drain (kubernetes_tpu/sched/scheduler.py:1213) ----------------------

    def schedule_pending(self) -> int:
        """Run the pipeline until the active queue drains, falling back to
        the per-wave loop once a pipeline pass makes no progress. Returns
        pods placed (assumed + bound)."""
        placed = 0
        # host scores need per-wave host evaluation: the pipeline would
        # only hand the backlog back (kubernetes_tpu/sched/scheduler.py:
        # 1239-1245)
        allow_pipeline = not self.profile.host_scores
        while self.queue.active_count() > 0:
            if allow_pipeline:
                pre = self.pipeline_preemptions
                n = self._schedule_pipelined()
                placed += n
                if n > 0 or self.pipeline_preemptions > pre:
                    # preemptions are progress too: victims were evicted,
                    # and the survivors re-run the PIPELINE
                    continue
                # zero progress: the per-wave loop owns failure
                # attribution and host preemption for the rest of the
                # drain (re-attempting the pipeline before every wave
                # would re-pop the whole backlog each time)
                allow_pipeline = False
            placed += self.run_once()
        return placed

    def _housekeep(self) -> None:
        """Expire assumed pods and sweep idle backoff entries
        (PodBackoff.gc, reference backoff_utils.go Gc)."""
        with self._mu:
            self.cache.cleanup_expired()
        now = self.clock()
        if now >= self._next_backoff_gc:
            self._next_backoff_gc = now + self.BACKOFF_GC_PERIOD
            self.backoff.gc()

    def run_once(self) -> int:
        """Schedule one wave through the per-wave path. Returns the pods
        placed."""
        self._housekeep()
        pods = self.queue.pop_wave(self.wave_size)
        if not pods:
            return 0
        with self._mu:
            return self._run_wave(pods)

    def _schedule_pipelined(self) -> int:
        """One pipeline pass over the whole backlog: gangs first, one
        dispatch a gang, then one device round over the other pods
        (kubernetes_tpu/sched/scheduler.py:1399)."""
        self._housekeep()
        all_pods: List[api.Pod] = []
        while True:
            batch = self.queue.pop_wave(self.wave_size)
            if not batch:
                break
            all_pods.extend(batch)
        if not all_pods:
            return 0
        with self._mu:
            placed = 0
            # gangs bypass the device-resident round: their placements
            # must be all-or-nothing per group, which the round's
            # staged-commit carry can't express
            gang_pods = [p for p in all_pods if self.gangs.key(p) is not None]
            if gang_pods:
                all_pods = [p for p in all_pods
                            if self.gangs.key(p) is None]
                placed += self._schedule_gangs(gang_pods)
            # pods the device cannot encode take the exact host path
            host_path = [p for p in all_pods
                         if self.featurizer.needs_host_path(p)]
            pods = [p for p in all_pods
                    if not self.featurizer.needs_host_path(p)]
            placed += self._schedule_host_batch(host_path, rest=pods)
            if not pods:
                return placed
            return placed + self._run_pipeline(pods)

    def warm_pipeline(self, pods: List[api.Pod],
                      n_waves: Optional[int] = None) -> None:
        """Run the round program once for this cluster's shapes, without
        a fetch (kubernetes_tpu/sched/scheduler.py:1469), so that the
        device's lazy start-up and the kernels' first build land outside
        a measured window. n_waves picks the wave-count bucket (default:
        one wave). At most one wave of `pods` (host-path pods left out) is
        staged; every staged row is released again, the pods stay
        pending, and the queue and the round-robin counter are not
        touched."""
        with self._mu:
            pods = [p for p in pods
                    if not self.featurizer.needs_host_path(p)][:self.wave_size]
            if not pods:
                return
            self.featurizer.featurize(pods)
            pm_rows, term_rows = self.snapshot.stage_pending(pods)
            try:
                pb = self.featurizer.featurize(pods)
                dev = self.device
                nt, pm, tt = self.snapshot.to_device(dev)
                usage = (nt.requested, nt.nonzero, nt.pod_count)
                has_ipa = bool(self.snapshot.has_affinity_terms
                               or pb.ra_has.any() or pb.rn_has.any()
                               or (pb.pa_w != 0).any())
                wbucket = pipeline_bucket(
                    n_waves if n_waves is not None else 1,
                    hi=(PIPELINE_MAX_WAVES_IPA if has_ipa
                        else PIPELINE_MAX_WAVES))
                pbs_stacked, rows, trows = assemble_round(
                    [pb], [pods], pm_rows, term_rows, wbucket,
                    term_rows.shape[1])
                schedule_round(
                    nt, pm, tt,
                    enc.to_torch(None, None, None, pbs_stacked, dev)[3],
                    usage, torch.zeros((), dtype=torch.int32, device=dev),
                    torch.from_numpy(rows).to(dev),
                    torch.from_numpy(trows).to(dev),
                    weights=self.weights, num_zones=self.snapshot.caps.Z,
                    num_label_values=self.snapshot.num_label_values,
                    has_ipa=has_ipa, weight_vec=self._weight_vec())
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            finally:
                for p in pods:
                    self.snapshot.unstage(p)

    # -- the round -------------------------------------------------------------

    def _run_pipeline(self, pods: List[api.Pod]) -> int:
        """One device-resident round over `pods` (queue order); the pods
        it leaves unplaced go to batched preemption, and those it does
        not handle back to the queue. Returns pods placed."""
        start = self.clock()
        W = self.wave_size
        # ipa anywhere in the backlog (or already placed) caps the round
        # at the ipa wave count, even for ipa-free leading rounds
        max_waves = (PIPELINE_MAX_WAVES_IPA
                     if (self.snapshot.has_affinity_terms
                         or any(_pod_has_ipa_terms(p) for p in pods))
                     else PIPELINE_MAX_WAVES)
        waves = [pods[i:i + W] for i in range(0, len(pods), W)]
        if len(waves) > max_waves:
            # bound the round; the leftover goes back to the queue first
            keep = max_waves * W
            for p in pods[keep:]:
                self.queue.add_if_not_present(p)
            pods, waves = pods[:keep], waves[:max_waves]
        # pass 1 grows every vocab/cap to its final size; when it grew,
        # pass 2 re-emits every batch at the uniform final shapes
        sig0 = (self.featurizer.vocabs.version(),
                dataclasses.astuple(self.snapshot.caps))
        pbs = [self.featurizer.featurize(wv) for wv in waves]
        if (self.featurizer.vocabs.version(),
                dataclasses.astuple(self.snapshot.caps)) != sig0:
            pbs = [self.featurizer.featurize(wv) for wv in waves]
        for wv, pb in zip(waves, pbs):
            P = pb.req.shape[0]
            if (not self._host_plugin_mask(wv, P).all()
                    or self._host_score_matrix(wv, P) is not None):
                # a host filter rejects a node, or host scores are in
                # play: the per-wave loop evaluates them against fresh
                # state, so the whole pass goes back to the queue
                # (kubernetes_tpu/sched/scheduler.py:1670-1682)
                for p in pods:
                    self.queue.add_if_not_present(p)
                return 0
        pm_rows_all, term_rows_all = self.snapshot.stage_pending(pods)
        tpp = term_rows_all.shape[1]
        dev = self.device
        nt, pm, tt = self.snapshot.to_device(dev)
        usage = (nt.requested, nt.nonzero, nt.pod_count)
        if self._rr is None:
            self._rr = torch.zeros((), dtype=torch.int32, device=dev)
        # inter-pod affinity anywhere: bound pods' terms, or a required or
        # preferred term in any of the round's batches (host numpy)
        has_ipa = bool(self.snapshot.has_affinity_terms
                       or any(pb.ra_has.any() or pb.rn_has.any()
                              or (pb.pa_w != 0).any() for pb in pbs))
        wbucket = pipeline_bucket(len(waves), hi=max_waves)
        pbs_stacked, pm_rows, term_rows = assemble_round(
            pbs, waves, pm_rows_all, term_rows_all, wbucket, tpp)
        pbs_t = enc.to_torch(None, None, None, pbs_stacked, dev)[3]
        pm_rows_t = torch.from_numpy(pm_rows).to(dev)
        term_rows_t = torch.from_numpy(term_rows).to(dev)
        launches0 = taint_ports_masks.launches
        chosen_d, _fail, _usage_end, rr_end, _deco, fin_d = schedule_round(
            nt, pm, tt, pbs_t, usage, self._rr, pm_rows_t, term_rows_t,
            weights=self.weights, num_zones=self.snapshot.caps.Z,
            num_label_values=self.snapshot.num_label_values,
            has_ipa=has_ipa, weight_vec=self._weight_vec())
        # the round's one fetch: chosen and the sentinel together
        chosen_all = chosen_d.cpu().numpy()
        fin_all = fin_d.cpu().numpy()
        self._note_path(launches0)
        bad = [wv_pods[i].uid for wi, wv_pods in enumerate(waves)
               for i in range(len(wv_pods)) if not fin_all[wi, i]]
        if bad:
            # the featurizer rejects non-finite specs, so a non-finite
            # row here means corrupted inputs: discard the whole round
            for p in pods:
                self.snapshot.unstage(p)
                self.queue.add_if_not_present(p)
            raise FloatingPointError(
                f"numeric-integrity sentinel flagged pods {bad}")
        self._rr = rr_end
        placed = 0
        retry: List[api.Pod] = []
        for wi, wv_pods in enumerate(waves):
            for i, pod in enumerate(wv_pods):
                self.metrics.schedule_attempts.inc()
                node_idx = int(chosen_all[wi, i])
                if node_idx >= 0:
                    node_name = self.snapshot.node_names[node_idx]
                    if self._commit(pod, node_name):
                        placed += 1
                        continue
                # rejected by the exact recheck, or failed on the device:
                # batched preemption handles resource-starved failures;
                # everything else goes back through the queue
                self.snapshot.unstage(pod)
                retry.append(pod)
        handled = self._pipeline_preempt(retry) if retry else set()
        for pod in retry:
            if pod.uid not in handled:
                self.queue.add_if_not_present(pod)
        self.metrics.e2e_scheduling_latency.observe(self.clock() - start)
        self.metrics.waves_total.labels(path="device").inc(len(waves))
        return placed

    # -- batched preemption (kubernetes_tpu/sched/scheduler.py:1965) -----------

    def _pipeline_preempt(self, pods: List[api.Pod]) -> set:
        """Batched preemption for round failures: one what-if launch
        computes the stats for every failed pod x node of a chunk, then
        the host runs the exact victim selection and the tie-breaks on
        the few ranked candidates. Returns the uids handled (nominated +
        parked); the rest go back to the queue."""
        if self.disable_preemption:
            return set()
        cands = [p for p in pods
                 if pod_eligible_to_preempt_others(p, self.cache)]
        if not cands:
            return set()
        # chunk at wave_size; later chunks see earlier chunks' evictions
        # through the refreshed snapshot, and the claimed map spans chunks
        # so freed capacity is never double-counted
        handled: set = set()
        claimed: Dict[str, List[api.Pod]] = {}
        exhausted: Dict[str, int] = {}
        for i in range(0, len(cands), self.wave_size):
            handled |= self._preempt_chunk(cands[i:i + self.wave_size],
                                           claimed, exhausted)
        return handled

    def _preempt_gang_weights(self):
        """Victim-gang disruption weights for the what-if stats: 1 for
        placed members of gangs with no slack above minMember (any
        eviction breaks them). Returns (guard, f32 [M] weights or None)."""
        guard, placed_gangs, gang_mins = self._gang_state()
        if guard is None:
            return None, None
        w = np.zeros((self.snapshot.caps.M,), np.float32)
        for gkey, gmembers in placed_gangs.items():
            if len(gmembers) <= gang_mins[gkey]:
                for gp in gmembers:
                    slot = self.snapshot.pod_slot.get(gp.uid)
                    if slot is not None:
                        w[slot] = 1.0
        return guard, (w if w.any() else None)

    def _whatif(self, cands: List[api.Pod]):
        """The what-if of one preemption chunk: (packed [5, P, N] stats as
        numpy, the victim-gang guard), or (None, None) when nothing is
        evictable anywhere. On the device, or through the numpy twin when
        device_preemption is off."""
        pb = self.featurizer.featurize(cands)
        # candidate thresholds: distinct priorities of live existing pods
        # (+1 so "< level" removes that class); always keep the HIGHEST
        # so the remove-all-lower option survives the level cap
        live = self.snapshot.ep_valid & self.snapshot.ep_alive
        levels = victim_levels(self.snapshot.ep_prio, live, PREEMPT_LEVELS)
        if levels is None:
            return None, None
        # victim-gang awareness: the per-class segment sum ranks
        # gang-sparing nodes first; None for gang-free clusters
        guard, gang_w = self._preempt_gang_weights()
        if not self.device_preemption:
            nt_h, pm_h, _tt = self.snapshot.host_tensors()
            return preemption_stats_host(nt_h, pm_h, pb, levels,
                                         num_levels=PREEMPT_LEVELS,
                                         gang_w=gang_w), guard
        nt, pm, _tt = self.snapshot.to_device(self.device)
        pbt = enc.to_torch(None, None, None, pb, self.device)[3]
        packed = preemption_stats(nt, pm, pbt, levels,
                                  num_levels=PREEMPT_LEVELS, gang_w=gang_w)
        return packed.cpu().numpy(), guard  # ONE fetch for all planes

    def _preempt_chunk(self, cands: List[api.Pod],
                       claimed: Dict[str, List[api.Pod]],
                       exhausted: Dict[str, int]) -> set:
        t0 = self.clock()
        packed, guard = self._whatif(cands)
        if packed is None:
            return set()
        st = PreemptStats(packed)
        ok, victims_n = st.ok, st.victims
        psum, pmax = st.prio_sum, st.prio_max
        gviol = st.gang_viol
        pdbs = self._pdbs()
        handled: set = set()
        # `claimed` = capacity claimed by earlier pods in this batch (the
        # host analog of the reference's nominated-pod accounting):
        # without it, one freed node would absorb every later candidate's
        # validation and the batch would degenerate to one eviction a
        # round
        for i, pod in enumerate(cands):
            cand_nodes = np.nonzero(ok[i])[0]
            if cand_nodes.size == 0:
                continue
            self.metrics.total_preemption_attempts.inc()
            # the device ranking approximates the reference's tie-breaks
            # to pick the TOP-K; the exact criteria (PDB violations
            # included) re-rank the validated candidates below. Python's
            # stable sort over keys read once from the planes.
            keys = list(zip(gviol[i, cand_nodes].astype(float).tolist(),
                            pmax[i, cand_nodes].astype(float).tolist(),
                            psum[i, cand_nodes].astype(float).tolist(),
                            victims_n[i, cand_nodes].astype(float).tolist()))
            nodes = cand_nodes.tolist()
            order = [nodes[j] for j in sorted(range(len(nodes)),
                                              key=keys.__getitem__)]
            aff = pod.spec.affinity
            with_aff = bool(self.snapshot.has_affinity_terms
                            or (aff is not None
                                and (aff.pod_affinity is not None
                                     or aff.pod_anti_affinity is not None))
                            # spread's what-if reads cluster-wide domain
                            # counts through the view, like affinity
                            or golden.has_hard_spread(pod))
            node_infos = self.cache.node_infos if with_aff else None
            validated = {}
            tried = 0
            for n in order:
                if tried >= PREEMPT_HOST_CANDIDATES:
                    break
                name = self.snapshot.node_names[n]
                ni = self.cache.node_infos.get(name)
                if ni is None or ni.node is None:
                    continue
                # a node that already FAILED validation at (or below) its
                # current claim count can't absorb another preemptor —
                # skip it WITHOUT spending a validation slot
                if (name in exhausted
                        and len(claimed.get(name, ())) >= exhausted[name]):
                    continue
                tried += 1
                if claimed.get(name):
                    ni = ni.clone()
                    for cp in claimed[name]:
                        ni.add_pod(cp)
                sel = select_victims_on_node(pod, ni, pdbs, node_infos,
                                             self._host_extra_fit, guard)
                if sel is not None:
                    validated[name] = sel
                elif claimed.get(name):
                    # validation failures on an UNclaimed node are pod-
                    # specific (PDB, affinity) — don't block other pods
                    exhausted[name] = len(claimed[name])
            chosen = pick_one_node(validated)
            if chosen is None:
                continue
            victims, nviol = validated[chosen]
            claimed.setdefault(chosen, []).append(pod)
            if not victims:
                # an earlier eviction already freed this node: the pod
                # fits WITHOUT preempting — requeue and let the next
                # round place it (the claim above stops later batch
                # members from also counting on this capacity)
                continue
            self._perform_preemption(
                pod, PreemptionResult(chosen, victims, nviol))
            self._park_with_backoff(pod)
            self.pipeline_preemptions += 1
            handled.add(pod.uid)
        self.metrics.preemption_evaluation.observe(self.clock() - t0)
        return handled

    # -- the per-wave loop (kubernetes_tpu/sched/scheduler.py:3028) -------------

    def _run_wave(self, pods: List[api.Pod]) -> int:
        # gang members place through the all-or-nothing path; pop_wave
        # delivers gangs whole
        placed_gang = 0
        gang_pods = [p for p in pods if self.gangs.key(p) is not None]
        if gang_pods:
            pods = [p for p in pods if self.gangs.key(p) is None]
            placed_gang = self._schedule_gangs(gang_pods)
            if not pods:
                return placed_gang
        # pods whose required pod-(anti)affinity spans more than one
        # topology key take the exact host path
        host_path = [p for p in pods if self.featurizer.needs_host_path(p)]
        pods = [p for p in pods if not self.featurizer.needs_host_path(p)]
        placed_gang += self._schedule_host_batch(host_path, rest=pods)
        if not pods:
            return placed_gang
        start = self.clock()
        pb = self.featurizer.featurize(pods)
        P = pb.req.shape[0]
        extra = self._host_plugin_mask(pods, P)
        extra_scores = self._host_score_matrix(pods, P)
        dev = self.device
        nt, pm, tt = self.snapshot.to_device(dev)
        if self._rr is None:
            self._rr = torch.zeros((), dtype=torch.int32, device=dev)
        has_ipa = bool(self.snapshot.has_affinity_terms or pb.ra_has.any()
                       or pb.rn_has.any() or (pb.pa_w != 0).any())
        pbt = enc.to_torch(None, None, None, pb, dev)[3]
        # the host inputs go up in one copy each; a failed copy raises
        extra = torch.from_numpy(extra).to(dev)
        if extra_scores is not None:
            extra_scores = torch.from_numpy(extra_scores).to(dev)
        launches0 = taint_ports_masks.launches
        res = schedule_wave(nt, pm, tt, pbt, extra, self._rr, extra_scores,
                            weights=self.weights,
                            num_zones=self.snapshot.caps.Z,
                            num_label_values=self.snapshot.num_label_values,
                            has_ipa=has_ipa,
                            has_ts=bool(pb.ts_valid.any()),
                            weight_vec=self._weight_vec())
        chosen = res.chosen.cpu().numpy()
        fin = res.finite.cpu().numpy()
        self._note_path(launches0)
        bad = [pods[i].uid for i in range(len(pods)) if not fin[i]]
        if bad:
            for p in pods:
                self.queue.add_if_not_present(p)
            raise FloatingPointError(
                f"numeric-integrity sentinel flagged pods {bad}")
        self._rr = res.rr_end
        placed = 0
        fail_counts = masks = None
        for i, pod in enumerate(pods):
            self.metrics.schedule_attempts.inc()
            node_idx = int(chosen[i])
            if node_idx >= 0:
                node_name = self.snapshot.node_names[node_idx]
                if self._commit(pod, node_name):
                    placed += 1
                    continue
                # exact recheck lost a race with device f32 arithmetic:
                # retry next wave without counting it unschedulable
                self.queue.add_if_not_present(pod)
                continue
            if fail_counts is None:
                fail_counts = res.fail_counts.cpu().numpy()
                masks = res.masks.cpu().numpy()
            self._handle_failure(pod, i, fail_counts, masks)
        self.metrics.e2e_scheduling_latency.observe(self.clock() - start)
        self.metrics.waves_total.labels(path="device").inc()
        return placed + placed_gang

    # -- the exact host path (kubernetes_tpu/sched/scheduler.py:3334) -------------

    def _schedule_host_batch(self, pods: List[api.Pod],
                             rest: List[api.Pod] = ()) -> int:
        """The exact host path for `pods`, one pod at a time, over one
        ClusterView shared by the batch (it reads the live cache, so
        commits and evictions inside the loop stay visible). An
        infrastructure failure parks its pod with backoff and the batch
        goes on. Any other exception puts the pod that raised, the pods
        of the batch not yet tried and `rest` (the other pods its caller
        popped) back in the queue, and raises: the port has no poison
        quarantine, and drops no pod. Returns the pods placed."""
        if not pods:
            return 0
        view = golden.ClusterView(self.cache.node_infos)
        placed = 0
        for i, p in enumerate(pods):
            try:
                placed += self._schedule_host_path(p, view)
            except (OSError, TimeoutError, Conflict, KeyError) as e:
                # the golden pass also preempts and commits: a store
                # failure there is not the pod's fault
                self.metrics.scheduling_errors.labels(stage="bind").inc()
                logging.getLogger(__name__).error(
                    "golden pass failed on infrastructure, parking %s",
                    p.full_name(), exc_info=e)
                self._park_with_backoff(p)
            except Exception:
                for q in list(pods[i:]) + list(rest):
                    self.queue.add_if_not_present(q)
                raise
        return placed

    def _schedule_host_path(self, pod: api.Pod, view) -> int:
        """The exact one-pod pass over plugins/golden.py for a pod the
        round cannot encode (kubernetes_tpu/sched/scheduler.py:3408-3535):
        its predicates and the profile's host filters on every node, host
        preemption when none fits, else the golden scores plus the
        profile's host scores and a commit on the first best node.
        Returns 1 if it placed the pod."""
        self.metrics.schedule_attempts.inc()
        self.metrics.waves_total.labels(path="host").inc()
        feasible: List[str] = []
        reasons: Dict[str, int] = {}
        failed: Dict[str, List[str]] = {}
        for name, ni in self.cache.node_infos.items():
            ok, rs = golden.pod_fits_on_node(pod, ni, view=view)
            if ok:
                for fn in self.profile.host_filters.values():
                    if (getattr(fn, "relevant", None) is not None
                            and not fn.relevant(pod)):
                        continue
                    ok2, rs2 = fn(pod, ni)
                    if not ok2:
                        ok, rs = False, rs2
                        break
            if ok:
                feasible.append(name)
            else:
                for r in rs[:1]:
                    reasons[r] = reasons.get(r, 0) + 1
                failed[name] = rs[:1]
        if not feasible:
            self.metrics.pods_failed.inc()
            err = FitError(pod.full_name(), len(self.cache.node_infos),
                           reasons)
            self._count_unschedulable(err)
            if not self.disable_preemption:
                # reason strings back to predicate names for the
                # unresolvable filter
                fp = {n: [REASON_KEYS.get(r, r) for r in rs]
                      for n, rs in failed.items()}
                pr = preempt(pod, self.cache, fp, self._pdbs(),
                             with_affinity=True,
                             extra_fit=self._host_extra_fit,
                             gang_guard=self._gang_guard(),
                             snapshot=self.snapshot,
                             featurizer=self.featurizer)
                if pr is not None:
                    self._perform_preemption(pod, pr)
            self._park_with_backoff(pod)
            self.store.set_pod_condition(
                pod, ("PodScheduled", "False:" + err.message()))
            return 0
        # score: the golden interpod priority at the live interpod weight,
        # plus least-requested and balanced allocation at weight 1 and the
        # profile's weighted host scores; the first best node wins
        w_interpod = float(stack_weights(self.weights)[W_INTERPOD])
        ipa_scores = golden.interpod_affinity_priority(
            pod, [self.cache.node_infos[n] for n in feasible], view,
            hard_weight=int(self.weights.hard_pod_affinity))
        host_scores: Dict[str, float] = {}
        for fn, weight in self.profile.host_scores.values():
            for node, s in fn(pod, self.cache.node_infos).items():
                host_scores[node] = host_scores.get(node, 0.0) + weight * s
        best_name, best_score = None, None
        for name in feasible:
            ni = self.cache.node_infos[name]
            s = (w_interpod * ipa_scores.get(name, 0)
                 + golden.least_requested_map(pod, ni)
                 + golden.balanced_allocation_map(pod, ni)
                 + host_scores.get(name, 0.0))
            if best_score is None or s > best_score:
                best_name, best_score = name, s
        if best_name is not None and self._commit(pod, best_name):
            return 1
        self.queue.add_if_not_present(pod)
        return 0

    def _host_extra_fit(self, pod: api.Pod, ni) -> bool:
        """The profile's host filters as one fit check for preemption's
        what-if (kubernetes_tpu/sched/scheduler.py:4705: victim removal
        can resolve NoDiskConflict and the volume counts, so the
        simulation re-runs them)."""
        for fn in self.profile.host_filters.values():
            if getattr(fn, "relevant", None) is not None and not fn.relevant(pod):
                continue
            ok, _ = fn(pod, ni)
            if not ok:
                return False
        return True

    # -- host plugins (kubernetes_tpu/sched/scheduler.py:4646) -------------------

    def _host_plugin_mask(self, pods: List[api.Pod], P: int) -> np.ndarray:
        """bool [P, caps.N]: the profile's host filters for each pod on
        each node, a filter run only for the pods its `relevant(pod)`
        gate admits, each (pod, node) stopping at its first failure.
        Records that failure's predicate key per (pod index, node name)
        in `_wave_host_fails` for FitError and the preemption
        unresolvable filter. With the equivalence cache on, a (class,
        node, filter) result is looked up before it is computed and
        stored after."""
        N = self.snapshot.caps.N
        mask = np.ones((P, N), bool)
        self._wave_host_fails = {}
        if not self.profile.host_filters:
            return mask
        for i, pod in enumerate(pods):
            fails: Dict[str, str] = {}
            fns = [(pname, fn)
                   for pname, fn in self.profile.host_filters.items()
                   if getattr(fn, "relevant", None) is None
                   or fn.relevant(pod)]
            eclass = (equivalence_class(pod) if self.ecache is not None
                      else None)
            if fns:
                for name, ni_idx in self.snapshot.node_index.items():
                    ni = self.cache.node_infos.get(name)
                    if ni is None:
                        continue
                    for pname, fn in fns:
                        cached = (self.ecache.lookup(eclass, name, pname)
                                  if self.ecache is not None else None)
                        if cached is not None:
                            ok, rs = cached
                        else:
                            ok, rs = fn(pod, ni)
                            if self.ecache is not None:
                                self.ecache.update(eclass, name, pname, ok,
                                                   rs)
                        if not ok:
                            mask[i, ni_idx] = False
                            fails[name] = (REASON_KEYS.get(rs[0], pname)
                                           if rs else pname)
                            break
            if fails:
                self._wave_host_fails[i] = fails
        return mask

    def _host_score_matrix(self, pods: List[api.Pod],
                           P: int) -> Optional[np.ndarray]:
        """f32 [P, caps.N]: the profile's host scores, each weighted and
        added in the order of `host_scores`; None when it has none (the
        kernel's extra_scores input, kubernetes_tpu/sched/
        scheduler.py:4717)."""
        if not self.profile.host_scores:
            return None
        out = np.zeros((P, self.snapshot.caps.N), np.float32)
        idx = self.snapshot.node_index
        for i, pod in enumerate(pods):
            for fn, weight in self.profile.host_scores.values():
                for node, s in fn(pod, self.cache.node_infos).items():
                    j = idx.get(node)
                    if j is not None:
                        out[i, j] += weight * s
        return out

    # -- gangs (kubernetes_tpu/sched/scheduler.py:3537) ---------------------------

    def _schedule_gangs(self, pods: List[api.Pod]) -> int:
        """All-or-nothing placement of the gang pods, grouped by PodGroup
        and committed one group at a time, so the second gang's dispatch
        sees the first gang's assumed usage: two gangs contending for the
        same nodes never interleave partial placements."""
        groups: Dict[str, List[api.Pod]] = {}
        for p in pods:
            groups.setdefault(self.gangs.key(p), []).append(p)
        placed = 0
        for key, members in groups.items():
            self.metrics.gang_schedule_attempts.inc()
            self.metrics.schedule_attempts.inc(len(members))
            placed += self._schedule_one_gang_inner(key, members)
        return placed

    def _schedule_one_gang_inner(self, key: str,
                                 members: List[api.Pod]) -> int:
        min_member = self.gangs.min_member(members[0])
        bound = self.gangs.bound_count(self.cache, key,
                                       exclude={p.uid for p in members})
        # members already holding capacity count toward minMember: the
        # dispatch only needs to place the remainder
        need = max(min_member - bound, 0)
        # multi-topology-key required affinity can't be device-encoded;
        # such members take the exact host path one at a time: atomicity
        # is not offered for this combination
        host_path = [p for p in members if self.featurizer.needs_host_path(p)]
        members = [p for p in members
                   if not self.featurizer.needs_host_path(p)]
        placed = self._schedule_host_batch(host_path, rest=members)
        if not members:
            return placed
        pb = self.featurizer.featurize(members)
        P = pb.req.shape[0]
        extra = self._host_plugin_mask(members, P)
        extra_scores = self._host_score_matrix(members, P)
        dev = self.device
        nt, pm, tt = self.snapshot.to_device(dev)
        if self._rr is None:
            self._rr = torch.zeros((), dtype=torch.int32, device=dev)
        has_ipa = bool(self.snapshot.has_affinity_terms or pb.ra_has.any()
                       or pb.rn_has.any() or (pb.pa_w != 0).any())
        pbt = enc.to_torch(None, None, None, pb, dev)[3]
        # the host inputs go up in one copy each; a failed copy raises
        extra = torch.from_numpy(extra).to(dev)
        if extra_scores is not None:
            extra_scores = torch.from_numpy(extra_scores).to(dev)
        launches0 = taint_ports_masks.launches
        res = schedule_gang(
            nt, pm, tt, pbt, extra, self._rr, extra_scores,
            torch.tensor(need, dtype=torch.int32, device=dev),
            weights=self.weights, num_zones=self.snapshot.caps.Z,
            num_label_values=self.snapshot.num_label_values,
            has_ipa=has_ipa, weight_vec=self._weight_vec(),
            ts_valid_host=pb.ts_valid)
        # the dispatch's one fetch: chosen, ok, placed and finite together
        head = torch.cat([res.chosen, res.ok.to(torch.int32).reshape(1),
                          res.placed.reshape(1),
                          res.finite.to(torch.int32)]).cpu().numpy()
        G = res.chosen.shape[0]
        chosen, ok, n_placed = head[:G], bool(head[G]), int(head[G + 1])
        fin = head[G + 2:] != 0
        self._note_path(launches0)
        self.metrics.waves_total.labels(path="device").inc()
        bad = [members[i].uid for i in range(len(members)) if not fin[i]]
        if bad:
            for p in members:
                self.queue.add_if_not_present(p)
            raise FloatingPointError(
                f"numeric-integrity sentinel flagged gang pods {bad}")
        if not ok:
            self._fail_gang(key, members, need, res, n_placed)
            return placed
        self._rr = res.rr_end
        pairs: List = []
        leftover: List = []
        for i, pod in enumerate(members):
            n = int(chosen[i])
            if n >= 0:
                pairs.append((pod, self.snapshot.node_names[n]))
            else:
                leftover.append((i, pod))
        if not self._commit_gang(pairs):
            # the exact int64 recheck lost a race with the device's f32
            # arithmetic: retry the whole gang, not unschedulable
            for pod in members:
                self.queue.add_if_not_present(pod)
            return placed
        self.backoff.clear("gang:" + key)
        # surplus members beyond minMember that didn't fit park
        # individually with normal per-pod attribution
        if leftover:
            fail_counts = res.fail_counts.cpu().numpy()
            masks = res.masks.cpu().numpy()
            for i, pod in leftover:
                self._handle_failure(pod, i, fail_counts, masks)
        return placed + len(pairs)

    def _fail_gang(self, key: str, members: List[api.Pod], need: int, res,
                   n_placed: int) -> None:
        """minMember pods can't hold capacity together: no member commits
        (the device already discarded the placements), every member parks
        with ONE shared backoff deadline, and gang-aware preemption runs
        so a higher-priority gang can evict its way in."""
        n_nodes = int(np.sum(self.snapshot.valid))
        short = max(need - n_placed, 1)
        err = FitError(key, n_nodes, {REASONS["Gang"]: short})
        # park FIRST: the preemption below emits store events (nominated-
        # node writes, victim deletes) whose queue.update would re-add a
        # not-yet-parked member to the ACTIVE heap — the gang would then
        # retry as shrinking subsets instead of waiting out its backoff
        until = self.clock() + self.backoff.bump("gang:" + key)
        for pod in members:
            self.metrics.pods_failed.inc()
            self.queue.set_backoff(pod.uid, until)
            self.queue.add_unschedulable_if_not_present(pod)
            self.store.set_pod_condition(
                pod, ("PodScheduled", "False:" + err.message()))
        if self.disable_preemption:
            return
        t0 = self.clock()
        guard = self._gang_guard()
        masks = res.masks.cpu().numpy()
        # claimed: nodes earlier members already nominated — each member
        # must free a DIFFERENT node or the gang re-fails with one slot
        # freed
        claimed: set = set()
        for i, pod in enumerate(members):
            self.metrics.total_preemption_attempts.inc()
            fp = {n: preds for n, preds in
                  self._failed_predicates_by_node(masks, i).items()
                  if n not in claimed}
            pr = preempt(pod, self.cache, fp, self._pdbs(),
                         with_affinity=self.snapshot.has_affinity_terms
                         or _pod_has_ipa_terms(pod),
                         extra_fit=self._host_extra_fit,
                         gang_guard=guard, snapshot=self.snapshot,
                         featurizer=self.featurizer)
            if pr is not None:
                claimed.add(pr.node_name)
                self._perform_preemption(pod, pr)
        self.metrics.preemption_evaluation.observe(self.clock() - t0)

    def _commit_gang(self, pairs) -> bool:
        """Group-wide exact commit: EVERY member passes the int64 recheck
        and assumes before any bind; one failure rolls the entire group
        back, so a partially-bound gang never reaches the store."""
        assumed: List = []  # (pod, bound, node_name, vol_rollback)
        ok = True
        for pod, node_name in pairs:
            ni = self.cache.node_infos.get(node_name)
            if ni is None or not ni.fits_exactly(pod):
                ok = False
                break
            got, vol_rollback = self._bind_volumes(pod, ni)
            if not got:
                ok = False
                break
            assumed.append((pod, self._assume(pod, node_name), node_name,
                            vol_rollback))
        if not ok:
            for pod, bound, node_name, vol_rollback in reversed(assumed):
                self._forget(bound, node_name)
                if vol_rollback is not None:
                    vol_rollback()
            return False
        for pod, bound, node_name, vol_rollback in assumed:
            self._bind(pod, bound, node_name, vol_rollback)
        return True

    def _gang_state(self):
        """(GangGuard, placed-members map, minMember map) from ONE cache
        scan, or (None, {}, {}) when the cluster has never seen a gang
        pod."""
        if not self.gangs.active:
            return None, {}, {}
        placed = self.gangs.placed_by_gang(self.cache)
        if not placed:
            return None, {}, {}
        mins = {key: self.gangs.min_member_by_key(key, sample=members[0])
                for key, members in placed.items()}
        slack = {key: max(len(members) - mins[key], 0)
                 for key, members in placed.items()}
        return GangGuard(self.gangs.key, slack), placed, mins

    def _gang_guard(self) -> Optional[GangGuard]:
        return self._gang_state()[0]

    # -- failure attribution (kubernetes_tpu/sched/scheduler.py:4484) ------------

    def _fit_error(self, pod: api.Pod, idx: int, fail_counts,
                   masks) -> FitError:
        """fail_counts [Q, P] and masks [Q, P, N], fetched. A node whose
        first failure is the host stack counts under the host filter that
        rejected it (`_wave_host_fails`)."""
        reasons: Dict[str, int] = {}
        for q, name in enumerate(enc.MASK_STACK_NAMES):
            c = int(fail_counts[q, idx])
            if not c:
                continue
            if name == "PodFitsResources":
                reasons[insufficient_resource_reason("resources")] = c
            elif name == "HostPlugins":
                fails = self._wave_host_fails.get(idx, {})
                if fails:
                    col = masks[:, idx, :]  # [Q, N]
                    valid = self.snapshot.valid
                    for n, nname in enumerate(self.snapshot.node_names):
                        if (n < col.shape[1] and valid[n] and not col[q, n]
                                and col[:q, n].all()):
                            key = fails.get(nname, "NoDiskConflict")
                            r = REASONS.get(key, key)
                            reasons[r] = reasons.get(r, 0) + 1
                else:
                    reasons[REASONS["NoDiskConflict"]] = c
            elif name == "CheckNodeCondition":
                reasons[REASONS["NodeNotReady"]] = c
            elif name == "CheckNodeUnschedulable":
                reasons[REASONS["NodeUnschedulable"]] = c
            elif name == "CheckNodeMemoryPressure":
                reasons[REASONS["NodeUnderMemoryPressure"]] = c
            elif name == "CheckNodeDiskPressure":
                reasons[REASONS["NodeUnderDiskPressure"]] = c
            elif name == "CheckNodePIDPressure":
                reasons[REASONS["NodeUnderPIDPressure"]] = c
            else:
                reasons[REASONS.get(name, name)] = c
        return FitError(pod.full_name(), int(np.sum(self.snapshot.valid)),
                        reasons)

    def _failed_predicates_by_node(self, masks,
                                   idx: int) -> Dict[str, List[str]]:
        """First-failing predicate per node for one failed pod, from the
        fetched mask stack [Q, P, N] (short-circuit attribution)."""
        col = masks[:, idx, :]  # [Q, N]
        out: Dict[str, List[str]] = {}
        valid = self.snapshot.valid
        host_fails = self._wave_host_fails.get(idx, {})
        for n, name in enumerate(self.snapshot.node_names):
            if n < col.shape[1] and valid[n]:
                fails = np.flatnonzero(~col[:, n])
                if fails.size:
                    pred = enc.MASK_STACK_NAMES[fails[0]]
                    if pred == "HostPlugins":
                        out[name] = [host_fails.get(name, "NoDiskConflict")]
                        continue
                    if pred == "CheckNodeCondition":
                        # distinguish sub-reasons host-side for the
                        # unresolvable filter
                        ni = self.cache.node_infos.get(name)
                        if ni is not None and ni.node is not None:
                            _, rs = golden.check_node_condition(None, ni)
                            out[name] = ["NodeNotReady" if r == REASONS["NodeNotReady"]
                                         else "NodeNetworkUnavailable" if r == REASONS["NodeNetworkUnavailable"]
                                         else "NodeUnschedulable" if r == REASONS["NodeUnschedulable"]
                                         else "NodeOutOfDisk" for r in rs] or ["NodeNotReady"]
                            continue
                    out[name] = [pred]
        return out

    def _handle_failure(self, pod: api.Pod, idx: int, fail_counts, masks):
        """fail_counts [Q, P] and masks [Q, P, N]: the wave's, fetched."""
        self.metrics.pods_failed.inc()
        err = self._fit_error(pod, idx, fail_counts, masks)
        self._count_unschedulable(err)
        if not self.disable_preemption:
            t0 = self.clock()
            self.metrics.total_preemption_attempts.inc()
            aff = pod.spec.affinity
            pod_has_ipa = aff is not None and (
                aff.pod_affinity is not None
                or aff.pod_anti_affinity is not None)
            pr = preempt(pod, self.cache,
                         self._failed_predicates_by_node(masks, idx),
                         self._pdbs(),
                         with_affinity=(self.snapshot.has_affinity_terms
                                        or pod_has_ipa),
                         extra_fit=self._host_extra_fit,
                         gang_guard=self._gang_guard(),
                         snapshot=self.snapshot, featurizer=self.featurizer)
            self.metrics.preemption_evaluation.observe(self.clock() - t0)
            if pr is not None and pr.victims:
                self._perform_preemption(pod, pr)
            # a zero-victim candidate means the what-if thinks the pod
            # fits as-is: don't nominate, just park and retry
        self._park_with_backoff(pod)
        self.store.set_pod_condition(
            pod, ("PodScheduled", "False:" + err.message()))

    def _park_with_backoff(self, pod: api.Pod):
        """Failure-path requeue: the pod's next backoff duration, then a
        park as unschedulable; the queue keeps it out of the active heap
        until the deadline even if cluster events move it (reference:
        util/backoff_utils.go:97-112)."""
        d = self.backoff.bump(pod.uid)
        self.queue.set_backoff(pod.uid, self.clock() + d)
        self.queue.add_unschedulable_if_not_present(pod)

    def _pdbs(self) -> List[api.PodDisruptionBudget]:
        return list(self.store.list("poddisruptionbudgets"))

    def _perform_preemption(self, pod: api.Pod, pr):
        """Reference: scheduler.go:233-256 — nominate, evict victims, clear
        lower nominations. When the evictions drop a victim gang below
        its minMember, the gang's REMAINING members are evicted too
        (cluster-wide): a sub-minMember gang holds capacity while doing
        no useful work."""
        pod.status.nominated_node_name = pr.node_name
        self.store.set_nominated_node(pod, pr.node_name)
        self.queue.update_nominated_pod(pod, pr.node_name)
        # dict-as-ordered-set: the broken-gang teardown below deletes
        # pods in this order, which must follow victim order
        victim_gangs: Dict[str, None] = {}
        for victim in pr.victims:
            if self.gangs.active:
                k = self.gangs.key(victim)
                if k is not None:
                    victim_gangs[k] = None
            self.metrics.pod_preemption_victims.inc()
            try:
                self.store.delete("pods", victim.namespace,
                                  victim.metadata.name)
            except KeyError:
                pass
        victim_uids = {v.uid for v in pr.victims}
        for gkey in victim_gangs:
            remaining = [p for p in self.gangs.placed_members(self.cache,
                                                              gkey)
                         if p.uid not in victim_uids]
            if not remaining:
                continue
            m = self.gangs.min_member_by_key(gkey, sample=remaining[0])
            if len(remaining) >= m:
                continue
            for p in remaining:
                self.metrics.pod_preemption_victims.inc()
                try:
                    self.store.delete("pods", p.namespace, p.metadata.name)
                except KeyError:
                    pass
        for lower in get_lower_priority_nominated_pods(pod, pr.node_name,
                                                       self.queue):
            lower.status.nominated_node_name = ""
            self.queue.update_nominated_pod(lower, "")

    # -- commit ------------------------------------------------------------------

    def _assume(self, pod: api.Pod, node_name: str) -> api.Pod:
        bound = api.with_node_name(pod, node_name)
        self.cache.assume_pod(bound)
        self.snapshot.refresh_node_resources(self.cache.node_infos[node_name])
        self.snapshot.add_pod(bound)
        return bound

    def _forget(self, bound: api.Pod, node_name: str) -> None:
        if self.cache.is_assumed(bound):
            self.cache.forget_pod(bound)
        ni = self.cache.node_infos.get(node_name)
        if ni is not None:
            self.snapshot.refresh_node_resources(ni)
        self.snapshot.remove_pod(bound)

    def _bind_volumes(self, pod: api.Pod, ni):
        """With the VolumeScheduling gate on, bind the pod's unbound
        claims to PVs that admit the node (kubernetes_tpu/sched/
        scheduler.py:3851-3859): (ok, rollback or None)."""
        if (self.features.enabled("VolumeScheduling")
                and self.volume_binder.pod_has_claims(pod)):
            return self.volume_binder.bind_pod_volumes(pod, ni.node)
        return True, None

    def _bind(self, pod: api.Pod, bound: api.Pod, node_name: str,
              vol_rollback=None) -> bool:
        """The bind POST and the cache's confirmation. A bind the store
        refuses rolls the assumption and the pod's claim bindings back
        (kubernetes_tpu/sched/scheduler.py:4066-4088); the store's own
        event then tells the cache the truth. If the store still holds
        the pod unbound, the pod parks with backoff, as the JAX
        reconciler's ORPHANED outcome does. A bind that lands observes
        the pod's latency from its first enqueue (the queue's added_at,
        consumed only here, so a failed bind's requeue keeps the
        original time)."""
        t0 = self.clock()
        try:
            self.store.bind(pod, node_name)
        except (KeyError, Conflict):
            self.metrics.scheduling_errors.labels(stage="bind").inc()
            if self.cache.is_assumed(bound):
                self._forget(bound, node_name)
            if vol_rollback is not None:
                vol_rollback()
            truth = self.store.get("pods", pod.namespace, pod.metadata.name)
            if truth is not None and not truth.spec.node_name:
                self._park_with_backoff(truth)
            return False
        self.cache.finish_binding(bound)
        self.metrics.binding_latency.observe(self.clock() - t0)
        added = self.queue.added_at.pop(pod.uid, None)
        if added is not None:
            self.metrics.pod_scheduling_latency.observe(self.clock() - added)
        self.metrics.pods_scheduled.inc()
        self.backoff.clear(pod.uid)
        self.queue.clear_backoff(pod.uid)
        self.queue.update_nominated_pod(pod, "")
        return True

    def _commit(self, pod: api.Pod, node_name: str) -> bool:
        """Exact int64 re-verification, the pod's claims bound when the
        VolumeScheduling gate is on, then assume and bind (reference:
        scheduler.go:268 assumeAndBindVolumes, :486 assume -> :491
        bind)."""
        ni = self.cache.node_infos.get(node_name)
        if ni is None or not ni.fits_exactly(pod):
            return False
        got, vol_rollback = self._bind_volumes(pod, ni)
        if not got:
            return False
        return self._bind(pod, self._assume(pod, node_name), node_name,
                          vol_rollback)
