"""The scheduler's main path: watch, queue, one device round, commit.

A lean counterpart of the JAX package's Scheduler
(kubernetes_tpu/sched/scheduler.py) that carries its main path only:
`schedule_pending` drains the pending pods through device-resident
rounds (`_run_pipeline`), each of which

  1. featurizes the backlog in numpy (state/featurize.py);
  2. uploads the snapshot (state/snapshot.py `to_device`);
  3. runs the whole round on the device (ops/kernel.py `schedule_round`,
     with the taint/host-port CUDA kernel launched once per round);
  4. fetches `chosen` once and commits each pod through the exact int64
     recheck, assume and bind (`_commit`).

Pods are ordered by (-priority, arrival seq), as the JAX scheduling
queue orders them. A round places at most PIPELINE_MAX_WAVES waves of
`wave_size` pods (PIPELINE_MAX_WAVES_IPA when inter-pod affinity is in
play anywhere); the rest go back to the queue before the round runs,
and the pods the round leaves unplaced go back after its commit, as the
JAX round sends them. A round that places nothing parks its pods as
unschedulable until a node event or a pod deletion moves them back:
the JAX scheduler attributes and parks such pods through its per-wave
loop, which this slice does not carry.

Inter-pod affinity and topology spread ride the round. Not in the
port yet (each raises NotImplementedError and drops no pod, rather
than diverging in silence): gangs, volumes, and pods whose required
pod (anti-)affinity terms span more than one topology key, which the
JAX package places through its exact host path (plugins/golden.py).
Left out with no stand-in: preemption, the circuit breakers,
the bind journal and reconciler, extenders, tracing, the mesh and the
memory governor.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import labels as lbl
from ..api import types as api
from ..ops import encoding as enc
from ..ops.kernel import Weights, schedule_round
from ..ops.scores import stack_weights
from ..ops.taint_ports import taint_ports_masks
from ..runtime.store import ADDED, DELETED, MODIFIED, Conflict, Event, ObjectStore
from ..state.cache import SchedulerCache
from ..state.featurize import PodFeaturizer
from ..state.snapshot import Snapshot

# Max chained waves per device-resident round; rounds are bucketed per
# power-of-two wave count (a fixed W would make small rounds pay for 128
# waves). Longer backlogs run multiple rounds. A round with inter-pod
# affinity anywhere (bound or pending) is capped lower, as the JAX
# scheduler caps it: the placements depend on where each round ends.
PIPELINE_MAX_WAVES = 128
PIPELINE_MAX_WAVES_IPA = 64
SCHEDULER_NAME = "default-scheduler"


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


def _later_slice(pod: api.Pod) -> Optional[str]:
    """Why this pod needs a part of the scheduler a later slice ports,
    or None."""
    if api.pod_group_name(pod) is not None:
        return "gang scheduling (kubernetes_tpu/ops/gang.py)"
    if pod.spec.volumes:
        return "volume predicates and binding"
    if PodFeaturizer.needs_host_path(pod):
        return ("the exact host path for required pod (anti-)affinity over "
                "more than one topology key (kubernetes_tpu/plugins/golden.py)")
    return None


class Scheduler:
    """Watches `store` for nodes and pods and schedules pending pods on
    `device` (None: the CUDA card; raises where there is none)."""

    def __init__(self, store: ObjectStore, wave_size: int = 128,
                 caps: Optional[enc.Caps] = None, device=None):
        self.device = enc.resolve_device(device)
        self.store = store
        self.wave_size = wave_size
        # the reference default provider's weights, which the JAX
        # scheduler's default profile also yields
        self.weights = Weights()
        # guards cache + snapshot against concurrent informer delivery;
        # RLock: the in-process store delivers bind events re-entrantly
        # on the committing thread
        self._mu = threading.RLock()
        self.cache = SchedulerCache()
        self.snapshot = Snapshot(caps=caps)
        self.featurizer = PodFeaturizer(self.snapshot, GroupLister(store))
        # pending pods: heap of (-priority, seq, uid) over `_active`
        self._heap: List[tuple] = []
        self._active: Dict[str, api.Pod] = {}
        self._unschedulable: Dict[str, api.Pod] = {}
        self._seq = itertools.count()
        self._rr: Optional[torch.Tensor] = None  # round-robin counter
        self._last_path: Optional[str] = None
        self._wire()

    # -- watch handlers (reference: factory.go:191-295) -----------------------

    def _wire(self) -> None:
        self.store.watch("nodes", self._on_node_event)
        self.store.watch("pods", self._on_pod_event)
        for kind in ("services", "replicationcontrollers", "replicasets",
                     "statefulsets"):
            self.store.watch(kind, lambda ev: self._invalidate_features())
        # objects already in the store: nodes first, so their pods' rows
        # land against present node rows
        for node in self.store.list("nodes"):
            self._on_node_add(node)
        for pod in self.store.list("pods"):
            self._on_pod_add(pod)

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

    def _responsible(self, pod: api.Pod) -> bool:
        return pod.spec.scheduler_name == SCHEDULER_NAME

    def _on_pod_add(self, pod: api.Pod) -> None:
        with self._mu:
            if pod.spec.node_name:
                self.cache.add_pod(pod)
                ni = self.cache.node_infos.get(pod.spec.node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.add_pod(pod)
            elif self._responsible(pod) and pod.status.phase in ("", "Pending"):
                self._enqueue(pod)

    def _on_pod_update(self, old: api.Pod, new: api.Pod) -> None:
        with self._mu:
            if new.spec.node_name:
                if old.spec.node_name:
                    self.cache.update_pod(old, new)
                else:
                    self.cache.add_pod(new)  # bind confirmation
                self._dequeue(new.uid)
                ni = self.cache.node_infos.get(new.spec.node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.add_pod(new)
            elif self._responsible(new):
                if new.uid in self._active:
                    self._active[new.uid] = new
                elif new.uid in self._unschedulable:
                    self._unschedulable[new.uid] = new
                else:
                    self._enqueue(new)

    def _on_pod_delete(self, pod: api.Pod) -> None:
        with self._mu:
            if pod.spec.node_name:
                self.cache.remove_pod(pod)
                ni = self.cache.node_infos.get(pod.spec.node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.remove_pod(pod)
                self._move_all_to_active()
            else:
                self._dequeue(pod.uid)

    def _on_node_add(self, node: api.Node) -> None:
        with self._mu:
            self.cache.add_node(node)
            self.snapshot.set_node(self.cache.node_infos[node.name])
            self._move_all_to_active()

    def _on_node_delete(self, node: api.Node) -> None:
        with self._mu:
            self.cache.remove_node(node)
            self.snapshot.remove_node(node.name)

    def _invalidate_features(self) -> None:
        # group membership may have changed -> equivalence rows are stale
        self.featurizer._cache.clear()

    # -- the pending queue (kubernetes_tpu/sched/queue.py:444 key) ------------

    def _enqueue(self, pod: api.Pod) -> None:
        """Add to the active pods unless already pending."""
        if pod.uid in self._active or pod.uid in self._unschedulable:
            return
        self._active[pod.uid] = pod
        heapq.heappush(self._heap,
                       (-api.pod_priority(pod), next(self._seq), pod.uid))

    def _dequeue(self, uid: str) -> None:
        self._active.pop(uid, None)
        self._unschedulable.pop(uid, None)

    def _pop_all(self) -> List[api.Pod]:
        out = []
        while self._heap:
            _, _, uid = heapq.heappop(self._heap)
            pod = self._active.pop(uid, None)
            if pod is not None:
                out.append(pod)
        return out

    def _move_all_to_active(self) -> None:
        parked = list(self._unschedulable.values())
        self._unschedulable.clear()
        for pod in parked:
            self._enqueue(pod)

    def pending_count(self) -> int:
        with self._mu:
            return len(self._active)

    def unschedulable_pods(self) -> List[api.Pod]:
        with self._mu:
            return list(self._unschedulable.values())

    def wave_path(self) -> str:
        """What the most recent round ran: 'cuda' when the taint/port
        kernel launched, 'torch-cpu' on the CPU, 'unresolved' before any
        round."""
        return self._last_path or "unresolved"

    # -- the round -------------------------------------------------------------

    def schedule_pending(self) -> int:
        """Run rounds until no pod is pending. Returns pods placed
        (assumed + bound)."""
        placed = 0
        while True:
            with self._mu:
                if not self._active:
                    break
                self.cache.cleanup_expired()
                pods = self._pop_all()
                for pod in pods:
                    reason = _later_slice(pod)
                    if reason is not None:
                        for p in pods:
                            self._enqueue(p)
                        raise NotImplementedError(
                            f"pod {pod.full_name()} needs {reason}, a later "
                            "slice of the port")
                n, retry = self._run_pipeline(pods)
                placed += n
                if n == 0:
                    # nothing changed since these pods failed: park them
                    # until a cluster event can make them schedulable
                    for pod in retry:
                        self._active.pop(pod.uid, None)
                        self._unschedulable[pod.uid] = pod
        return placed

    def _run_pipeline(self, pods: List[api.Pod]):
        """One device-resident round over `pods` (queue order). Returns
        (placed, the pods it left unplaced and requeued)."""
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
                self._enqueue(p)
            pods, waves = pods[:keep], waves[:max_waves]
        # pass 1 grows every vocab/cap to its final size; when it grew,
        # pass 2 re-emits every batch at the uniform final shapes
        sig0 = (self.featurizer.vocabs.version(),
                dataclasses.astuple(self.snapshot.caps))
        pbs = [self.featurizer.featurize(wv) for wv in waves]
        if (self.featurizer.vocabs.version(),
                dataclasses.astuple(self.snapshot.caps)) != sig0:
            pbs = [self.featurizer.featurize(wv) for wv in waves]
        pm_rows_all, term_rows_all = self.snapshot.stage_pending(pods)
        tpp = term_rows_all.shape[1]
        dev = self.device
        nt, pm, tt = self.snapshot.to_device(dev)
        usage = (nt.requested, nt.nonzero, nt.pod_count)
        if self._rr is None:
            self._rr = torch.zeros((), dtype=torch.int32, device=dev)
        wv = enc.weight_vec_to_torch(stack_weights(self.weights), dev)
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
            has_ipa=has_ipa, weight_vec=wv)
        # the round's one fetch: chosen and the sentinel together
        chosen_all = chosen_d.cpu().numpy()
        fin_all = fin_d.cpu().numpy()
        self._last_path = ("cuda" if taint_ports_masks.launches > launches0
                           else "torch-cpu")
        bad = [wv_pods[i].uid for wi, wv_pods in enumerate(waves)
               for i in range(len(wv_pods)) if not fin_all[wi, i]]
        if bad:
            # the featurizer rejects non-finite specs, so a non-finite
            # row here means corrupted inputs: discard the whole round
            for p in pods:
                self.snapshot.unstage(p)
                self._enqueue(p)
            raise FloatingPointError(
                f"numeric-integrity sentinel flagged pods {bad}")
        self._rr = rr_end
        placed = 0
        retry: List[api.Pod] = []
        for wi, wv_pods in enumerate(waves):
            for i, pod in enumerate(wv_pods):
                node_idx = int(chosen_all[wi, i])
                if node_idx >= 0:
                    node_name = self.snapshot.node_names[node_idx]
                    if self._commit(pod, node_name):
                        placed += 1
                        continue
                self.snapshot.unstage(pod)
                # a pod deleted or bound by another actor meanwhile is done
                truth = self.store.get("pods", pod.namespace, pod.name)
                if truth is not None and not truth.spec.node_name:
                    retry.append(pod)
        for pod in retry:
            self._enqueue(pod)
        return placed, retry

    def _commit(self, pod: api.Pod, node_name: str) -> bool:
        """Exact int64 re-verification, then assume and bind (reference:
        scheduler.go:486 assume -> :491 bind). A bind the store refuses
        (the pod was deleted, or bound by another actor) rolls the
        assumption back; the store's own event then tells the cache the
        truth."""
        ni = self.cache.node_infos.get(node_name)
        if ni is None or not ni.fits_exactly(pod):
            return False
        bound = api.with_node_name(pod, node_name)
        self.cache.assume_pod(bound)
        self.snapshot.refresh_node_resources(self.cache.node_infos[node_name])
        self.snapshot.add_pod(bound)
        try:
            self.store.bind(pod, node_name)
        except (KeyError, Conflict):
            if self.cache.is_assumed(bound):
                self.cache.forget_pod(bound)
                ni = self.cache.node_infos.get(node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.remove_pod(bound)
            return False
        self.cache.finish_binding(bound)
        return True
