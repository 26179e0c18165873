"""Preemption.

Behavioral port of genericScheduler.Preempt
(pkg/scheduler/core/generic_scheduler.go:200) over cloned NodeInfos and
the golden predicates: candidate nodes are those whose failure reasons
are resolvable (:972), victims are selected by the remove-all /
reprieve-by-priority algorithm (:898 selectVictimsOnNode) with PDB
awareness, and the node is picked by the reference's lexicographic
criteria (:702 pickOneNodeForPreemption):
  fewer PDB violations > lower max victim priority > lower priority sum
  > fewer victims > first.

The exact clone/reprieve loop runs only on a PRUNED, RANKED candidate
set: when the caller passes the live snapshot + featurizer, one
vectorized (1 x nodes) feasibility-after-victim-removal pass over the
dense host planes (ops/hostwave.py preemption_stats_host — the numpy
twin of the device what-if) drops every node that cannot fit the pod
even with ALL lower-priority pods removed, ranks the survivors by the
device path's tie-break approximation, and caps exact validation at
PRUNE_HOST_CANDIDATES — the same top-K discipline the pipeline's device
path applies (Scheduler._preempt_chunk). Without the snapshot the old
validate-every-resolvable-node behavior is preserved.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import types as api
from ..state.cache import SchedulerCache
from ..state.node_info import NodeInfo
from ..plugins import golden
from ..utils import tracing
from .errors import UNRESOLVABLE

# exact select_victims_on_node validations per preempt() call when the
# vectorized prune ranked the candidates — mirrors the device pipeline's
# PREEMPT_HOST_CANDIDATES (sched/scheduler.py)
PRUNE_HOST_CANDIDATES = 8
PRUNE_LEVELS = 8


class PreemptionResult:
    def __init__(self, node_name: str, victims: List[api.Pod],
                 num_pdb_violations: int):
        self.node_name = node_name
        self.victims = victims
        self.num_pdb_violations = num_pdb_violations


def pod_eligible_to_preempt_others(pod: api.Pod, cache: SchedulerCache) -> bool:
    """Reference :1015 — a pod that already nominated a node where a
    lower-priority pod is terminating must wait."""
    nominated = pod.status.nominated_node_name
    if nominated:
        ni = cache.node_infos.get(nominated)
        if ni is not None:
            for p in ni.pods:
                if (p.metadata.deletion_timestamp is not None
                        and api.pod_priority(p) < api.pod_priority(pod)):
                    return False
    return True


def nodes_where_preemption_might_help(
        failed: Dict[str, List[str]]) -> List[str]:
    """failed: node name -> failed predicate names (from the device mask
    stack or golden run). Reference :972."""
    out = []
    for node_name, preds in failed.items():
        if not any(p in UNRESOLVABLE for p in preds):
            out.append(node_name)
    return out


class GangGuard:
    """Victim-gang integrity, PDB-style (gang forward-port): evicting a
    member that would drop its gang below minMember is a disruption
    violation. Like a PDB's disruptionsAllowed, each gang carries a
    slack budget (placed - minMember); victims beyond it land in the
    violating list, so the reprieve loop preferentially spares them and
    pick_one_node's first criterion steers preemption toward nodes where
    only slack members (or whole gangs) die."""

    def __init__(self, key_fn: Callable[[api.Pod], Optional[str]],
                 slack: Dict[str, int]):
        self.key_fn = key_fn
        self._slack = dict(slack)

    def split(self, pods: Sequence[api.Pod]):
        """-> (violating, ok), consuming slack in the given order (the
        caller passes highest-priority-first, matching PDB counting)."""
        remaining = dict(self._slack)
        violating, ok = [], []
        for p in pods:
            key = self.key_fn(p)
            if key is None:
                ok.append(p)
                continue
            r = remaining.get(key, 0)
            if r > 0:
                remaining[key] = r - 1
                ok.append(p)
            else:
                violating.append(p)
        return violating, ok


def _pods_violating_pdb(pods: Sequence[api.Pod],
                        pdbs: Sequence[api.PodDisruptionBudget]):
    """Reference :862 filterPodsWithPDBViolation. A pod violates if it
    matches a PDB whose disruptionsAllowed is exhausted (counting this
    selection round's usage)."""
    remaining = [pdb.disruptions_allowed for pdb in pdbs]
    violating, ok = [], []
    for p in pods:
        hit = False
        for i, pdb in enumerate(pdbs):
            if pdb.selector is None or pdb.metadata.namespace != p.namespace:
                continue
            if pdb.selector.matches(p.metadata.labels):
                if remaining[i] <= 0:
                    hit = True
                else:
                    remaining[i] -= 1
        (violating if hit else ok).append(p)
    return violating, ok


def select_victims_on_node(
        pod: api.Pod, ni: NodeInfo,
        pdbs: Sequence[api.PodDisruptionBudget],
        node_infos: Optional[Dict[str, NodeInfo]] = None,
        extra_fit: Optional[Callable[[api.Pod, NodeInfo], bool]] = None,
        gang_guard: Optional[GangGuard] = None,
        ) -> Optional[Tuple[List[api.Pod], int]]:
    """Reference :898. Returns (victims, numPDBViolations) or None.
    node_infos enables inter-pod affinity in the what-if (the cloned
    NodeInfo overrides the node under test, like meta.RemovePod keeps the
    shared metadata consistent, metadata.go:141). extra_fit folds the
    scheduler's host plugins (volume predicates etc.) into the what-if —
    victim removal can resolve NoDiskConflict/MaxVolumeCount, and nodes
    failing unresolvable host predicates must not produce victims.
    gang_guard treats victim-gang minMember as a disruption budget (see
    GangGuard) — gang-breaking evictions count into numPDBViolations."""
    copy = ni.clone()
    view = (golden.ClusterView(node_infos, override=copy)
            if node_infos is not None else None)
    prio = api.pod_priority(pod)
    potential = [p for p in copy.pods if api.pod_priority(p) < prio]
    for p in potential:
        copy.remove_pod(p)
    potential.sort(key=api.pod_priority, reverse=True)

    def fits_now() -> bool:
        ok, _ = golden.pod_fits_on_node(pod, copy, view=view)
        return ok and (extra_fit is None or extra_fit(pod, copy))

    if not fits_now():
        return None
    victims: List[api.Pod] = []
    num_violating = 0
    violating, non_violating = _pods_violating_pdb(potential, pdbs)
    if gang_guard is not None:
        gang_violating, non_violating = gang_guard.split(non_violating)
        violating = violating + gang_violating

    def reprieve(p: api.Pod) -> bool:
        copy.add_pod(p)
        ok = fits_now()
        if not ok:
            copy.remove_pod(p)
            victims.append(p)
        return ok

    for p in violating:
        if not reprieve(p):
            num_violating += 1
    for p in non_violating:
        reprieve(p)
    return victims, num_violating


def pick_one_node(candidates: Dict[str, Tuple[List[api.Pod], int]]) -> Optional[str]:
    """Reference :702 pickOneNodeForPreemption."""
    if not candidates:
        return None
    for name, (victims, _) in candidates.items():
        if not victims:
            return name
    names = list(candidates)

    def metric(name):
        victims, nviol = candidates[name]
        max_prio = api.pod_priority(victims[0])  # sorted desc by selection
        sum_prio = sum(api.pod_priority(p) + (2**31) for p in victims)
        return (nviol, max_prio, sum_prio, len(victims))

    names.sort(key=metric)
    return names[0]


def process_preemption_with_extenders(
        pod: api.Pod, candidates: Dict[str, Tuple[List[api.Pod], int]],
        extenders, pdbs: Sequence[api.PodDisruptionBudget] = (),
        ) -> Dict[str, Tuple[List[api.Pod], int]]:
    """Reference :241 processPreemptionWithExtenders
    (kubernetes_tpu/sched/preemption.py:206): each preemption-aware
    extender may drop candidate nodes or trim their victim lists. A node
    the extender does not name is dropped; a trimmed list has its PDB
    violations counted again, so pick_one_node's first criterion stays
    accurate. An extender that fails is skipped when ignorable; else it
    drops every candidate of this attempt."""
    for ext in extenders:
        if not candidates or not ext.supports_preemption():
            continue
        try:
            kept = ext.process_preemption(
                pod, {n: vs for n, (vs, _) in candidates.items()})
        except Exception:
            if ext.ignorable:
                continue
            return {}
        new: Dict[str, Tuple[List[api.Pod], int]] = {}
        for n, (vs, nviol) in candidates.items():
            if n not in kept:
                continue
            trimmed = [v for v in vs if v.uid in set(kept[n])]
            if len(trimmed) != len(vs):
                violating, _ = _pods_violating_pdb(trimmed, pdbs)
                nviol = len(violating)
            new[n] = (trimmed, nviol)
        candidates = new
    return candidates


def vector_candidate_order(pod: api.Pod, snapshot,
                           featurizer) -> Optional[List[str]]:
    """One vectorized (1 x nodes) feasibility-after-victim-removal pass
    over the snapshot's host planes: the numpy twin of the device
    what-if (ops/hostwave.py preemption_stats_host), computed for just
    this pod. Returns candidate node names RANKED by the device path's
    tie-break approximation (gang disruption, max victim priority,
    priority sum, victim count), or None when the pod can't be encoded
    (the caller then validates every resolvable node, as before)."""
    from ..ops.hostwave import preemption_stats_host, victim_levels
    from ..ops.preempt import PreemptStats

    aff = pod.spec.affinity
    if (featurizer.needs_host_path(pod)
            or snapshot.has_affinity_terms
            or (aff is not None and (aff.pod_affinity is not None
                                     or aff.pod_anti_affinity is not None))
            or golden.has_hard_spread(pod)):
        # the twin carries no inter-pod affinity (or topology spread)
        # plane: a constraint-blind top-K cut could drop the only
        # feasible node before exact validation — such pods keep the
        # full validate-every-resolvable-node loop
        return None
    live = snapshot.ep_valid & snapshot.ep_alive
    levels = victim_levels(snapshot.ep_prio, live, PRUNE_LEVELS)
    if levels is None:
        return []  # nothing evictable anywhere
    pb = featurizer.featurize([pod])
    # re-grab the planes AFTER featurize: interning may have grown caps,
    # replacing the snapshot's arrays
    nt, pm, tt = snapshot.host_tensors()
    st = PreemptStats(preemption_stats_host(
        nt, pm, pb, np.asarray(levels, np.int32), num_levels=PRUNE_LEVELS))
    cand = np.nonzero(st.ok[0])[0]
    order = sorted(
        cand.tolist(),
        key=lambda n: (float(st.gang_viol[0, n]), float(st.prio_max[0, n]),
                       float(st.prio_sum[0, n]), float(st.victims[0, n])))
    return [snapshot.node_names[n] for n in order]


def preempt(pod: api.Pod, cache: SchedulerCache,
            failed_predicates: Dict[str, List[str]],
            pdbs: Sequence[api.PodDisruptionBudget],
            with_affinity: bool = False,
            extenders=(), extra_fit=None,
            gang_guard: Optional[GangGuard] = None,
            snapshot=None, featurizer=None
            ) -> Optional[PreemptionResult]:
    """Reference :200 Preempt. Returns None when preemption can't help.
    with_affinity: evaluate MatchInterPodAffinity in the what-if (pass
    when any affinity terms exist in the cluster). snapshot+featurizer
    enable the vectorized candidate prune (see module doc): the exact
    clone/reprieve loop then runs only on the top
    PRUNE_HOST_CANDIDATES ranked survivors instead of every resolvable
    node — same semantics approximation as the device pipeline, which
    also validates only its top-K device-ranked candidates. extenders:
    the profile's, whose preempt verbs may trim the validated
    candidates before the pick (process_preemption_with_extenders)."""
    if not pod_eligible_to_preempt_others(pod, cache):
        return None
    # topology spread's what-if needs the cluster-wide domain counts
    # just like affinity needs the cluster's pods: without the view the
    # golden fit is spread-blind and reports ts-infeasible nodes as
    # zero-victim candidates (observed as a hot nominate/requeue loop)
    node_infos = (cache.node_infos
                  if with_affinity or golden.has_hard_spread(pod) else None)
    helpful = nodes_where_preemption_might_help(failed_predicates)
    node_order: List[str] = helpful
    pruned = -1
    if snapshot is not None and featurizer is not None:
        order = vector_candidate_order(pod, snapshot, featurizer)
        if order is not None:
            hs = set(helpful)
            ranked = [n for n in order if n in hs]
            pruned = len(helpful) - len(ranked)
            node_order = ranked[:PRUNE_HOST_CANDIDATES]
    candidates: Dict[str, Tuple[List[api.Pod], int]] = {}
    for node_name in node_order:
        ni = cache.node_infos.get(node_name)
        if ni is None or ni.node is None:
            continue
        sel = select_victims_on_node(pod, ni, pdbs, node_infos, extra_fit,
                                     gang_guard)
        if sel is not None:
            candidates[node_name] = sel
    if extenders:
        candidates = process_preemption_with_extenders(pod, candidates,
                                                       extenders, pdbs)
    chosen = pick_one_node(candidates)
    # flight-recorder event (kubernetes_tpu/sched/preemption.py:329)
    tracing.event("preempt_whatif", pod=pod.uid, path="host",
                  candidates=len(candidates), chosen=chosen or "",
                  pruned=max(pruned, 0),
                  backend="vector" if pruned >= 0 else "golden")
    if chosen is None:
        return None
    victims, nviol = candidates[chosen]
    return PreemptionResult(chosen, victims, nviol)


def get_lower_priority_nominated_pods(pod: api.Pod, node_name: str,
                                      queue) -> List[api.Pod]:
    """Reference scheduler.go:249 — other nominated pods on the chosen node
    with lower priority get their nomination cleared."""
    prio = api.pod_priority(pod)
    return [p for p in queue.waiting_pods_for_node(node_name)
            if api.pod_priority(p) < prio]
