"""Golden host-side predicate & priority implementations.

Exact behavioral ports of the reference's fit predicates
(pkg/scheduler/algorithm/predicates/predicates.go) and priorities
(pkg/scheduler/algorithm/priorities/) in plain Python over NodeInfo.
Three consumers:
  1. parity tests — the tensor kernels in ops/ must agree with these on
     identical fixtures (SURVEY.md §4 testing blueprint (a));
  2. preemption what-if simulation (sched/preemption.py), which mutates
     cloned NodeInfos pod-by-pod exactly like the reference
     (generic_scheduler.go:898 selectVictimsOnNode);
  3. the host-side plugin runner for predicates not yet tensorized
     (NoDiskConflict, volume predicates) — mirroring how the reference
     mixes cheap and expensive predicates via ordering.

Each predicate returns (fits: bool, reasons: list[str]) with reason
strings from sched/errors.py.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api import labels as lbl
from ..api import resources as res
from ..api import types as api
from ..sched.errors import REASONS, insufficient_resource_reason
from ..state.node_info import NodeInfo, Resource, _ports_conflict

PredicateResult = Tuple[bool, List[str]]


# --- predicates -------------------------------------------------------------


def check_node_condition(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    """predicates.go:1583 CheckNodeConditionPredicate."""
    if ni.node is None:
        return False, [REASONS["NodeUnknownCondition"]]
    reasons = []
    for c in ni.node.status.conditions:
        if c.type == api.NODE_READY and c.status != api.COND_TRUE:
            reasons.append(REASONS["NodeNotReady"])
        elif c.type == api.NODE_OUT_OF_DISK and c.status != api.COND_FALSE:
            reasons.append(REASONS["NodeOutOfDisk"])
        elif c.type == api.NODE_NETWORK_UNAVAILABLE and c.status != api.COND_FALSE:
            reasons.append(REASONS["NodeNetworkUnavailable"])
    if ni.node.spec.unschedulable:
        reasons.append(REASONS["NodeUnschedulable"])
    return not reasons, reasons


def pod_fits_resources(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    """predicates.go:688 PodFitsResources."""
    if ni.node is None:
        return False, [REASONS["NodeUnknownCondition"]]
    reasons = []
    if len(ni.pods) + 1 > ni.allocatable.allowed_pod_number:
        reasons.append(insufficient_resource_reason(res.PODS))
    r = Resource.from_map(api.get_resource_request(pod))
    if r.milli_cpu == 0 and r.memory == 0 and r.ephemeral_storage == 0 and not r.scalars:
        return not reasons, reasons
    if ni.requested.milli_cpu + r.milli_cpu > ni.allocatable.milli_cpu:
        reasons.append(insufficient_resource_reason(res.CPU))
    if ni.requested.memory + r.memory > ni.allocatable.memory:
        reasons.append(insufficient_resource_reason(res.MEMORY))
    if ni.requested.ephemeral_storage + r.ephemeral_storage > ni.allocatable.ephemeral_storage:
        reasons.append(insufficient_resource_reason(res.EPHEMERAL_STORAGE))
    for name, q in r.scalars.items():
        if ni.requested.scalars.get(name, 0) + q > ni.allocatable.scalars.get(name, 0):
            reasons.append(insufficient_resource_reason(name))
    return not reasons, reasons


def pod_fits_host(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    """predicates.go:825 PodFitsHost."""
    if not pod.spec.node_name:
        return True, []
    if ni.node is not None and pod.spec.node_name == ni.node.name:
        return True, []
    return False, [REASONS["HostName"]]


def pod_fits_host_ports(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    """predicates.go:991 PodFitsHostPorts."""
    wanted = api.get_container_ports(pod)
    if not wanted:
        return True, []
    for p in wanted:
        if _ports_conflict(ni.used_ports, (p.protocol, p.host_ip or "0.0.0.0", p.host_port)):
            return False, [REASONS["PodFitsHostPorts"]]
    return True, []


def pod_matches_node_selector(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    """predicates.go:813 PodMatchNodeSelector."""
    if ni.node is None:
        return False, [REASONS["NodeUnknownCondition"]]
    if api.pod_matches_node_selector(pod, ni.node):
        return True, []
    return False, [REASONS["MatchNodeSelector"]]


def pod_tolerates_node_taints(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    """predicates.go:1504 — NoSchedule + NoExecute taints."""
    return _tolerates(pod, ni, (api.NO_SCHEDULE, api.NO_EXECUTE))


def pod_tolerates_no_execute_taints(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    """predicates.go:1514 — NoExecute only."""
    return _tolerates(pod, ni, (api.NO_EXECUTE,))


def _tolerates(pod: api.Pod, ni: NodeInfo, effects) -> PredicateResult:
    if ni.node is None:
        return False, [REASONS["NodeUnknownCondition"]]
    for taint in ni.taints:
        if taint.effect not in effects:
            continue
        if not api.tolerations_tolerate_taint(pod.spec.tolerations, taint):
            return False, [REASONS["PodToleratesNodeTaints"]]
    return True, []


def check_node_memory_pressure(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    """predicates.go:1541 — only BestEffort pods are rejected."""
    if api.is_best_effort(pod) and ni.memory_pressure:
        return False, [REASONS["NodeUnderMemoryPressure"]]
    return True, []


def check_node_disk_pressure(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    if ni.disk_pressure:
        return False, [REASONS["NodeUnderDiskPressure"]]
    return True, []


def check_node_pid_pressure(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    if ni.pid_pressure:
        return False, [REASONS["NodeUnderPIDPressure"]]
    return True, []


def no_disk_conflict(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    """predicates.go:279 NoDiskConflict — GCEPD (same pd, any RO mix unless
    both read-only), AWS EBS (same volume id), RBD/ISCSI (same image, not
    all read-only). Simplified to source-kind + id equality with the
    read-only escape hatch."""
    mine = [v for v in pod.spec.volumes if v.source_kind]
    if not mine:
        return True, []
    for existing in ni.pods:
        for ev in existing.spec.volumes:
            if not ev.source_kind:
                continue
            for v in mine:
                if v.source_kind == ev.source_kind and v.source_id == ev.source_id:
                    if not (v.read_only and ev.read_only):
                        return False, [REASONS["NoDiskConflict"]]
    return True, []


# Only pods using special volume sources can fail NoDiskConflict — lets the
# host-plugin runner skip it wholesale (Scheduler._host_plugin_mask).
no_disk_conflict.relevant = lambda pod: any(
    v.source_kind for v in pod.spec.volumes)


def new_node_label_presence(labels: Sequence[str], presence: bool):
    """predicates.go:1457 NewNodeLabelPredicate (CheckNodeLabelPresence):
    every listed label must be present (presence=True) / absent (False) on
    the node, values ignored. Policy-configured (api/types.go
    LabelsPresence argument)."""

    def pred(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
        if ni.node is None:
            return False, [REASONS["NodeUnknownCondition"]]
        node_labels = ni.node.metadata.labels or {}
        for l in labels:
            if (l in node_labels) != presence:
                return False, [REASONS["CheckNodeLabelPresence"]]
        return True, []

    pred.predicate_name = "CheckNodeLabelPresence"
    return pred


def new_service_affinity(store, labels: Sequence[str]):
    """predicates.go:852 ServiceAffinity (CheckServiceAffinity): pods of
    the same service must run on nodes with identical values for the
    affinity labels. The pod may pin values via its own nodeSelector;
    otherwise values are adopted from a node already running a pod of the
    service (predicates.go:928 checkServiceAffinity)."""

    def _wanted_labels(pod: api.Pod) -> Dict[str, str]:
        """Node-independent precomputation (the reference does this in
        predicate metadata, predicates.go:905 serviceAffinityMetadataProducer);
        memoized per (pod, store revision) because the host-plugin runner
        calls the predicate once per node."""
        rv = getattr(store, "latest_resource_version", None)
        cached = getattr(_wanted_labels, "_memo", None)
        if cached is not None and cached[0] == (pod.uid, rv):
            return cached[1]
        want: Dict[str, str] = {k: v for k, v in pod.spec.node_selector.items()
                                if k in labels}
        unset = [l for l in labels if l not in want]
        if unset:
            # find pods selected by services that select this pod
            svc_pods: List[api.Pod] = []
            for svc in store.list("services", pod.namespace):
                if svc.selector and lbl.Selector.from_set(svc.selector).matches(
                        pod.metadata.labels):
                    for p in store.list("pods", pod.namespace):
                        if p.uid != pod.uid and p.spec.node_name and \
                                lbl.Selector.from_set(svc.selector).matches(
                                    p.metadata.labels):
                            svc_pods.append(p)
            if svc_pods:
                # anchor node may have been deleted while its pods linger
                anchor = store.get("nodes", "default", svc_pods[0].spec.node_name)
                if anchor is not None:
                    for l in unset:
                        if l in (anchor.metadata.labels or {}):
                            want[l] = anchor.metadata.labels[l]
        _wanted_labels._memo = ((pod.uid, rv), want)
        return want

    def pred(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
        if ni.node is None:
            return False, [REASONS["NodeUnknownCondition"]]
        node_labels = ni.node.metadata.labels or {}
        for k, v in _wanted_labels(pod).items():
            if node_labels.get(k) != v:
                return False, [REASONS["CheckServiceAffinity"]]
        return True, []

    pred.predicate_name = "CheckServiceAffinity"
    return pred


# --- inter-pod affinity ------------------------------------------------------


class ClusterView:
    """All NodeInfos, with an optional override for the node under test —
    preemption's what-if simulation clones one NodeInfo
    (generic_scheduler.go:898) while affinity still reads the rest of the
    cluster unmodified."""

    def __init__(self, node_infos: Dict[str, NodeInfo],
                 override: Optional[NodeInfo] = None):
        self.node_infos = node_infos
        self.override = override

    def get(self, name: str) -> Optional[NodeInfo]:
        ov = self.override
        if ov is not None and ov.node is not None and ov.node.name == name:
            return ov
        return self.node_infos.get(name)

    def iter_pods(self):
        ov_name = (self.override.node.name
                   if self.override is not None and self.override.node is not None
                   else None)
        for name, ni in self.node_infos.items():
            ni = self.override if name == ov_name else ni
            for p in ni.pods:
                yield p, ni
        if ov_name is not None and ov_name not in self.node_infos:
            for p in self.override.pods:
                yield p, self.override


def nodes_same_topology(node_a, node_b, topology_key: str) -> bool:
    """priorities/util/topologies.go:56 NodesHaveSameTopologyKey."""
    if not topology_key or node_a is None or node_b is None:
        return False
    a = node_a.metadata.labels.get(topology_key)
    b = node_b.metadata.labels.get(topology_key)
    return a is not None and b is not None and a == b


def _term_namespaces(owner: api.Pod, term: api.PodAffinityTerm):
    """priorities/util/topologies.go:30 GetNamespacesFromPodAffinityTerm."""
    return set(term.namespaces) if term.namespaces else {owner.namespace}


def _pod_matches_all_term_props(target: api.Pod, owner: api.Pod,
                                terms: Sequence[api.PodAffinityTerm]) -> bool:
    """predicates/utils.go podMatchesAffinityTermProperties — target must
    match ALL terms' (namespaces, selector); nil selector matches nothing."""
    if not terms:
        return False
    for term in terms:
        if target.namespace not in _term_namespaces(owner, term):
            return False
        if term.label_selector is None or \
                not term.label_selector.matches(target.metadata.labels):
            return False
    return True


def _affinity_terms(pod: api.Pod):
    aff = pod.spec.affinity
    return list(aff.pod_affinity.required) if aff and aff.pod_affinity else []


def _anti_affinity_terms(pod: api.Pod):
    aff = pod.spec.affinity
    return list(aff.pod_anti_affinity.required) if aff and aff.pod_anti_affinity else []


def _satisfies_existing_anti(pod: api.Pod, node, view: ClusterView) -> bool:
    """predicates.go:1310 satisfiesExistingPodsAntiAffinity (metadata-path
    behavior): no existing pod may carry a required anti-affinity term that
    matches <pod> while its node shares the term's topology with <node>."""
    for existing, eni in view.iter_pods():
        for term in _anti_affinity_terms(existing):
            if pod.namespace not in _term_namespaces(existing, term):
                continue
            if term.label_selector is None or \
                    not term.label_selector.matches(pod.metadata.labels):
                continue
            if nodes_same_topology(node, eni.node, term.topology_key):
                return False
    return True


def _any_anchor_matches(pod: api.Pod, node, view: ClusterView,
                        terms: Sequence[api.PodAffinityTerm]) -> Tuple[bool, bool]:
    """predicates.go:1360 anyPodsMatchingTopologyTerms over the
    metadata-style matching-pod map. Returns (topology_match_exists,
    any_pod_matches_properties)."""
    any_props = False
    for existing, eni in view.iter_pods():
        if not _pod_matches_all_term_props(existing, pod, terms):
            continue
        any_props = True
        if all(nodes_same_topology(node, eni.node, t.topology_key) for t in terms):
            return True, True
    return False, any_props


def interpod_affinity_predicate(pod: api.Pod, ni: NodeInfo,
                                view: ClusterView) -> PredicateResult:
    """predicates.go:1115 InterPodAffinityMatches (metadata path)."""
    node = ni.node
    if node is None:
        return False, [REASONS["NodeUnknownCondition"]]
    if not _satisfies_existing_anti(pod, node, view):
        return False, [REASONS["MatchInterPodAffinity"]]
    aff_terms = _affinity_terms(pod)
    if aff_terms:
        ok, any_props = _any_anchor_matches(pod, node, view, aff_terms)
        if not ok:
            # bootstrap rule (predicates.go:1409): the first pod of a
            # self-affine group may schedule anywhere
            if not (not any_props
                    and _pod_matches_all_term_props(pod, pod, aff_terms)):
                return False, [REASONS["MatchInterPodAffinity"]]
    anti_terms = _anti_affinity_terms(pod)
    if anti_terms:
        hit, _ = _any_anchor_matches(pod, node, view, anti_terms)
        if hit:
            return False, [REASONS["MatchInterPodAffinity"]]
    return True, []


def has_hard_spread(pod: api.Pod) -> bool:
    """True when the pod carries any DoNotSchedule topology spread
    constraint — callers that need the cluster-wide what-if view
    (preemption) key off this, exactly like with_affinity."""
    return any(c.when_unsatisfiable == api.DO_NOT_SCHEDULE
               for c in (pod.spec.topology_spread_constraints or ()))


def topology_spread_predicate(pod: api.Pod, ni: NodeInfo,
                              view: ClusterView) -> PredicateResult:
    """PodTopologySpread filter (forward-port; upstream plugin's Filter
    phase) for the host what-if paths — the scalar mirror of the dense
    hard-mask plane in ops/kernel.py, with the SAME documented
    simplifications (ops/topology.py module doc): the global minimum
    reduces over domains of ALL nodes carrying the key (empty domains
    pull it down), a nil selector matches nothing, and the incoming pod
    counts itself only when it matches its own selector (selfMatchNum).
    Nodes missing the constraint's key fail hard, and counted pods are
    live (no deletion timestamp) same-namespace matches — matching
    pm.valid & pm.alive on the device plane. Preemption's clone/reprieve
    loop reads the override node through `view`, so victim removal
    lowers that domain's count exactly like meta.RemovePod upstream."""
    cons = [c for c in (pod.spec.topology_spread_constraints or ())
            if c.when_unsatisfiable == api.DO_NOT_SCHEDULE]
    if not cons:
        return True, []
    node = ni.node
    if node is None:
        return False, [REASONS["NodeUnknownCondition"]]
    ov = view.override
    ov_name = (ov.node.name if ov is not None and ov.node is not None
               else None)
    for c in cons:
        key = c.topology_key
        dom = node.metadata.labels.get(key) if key else None
        if dom is None:
            return False, [REASONS["PodTopologySpread"]]
        # domains enumerated from the node set (value -> matching count)
        counts: Dict[str, int] = {}
        for name, vni in view.node_infos.items():
            vni = ov if name == ov_name else vni
            if vni.node is None:
                continue
            d = vni.node.metadata.labels.get(key)
            if d is not None:
                counts.setdefault(d, 0)
        if ov_name is not None and ov_name not in view.node_infos \
                and ov.node is not None:
            d = ov.node.metadata.labels.get(key)
            if d is not None:
                counts.setdefault(d, 0)
        for p, eni in view.iter_pods():
            if (eni.node is None or p.namespace != pod.namespace
                    or p.metadata.deletion_timestamp is not None):
                continue
            d = eni.node.metadata.labels.get(key)
            if (d in counts and c.label_selector is not None
                    and c.label_selector.matches(p.metadata.labels)):
                counts[d] += 1
        minm = min(counts.values()) if counts else 0
        selfm = int(c.label_selector is not None
                    and c.label_selector.matches(pod.metadata.labels))
        if counts.get(dom, 0) + selfm - minm > c.max_skew:
            return False, [REASONS["PodTopologySpread"]]
    return True, []


def interpod_affinity_priority(pod: api.Pod, feasible: Sequence[NodeInfo],
                               view: ClusterView,
                               hard_weight: int = 1) -> Dict[str, int]:
    """priorities/interpod_affinity.go:118 CalculateInterPodAffinityPriority.
    feasible: NodeInfos of filtered nodes; returns node -> 0..10."""
    aff = pod.spec.affinity
    pref_aff = list(aff.pod_affinity.preferred) if aff and aff.pod_affinity else []
    pref_anti = (list(aff.pod_anti_affinity.preferred)
                 if aff and aff.pod_anti_affinity else [])
    counts: Dict[str, float] = {ni.node.name: 0.0 for ni in feasible if ni.node}

    def process(term: api.PodAffinityTerm, owner: api.Pod, to_check: api.Pod,
                fixed_node, weight: float):
        if to_check.namespace not in _term_namespaces(owner, term):
            return
        if term.label_selector is None or \
                not term.label_selector.matches(to_check.metadata.labels):
            return
        for ni in feasible:
            if ni.node is not None and nodes_same_topology(
                    ni.node, fixed_node, term.topology_key):
                counts[ni.node.name] += weight

    for existing, eni in view.iter_pods():
        for wt in pref_aff:
            process(wt.pod_affinity_term, pod, existing, eni.node, float(wt.weight))
        for wt in pref_anti:
            process(wt.pod_affinity_term, pod, existing, eni.node, -float(wt.weight))
        eaff = existing.spec.affinity
        if eaff and eaff.pod_affinity:
            if hard_weight > 0:
                for term in eaff.pod_affinity.required:
                    process(term, existing, pod, eni.node, float(hard_weight))
            for wt in eaff.pod_affinity.preferred:
                process(wt.pod_affinity_term, existing, pod, eni.node,
                        float(wt.weight))
        if eaff and eaff.pod_anti_affinity:
            for wt in eaff.pod_anti_affinity.preferred:
                process(wt.pod_affinity_term, existing, pod, eni.node,
                        -float(wt.weight))

    max_c = max(list(counts.values()) + [0.0])
    min_c = min(list(counts.values()) + [0.0])
    out = {}
    for name, c in counts.items():
        out[name] = (int(10.0 * (c - min_c) / (max_c - min_c))
                     if max_c != min_c else 0)
    return out


# GeneralPredicates (predicates.go:1031): resources + host + ports + selector.
def general_predicates(pod: api.Pod, ni: NodeInfo) -> PredicateResult:
    fits, reasons = True, []
    for p in (pod_fits_resources, pod_fits_host, pod_fits_host_ports,
              pod_matches_node_selector):
        ok, r = p(pod, ni)
        fits &= ok
        reasons.extend(r)
    return fits, reasons


# Ordered as the reference's predicatesOrdering (predicates.go:133),
# with GeneralPredicates expanded to its members.
ORDERED_PREDICATES: List[Tuple[str, Callable[[api.Pod, NodeInfo], PredicateResult]]] = [
    ("CheckNodeCondition", check_node_condition),
    ("PodFitsResources", pod_fits_resources),
    ("HostName", pod_fits_host),
    ("PodFitsHostPorts", pod_fits_host_ports),
    ("MatchNodeSelector", pod_matches_node_selector),
    ("NoDiskConflict", no_disk_conflict),
    ("PodToleratesNodeTaints", pod_tolerates_node_taints),
    ("CheckNodeMemoryPressure", check_node_memory_pressure),
    ("CheckNodePIDPressure", check_node_pid_pressure),
    ("CheckNodeDiskPressure", check_node_disk_pressure),
]


def pod_fits_on_node(pod: api.Pod, ni: NodeInfo,
                     always_check_all: bool = False,
                     view: Optional[ClusterView] = None) -> PredicateResult:
    """Reference: generic_scheduler.go:456 podFitsOnNode inner loop with
    short-circuit ordering (:503). view enables MatchInterPodAffinity
    (last in predicatesOrdering, predicates.go:139)."""
    reasons: List[str] = []
    for name, pred in ORDERED_PREDICATES:
        ok, r = pred(pod, ni)
        if not ok:
            reasons.extend(r)
            if not always_check_all:
                break
    if view is not None and not reasons:
        ok, r = interpod_affinity_predicate(pod, ni, view)
        if not ok:
            reasons.extend(r)
        if not reasons:
            ok, r = topology_spread_predicate(pod, ni, view)
            if not ok:
                reasons.extend(r)
    return not reasons, reasons


# --- priorities (Map phase; ints) -------------------------------------------


def least_requested_map(pod: api.Pod, ni: NodeInfo) -> int:
    cpu, mem = api.get_nonzero_requests(pod)
    return _resource_score(ni, cpu, mem, _least)


def most_requested_map(pod: api.Pod, ni: NodeInfo) -> int:
    cpu, mem = api.get_nonzero_requests(pod)
    return _resource_score(ni, cpu, mem, _most)


def _least(requested: int, capacity: int) -> int:
    if capacity == 0 or requested > capacity:
        return 0
    return (capacity - requested) * 10 // capacity


def _most(requested: int, capacity: int) -> int:
    if capacity == 0 or requested > capacity:
        return 0
    return requested * 10 // capacity


def _resource_score(ni: NodeInfo, cpu: int, mem: int, f) -> int:
    rc = ni.nonzero_milli_cpu + cpu
    rm = ni.nonzero_memory + mem
    return (f(rc, ni.allocatable.milli_cpu) + f(rm, ni.allocatable.memory)) // 2


def balanced_allocation_map(pod: api.Pod, ni: NodeInfo) -> int:
    cpu, mem = api.get_nonzero_requests(pod)
    rc = ni.nonzero_milli_cpu + cpu
    rm = ni.nonzero_memory + mem
    cf = rc / ni.allocatable.milli_cpu if ni.allocatable.milli_cpu else 1.0
    mf = rm / ni.allocatable.memory if ni.allocatable.memory else 1.0
    if cf >= 1 or mf >= 1:
        return 0
    return int((1 - abs(cf - mf)) * 10)


def node_affinity_map(pod: api.Pod, ni: NodeInfo) -> int:
    """priorities/node_affinity.go:34 — sum of matched preferred weights."""
    aff = pod.spec.affinity
    if not (aff and aff.node_affinity):
        return 0
    count = 0
    for term in aff.node_affinity.preferred:
        if term.weight == 0:
            continue
        sel = lbl.Selector(tuple(term.preference.match_expressions))
        if ni.node is not None and sel.matches(ni.node.metadata.labels):
            count += term.weight
    return count


def taint_toleration_map(pod: api.Pod, ni: NodeInfo) -> int:
    """priorities/taint_toleration.go:55 — # intolerable PreferNoSchedule."""
    eligible = [t for t in pod.spec.tolerations
                if not t.effect or t.effect == api.PREFER_NO_SCHEDULE]
    count = 0
    for taint in ni.taints:
        if taint.effect != api.PREFER_NO_SCHEDULE:
            continue
        if not api.tolerations_tolerate_taint(eligible, taint):
            count += 1
    return count


def selector_spread_map(pod: api.Pod, ni: NodeInfo,
                        selectors: Sequence[lbl.Selector]) -> int:
    """priorities/selector_spreading.go:66."""
    if not selectors:
        return 0
    count = 0
    for np_ in ni.pods:
        if np_.namespace != pod.namespace or np_.metadata.deletion_timestamp is not None:
            continue
        if any(s.matches(np_.metadata.labels) for s in selectors):
            count += 1
    return count


def selector_spread_reduce(counts: Dict[str, int], zones: Dict[str, str]) -> Dict[str, int]:
    """priorities/selector_spreading.go:122 — counts: node -> matched pods;
    zones: node -> zone key ('' if none). Returns node -> 0..10."""
    max_node = max(counts.values(), default=0)
    zone_counts: Dict[str, int] = {}
    for n, c in counts.items():
        z = zones.get(n, "")
        if z:
            zone_counts[z] = zone_counts.get(z, 0) + c
    max_zone = max(zone_counts.values(), default=0)
    have_zones = len(zone_counts) > 0
    out = {}
    for n, c in counts.items():
        f = 10.0
        if max_node > 0:
            f = 10.0 * (max_node - c) / max_node
        z = zones.get(n, "")
        if have_zones and z:
            zs = 10.0
            if max_zone > 0:
                zs = 10.0 * (max_zone - zone_counts[z]) / max_zone
            f = f * (1.0 / 3.0) + (2.0 / 3.0) * zs
        out[n] = int(f)
    return out


def image_locality_map(pod: api.Pod, ni: NodeInfo) -> int:
    """priorities/image_locality.go:39."""
    total = sum(ni.image_sizes.get(c.image, 0) for c in pod.spec.containers)
    mb = 1024 * 1024
    if total == 0 or total < 23 * mb:
        return 0
    if total >= 1000 * mb:
        return 10
    return int(10 * (total - 23 * mb) // (1000 * mb - 23 * mb)) + 1


def equal_priority_map(pod: api.Pod, ni: NodeInfo) -> int:
    """core/generic_scheduler.go:1072 EqualPriorityMap — constant 1."""
    return 1


def resource_limits_map(pod: api.Pod, ni: NodeInfo) -> int:
    """priorities/resource_limits.go:36 ResourceLimitsPriorityMap: score 1
    if the node's allocatable satisfies the pod's (non-zero) cpu+memory
    limits, else 0."""
    cpu = mem = 0
    for c in pod.spec.containers:
        cpu += c.resources.limits.get(res.CPU, 0)
        mem += c.resources.limits.get(res.MEMORY, 0)
    if cpu == 0 and mem == 0:
        return 0
    cpu_ok = cpu == 0 or ni.allocatable.milli_cpu >= cpu
    mem_ok = mem == 0 or ni.allocatable.memory >= mem
    return 1 if (cpu_ok and mem_ok) else 0


def new_node_label_priority(label: str, presence: bool):
    """priorities/node_label.go:47 CalculateNodeLabelPriorityMap: 10 when
    label presence matches the preference, else 0. Policy-configured
    (LabelPreference argument)."""

    def score(pod: api.Pod, ni: NodeInfo) -> int:
        if ni.node is None:
            return 0
        exists = label in (ni.node.metadata.labels or {})
        return 10 if exists == presence else 0

    score.priority_name = "NodeLabelPriority"
    return score


def new_service_anti_affinity(store, label: str):
    """priorities/selector_spreading.go:184 ServiceAntiAffinity: spread
    pods of a service across values of a node label. Map counts the
    service's pods on each node; Reduce groups by label value and scores
    10*(max-group)/max (selector_spreading.go:221 CalculateAntiAffinityPriorityReduce)."""

    def service_selectors(pod: api.Pod) -> List[lbl.Selector]:
        return [lbl.Selector.from_set(svc.selector)
                for svc in store.list("services", pod.namespace)
                if svc.selector and lbl.Selector.from_set(svc.selector).matches(
                    pod.metadata.labels)]

    def score_nodes(pod: api.Pod, node_infos: Dict[str, NodeInfo]) -> Dict[str, int]:
        sels = service_selectors(pod)
        counts: Dict[str, int] = {}
        for name, ni in node_infos.items():
            c = 0
            if sels:
                for p in ni.pods:
                    if p.namespace == pod.namespace and \
                            any(s.matches(p.metadata.labels) for s in sels):
                        c += 1
            counts[name] = c
        # group by label value
        group: Dict[str, int] = {}
        for name, ni in node_infos.items():
            v = (ni.node.metadata.labels or {}).get(label, "") if ni.node else ""
            group[v] = group.get(v, 0) + counts[name]
        max_g = max(group.values(), default=0)
        out = {}
        for name, ni in node_infos.items():
            v = (ni.node.metadata.labels or {}).get(label, "") if ni.node else ""
            out[name] = (10 * (max_g - group[v]) // max_g) if max_g > 0 else 0
        return out

    score_nodes.priority_name = "ServiceAntiAffinityPriority"
    return score_nodes


def normalize_reduce(scores: Dict[str, int], reverse: bool) -> Dict[str, int]:
    """priorities/reduce.go:29 NormalizeReduce(10, reverse)."""
    max_count = max(scores.values(), default=0)
    if max_count == 0:
        return {n: (10 if reverse else 0) for n in scores}
    out = {}
    for n, s in scores.items():
        v = 10 * s // max_count
        out[n] = 10 - v if reverse else v
    return out
