"""Extension-point registry and profiles.

Modern extension-point names (PreFilter/Filter/Score/NormalizeScore) over
the reference's registry mechanics (pkg/scheduler/factory/plugins.go
RegisterFitPredicate / RegisterPriorityConfigFactory and the provider
registry in pkg/scheduler/algorithmprovider/defaults/defaults.go:105).

A profile selects which Filter plugins run on-device (the tensorized
set, ops/filters.py), which run host-side (plugins/golden.py +
plugins/volumes.py callables), the Score weight vector compiled into the
wave kernel (ops/kernel.py Weights), and host-side Score plugins folded
into the device argmax via the kernel's extra_scores input. A
Policy-JSON analog (pkg/scheduler/api/types.go) can override the
default provider, including the reference's configurable predicate/
priority *arguments* (labelsPresence, serviceAffinity, labelPreference,
serviceAntiAffinity — api/types.go PredicateArgument/PriorityArgument).

A copy of kubernetes_tpu/plugins/registry.py whose imports point at this
package. A Policy's `extenders` build the port's own HTTPExtender
(sched/extender.py), one per ExtenderConfig, in the Policy's order.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api import types as api
from ..ops.encoding import DEVICE_PREDICATES
from ..ops.kernel import Weights
from ..state.node_info import NodeInfo
from . import golden, volumes

HostPredicate = Callable[[api.Pod, NodeInfo], golden.PredicateResult]
# Cluster-shaped host Score: (pod, node_infos) -> {node: 0..10}
HostScore = Callable[[api.Pod, Dict[str, NodeInfo]], Dict[str, int]]

# score plugin name -> Weights field (device-compiled priorities)
_SCORE_FIELDS = {
    "LeastRequestedPriority": "least_requested",
    "BalancedResourceAllocation": "balanced",
    "MostRequestedPriority": "most_requested",
    "NodeAffinityPriority": "node_affinity",
    "TaintTolerationPriority": "taint_toleration",
    "SelectorSpreadPriority": "selector_spread",
    "NodePreferAvoidPodsPriority": "prefer_avoid",
    "ImageLocalityPriority": "image_locality",
    "InterPodAffinityPriority": "interpod",
    # forward-ported topology planes (ops/topology.py)
    "PodTopologySpreadPriority": "topology_spread",
    "TopologyCompactnessPriority": "topology_compactness",
}


def _per_node_score(fn: Callable[[api.Pod, NodeInfo], int]) -> HostScore:
    def score(pod: api.Pod, node_infos: Dict[str, NodeInfo]) -> Dict[str, int]:
        return {name: fn(pod, ni) for name, ni in node_infos.items()}

    return score


@dataclass
class Profile:
    """One scheduler profile (multi-profile sharding by schedulerName is
    the reference's multi-scheduler mechanism, factory.go:1211)."""

    scheduler_name: str = "default-scheduler"
    device_filters: List[str] = field(default_factory=lambda: list(DEVICE_PREDICATES))
    host_filters: Dict[str, HostPredicate] = field(default_factory=dict)
    score_weights: Dict[str, int] = field(default_factory=dict)
    # host-side Score plugins: name -> (fn, weight); folded into the wave
    # kernel through its extra_scores input
    host_scores: Dict[str, Tuple[HostScore, int]] = field(default_factory=dict)
    extenders: List[object] = field(default_factory=list)
    disable_preemption: bool = False
    # componentconfig HardPodAffinitySymmetricWeight (default 1,
    # pkg/apis/componentconfig/types.go:79)
    hard_pod_affinity_symmetric_weight: int = 1

    def weights(self) -> Weights:
        kw = {}
        for plugin, w in self.score_weights.items():
            f = _SCORE_FIELDS.get(plugin)
            if f is not None:
                kw[f] = float(w)
        base = {f: 0.0 for f in Weights._fields}
        base.update(kw)
        base["hard_pod_affinity"] = float(self.hard_pod_affinity_symmetric_weight)
        return Weights(**base)


def default_profile(store=None) -> Profile:
    """Reference default provider (algorithmprovider/defaults/defaults.go:105
    defaultPredicates, :219 defaultPriorities). With a store, the volume
    predicate set (MaxEBS/MaxGCEPD/MaxAzureDisk, NoVolumeZoneConflict,
    CheckVolumeBinding) is wired in as host plugins."""
    host_filters: Dict[str, HostPredicate] = {
        "NoDiskConflict": golden.no_disk_conflict}
    if store is not None:
        host_filters.update(volumes.default_volume_predicates(store))
    return Profile(
        host_filters=host_filters,
        score_weights={
            "SelectorSpreadPriority": 1,
            "InterPodAffinityPriority": 1,
            "LeastRequestedPriority": 1,
            "BalancedResourceAllocation": 1,
            "NodePreferAvoidPodsPriority": 10000,
            "NodeAffinityPriority": 1,
            "TaintTolerationPriority": 1,
            # forward-ported topology planes: spread skew score + gang
            # compactness / accel-gen steering (ops/topology.py)
            "PodTopologySpreadPriority": 1,
            "TopologyCompactnessPriority": 1,
        },
    )


class Registry:
    """Name -> implementation registries, for Policy-file style config."""

    def __init__(self):
        self.host_predicates: Dict[str, HostPredicate] = {
            "NoDiskConflict": golden.no_disk_conflict,
            "GeneralPredicates": golden.general_predicates,
            "PodToleratesNodeNoExecuteTaints": golden.pod_tolerates_no_execute_taints,
        }
        self.device_predicates = set(DEVICE_PREDICATES)
        self.score_plugins = set(_SCORE_FIELDS)
        self.host_score_plugins: Dict[str, HostScore] = {
            "EqualPriority": _per_node_score(golden.equal_priority_map),
            "ResourceLimitsPriority": _per_node_score(golden.resource_limits_map),
        }

    def register_host_predicate(self, name: str, fn: HostPredicate):
        self.host_predicates[name] = fn

    def register_host_score(self, name: str, fn: HostScore):
        self.host_score_plugins[name] = fn

    def _predicate_from_policy(self, p: dict, store,
                               vol: Dict[str, HostPredicate]
                               ) -> Tuple[str, Optional[HostPredicate]]:
        """Resolve one Policy predicate entry, including the reference's
        configurable-predicate arguments (api/types.go PredicateArgument)."""
        name = p["name"]
        arg = p.get("argument") or {}
        if "labelsPresence" in arg:
            a = arg["labelsPresence"]
            return name, golden.new_node_label_presence(
                a.get("labels", []), a.get("presence", True))
        if "serviceAffinity" in arg:
            if store is None:
                raise ValueError("serviceAffinity predicate needs a store")
            return name, golden.new_service_affinity(
                store, arg["serviceAffinity"].get("labels", []))
        if name in self.device_predicates:
            return name, None
        if name in self.host_predicates:
            return name, self.host_predicates[name]
        if name in vol:
            return name, vol[name]
        raise KeyError(f"unknown predicate {name!r}")

    def profile_from_policy(self, policy_json: str, store=None) -> Profile:
        """Build a profile from a Policy JSON document
        (reference: pkg/scheduler/api/types.go Policy)."""
        policy = json.loads(policy_json)
        prof = Profile()
        if policy.get("predicates") is not None:
            vol = (volumes.default_volume_predicates(store)
                   if store is not None else {})
            prof.device_filters = []
            prof.host_filters = {}
            for p in policy["predicates"]:
                name, fn = self._predicate_from_policy(p, store, vol)
                if fn is None:
                    prof.device_filters.append(name)
                else:
                    prof.host_filters[name] = fn
        else:
            prof.device_filters = list(DEVICE_PREDICATES)
            prof.host_filters = default_profile(store).host_filters
        if policy.get("priorities") is not None:
            prof.score_weights = {}
            prof.host_scores = {}
            for p in policy["priorities"]:
                name, weight = p["name"], p.get("weight", 1)
                arg = p.get("argument") or {}
                if "labelPreference" in arg:
                    a = arg["labelPreference"]
                    prof.host_scores[name] = (_per_node_score(
                        golden.new_node_label_priority(
                            a.get("label", ""), a.get("presence", True))), weight)
                elif "serviceAntiAffinity" in arg:
                    if store is None:
                        raise ValueError("serviceAntiAffinity priority needs a store")
                    prof.host_scores[name] = (golden.new_service_anti_affinity(
                        store, arg["serviceAntiAffinity"].get("label", "")), weight)
                elif name in _SCORE_FIELDS:
                    prof.score_weights[name] = weight
                elif name in self.host_score_plugins:
                    prof.host_scores[name] = (self.host_score_plugins[name], weight)
                else:
                    raise KeyError(f"unknown priority {name!r}")
        else:
            prof.score_weights = default_profile().score_weights
        if policy.get("extenders"):
            from ..sched.extender import HTTPExtender

            prof.extenders = [HTTPExtender.from_config(c)
                              for c in policy["extenders"]]
        return prof


default_registry = Registry()
