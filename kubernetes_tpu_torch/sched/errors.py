"""Scheduling failure reasons and FitError.

Reason strings mirror the reference exactly (pkg/scheduler/algorithm/
predicates/error.go:35-79; FitError message format
pkg/scheduler/core/generic_scheduler.go:62-84) because preemption's
unresolvable-reason filter and user-facing events key off them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

# predicate name -> human reason (error.go)
REASONS = {
    "NoDiskConflict": "node(s) had no available disk",
    "NoVolumeZoneConflict": "node(s) had no available volume zone",
    "MatchNodeSelector": "node(s) didn't match node selector",
    "MatchInterPodAffinity": "node(s) didn't match pod affinity/anti-affinity",
    "PodToleratesNodeTaints": "node(s) had taints that the pod didn't tolerate",
    "HostName": "node(s) didn't match the requested hostname",
    "PodFitsHostPorts": "node(s) didn't have free ports for the requested pod ports",
    "CheckNodeLabelPresence": "node(s) didn't have the requested labels",
    "CheckServiceAffinity": "node(s) didn't match service affinity",
    "MaxVolumeCount": "node(s) exceed max volume count",
    "NodeUnderMemoryPressure": "node(s) had memory pressure",
    "NodeUnderDiskPressure": "node(s) had disk pressure",
    "NodeUnderPIDPressure": "node(s) had pid pressure",
    "NodeOutOfDisk": "node(s) were out of disk space",
    "NodeNotReady": "node(s) were not ready",
    "NodeNetworkUnavailable": "node(s) had unavailable network",
    "NodeUnschedulable": "node(s) were unschedulable",
    "NodeUnknownCondition": "node(s) had unknown conditions",
    "VolumeNodeAffinityConflict": "node(s) had volume node affinity conflict",
    "VolumeBindingNoMatch": "node(s) didn't find available persistent volumes to bind",
    # gang scheduling (forward-port, sched/gang.py): the joint-assignment
    # scan could not place minMember pods simultaneously. Deliberately
    # NOT in UNRESOLVABLE — evicting victims can free gang capacity.
    "Gang": "pod group could not be placed in full",
    # PodTopologySpread (forward-port, ops/topology.py + the golden
    # predicate): reason string matches the plugin's
    # ErrReasonConstraintsNotMatch. Deliberately NOT in UNRESOLVABLE —
    # evicting matching pods from a crowded domain reduces its skew.
    "PodTopologySpread":
        "node(s) didn't match pod topology spread constraints",
    # poison-work isolation (forward-port of 1.11's per-pod predicate
    # error returns to the batched plane): the pod's spec crashed or
    # numerically poisoned the shared Filter+Score pass and the pod was
    # quarantined — the reason on its FitError-style condition/event.
    "Poisoned": "pod spec poisoned the batched scheduling pass "
                "(quarantined)",
}

# Failure reasons preemption cannot resolve by evicting pods — EXACTLY the
# reference's switch list (generic_scheduler.go:980-996); note pressure
# predicates and OutOfDisk are deliberately absent there. Keys are
# predicate/error names as produced by the device mask stack and golden
# predicates.
UNRESOLVABLE = frozenset({
    "MatchNodeSelector",  # ErrNodeSelectorNotMatch
    "HostName",  # ErrPodNotMatchHostName
    "PodToleratesNodeTaints",  # ErrTaintsTolerationsNotMatch
    "CheckNodeLabelPresence",  # ErrNodeLabelPresenceViolated
    "NodeNotReady",
    "NodeNetworkUnavailable",
    "NodeUnschedulable",  # also the CheckNodeUnschedulable mask
    "CheckNodeUnschedulable",
    "NodeUnknownCondition",
    "NoVolumeZoneConflict",  # ErrVolumeZoneConflict
    "VolumeNodeAffinityConflict",
    "VolumeBindingNoMatch",
    # Extender filter rejections: conservative — evicting victims cannot be
    # shown to help a node an extender rejected, unless the extender itself
    # participates in preemption (process_preemption_with_extenders), which
    # operates on the remaining candidates anyway.
    "ExtenderFilter",
})


# Reverse lookup: human reason string -> predicate/error key. Built once;
# REASONS values are unique by construction.
REASON_KEYS = {v: k for k, v in REASONS.items()}


def insufficient_resource_reason(resource: str) -> str:
    """Reference: predicates.go NewInsufficientResourceError .GetReason()."""
    return f"Insufficient {resource}"


class PoisonError(Exception):
    """Input-fault verdict for a failed batched pass: the WORK is bad,
    not the runtime (the numpy twin reproduced the failure, or the
    numeric-integrity sentinel flagged non-finite planes). `uids` names
    the convicted pods when attribution is direct; empty means the
    culprit is unknown and the caller must bisect the wave."""

    def __init__(self, message: str, uids=()):
        super().__init__(message)
        self.uids = tuple(uids)


@dataclass
class FitError(Exception):
    """Reference: generic_scheduler.go:52 FitError / :82 Error()."""

    pod_name: str
    num_all_nodes: int
    # reason string -> number of nodes that failed with it
    failed_predicates: Dict[str, int] = field(default_factory=dict)

    def message(self) -> str:
        # sort by REASON string (reference sortReasonsHistogram,
        # generic_scheduler.go:72) — sorting the formatted "{count}
        # {reason}" strings compared lexically on the count, putting
        # "10 node(s)..." before "2 node(s)..."
        reasons = [f"{self.failed_predicates[reason]} {reason}"
                   for reason in sorted(self.failed_predicates)
                   if self.failed_predicates[reason]]
        return (f"0/{self.num_all_nodes} nodes are available: "
                f"{', '.join(reasons)}.")

    def __str__(self):
        return self.message()
