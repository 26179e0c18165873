"""Feature gates (reference: pkg/features/kube_features.go:298
defaultKubernetesFeatureGates + apiserver feature_gate.go). Parsed from
a "Name=true,Other=false" string like --feature-gates."""

from __future__ import annotations

from typing import Dict

# Scheduling-relevant defaults from the reference's v1.11-dev gate table.
DEFAULT_FEATURES: Dict[str, bool] = {
    "PodPriority": True,  # alpha->beta in 1.11; priority queue + preemption
    "TaintNodesByCondition": False,
    "VolumeScheduling": False,
    "BalanceAttachedNodeVolumes": False,
    "EnableEquivalenceClassCache": False,
    "ResourceLimitsPriorityFunction": False,
    "ScheduleDaemonSetPods": False,
    # framework-specific gates
    "TPUWaveScheduling": True,  # batch wavefronts on device
    "TPUShardedScoring": False,  # pjit over the nodes axis (parallel/)
}


class FeatureGates:
    def __init__(self, overrides: Dict[str, bool] = None):
        self._gates = dict(DEFAULT_FEATURES)
        if overrides:
            self._gates.update(overrides)

    @staticmethod
    def parse(spec: str) -> "FeatureGates":
        overrides = {}
        for part in filter(None, (s.strip() for s in spec.split(","))):
            name, _, val = part.partition("=")
            overrides[name] = val.strip().lower() in ("true", "1", "yes", "")
        return FeatureGates(overrides)

    def enabled(self, name: str) -> bool:
        return self._gates.get(name, False)

    def set(self, name: str, value: bool):
        self._gates[name] = value
