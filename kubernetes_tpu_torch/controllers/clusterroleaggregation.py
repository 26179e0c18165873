"""ClusterRole aggregation controller.

A copy of kubernetes_tpu/controllers/clusterroleaggregation.py; its relative imports
resolve in this package.

Reference: pkg/controller/clusterroleaggregation/clusterroleaggregation_
controller.go — a ClusterRole carrying an aggregationRule owns no rules
of its own: the controller maintains its rules as the union of every
ClusterRole matching the rule's label selectors (how admin/edit/view
pick up CRD-shipped permission fragments). Any labeled-role change
re-enqueues every aggregating role.
"""

from __future__ import annotations

from typing import List

from ..api import types as api
from .base import Controller


def _rule_key(r: api.RBACPolicyRule):
    return (tuple(r.verbs or ()), tuple(r.api_groups or ()),
            tuple(r.resources or ()), tuple(r.resource_names or ()),
            tuple(r.non_resource_urls or ()))


class ClusterRoleAggregationController(Controller):
    name = "clusterroleaggregation"

    def __init__(self, store):
        super().__init__(store)
        self.informer("clusterroles",
                      enqueue_fn=lambda o=None, n=None:
                      self._enqueue_aggregating())

    def _enqueue_aggregating(self):
        for role in self.store.list("clusterroles"):
            if role.aggregation_selectors:
                self.enqueue(role)

    def sync(self, key: str):
        _, name = key.split("/", 1)
        role = self.store.get("clusterroles", "", name)
        if role is None or not role.aggregation_selectors:
            return
        union: List[api.RBACPolicyRule] = []
        seen = set()
        for other in sorted(self.store.list("clusterroles"),
                            key=lambda r: r.metadata.name):
            if other.metadata.name == role.metadata.name:
                continue
            labels = other.metadata.labels or {}
            if not any(sel.to_selector().matches(labels)
                       for sel in role.aggregation_selectors):
                continue
            for r in other.rules:
                k = _rule_key(r)
                if k not in seen:
                    seen.add(k)
                    union.append(r)
        if [_rule_key(r) for r in role.rules] == [_rule_key(r)
                                                 for r in union]:
            return
        role.rules = union
        self.store.update("clusterroles", role)
