"""Route controller: program the cloud pod-network route table.

A copy of kubernetes_tpu/controllers/route.py; its relative imports
resolve in this package.

Reference: pkg/controller/route/route_controller.go:103 reconcile —
every node with a podCIDR gets a cloud route (dest=podCIDR →
target=node); routes whose node or CIDR no longer matches are deleted;
once a node's route exists its NetworkUnavailable condition is cleared
(:186 updateNetworkingCondition) so the scheduler's node predicates
admit it.
"""

from __future__ import annotations

from ..api import types as api
from ..cloud.provider import CloudProvider, Route
from .base import Controller


def set_node_condition(node: api.Node, ctype: str, status: str,
                       reason: str = "") -> bool:
    """Upsert one status condition; True if anything changed."""
    for cond in node.status.conditions:
        if cond.type == ctype:
            if cond.status == status:
                return False
            cond.status = status
            cond.reason = reason
            return True
    node.status.conditions.append(api.NodeCondition(ctype, status, reason))
    return True


class RouteController(Controller):
    name = "route"

    def __init__(self, store, cloud: CloudProvider, cluster_name: str = "tpu"):
        super().__init__(store)
        routes = cloud.routes()
        if routes is None:
            raise ValueError("cloud provider does not support routes")
        self.routes = routes
        self.cluster_name = cluster_name
        # any node event re-runs the whole reconcile: the route table is
        # global state, per-key sync would race against deletions
        self.informer("nodes", enqueue_fn=lambda *_: self.enqueue("all/all"))
        self.enqueue("all/all")

    def resync(self):
        self.enqueue("all/all")

    def sync(self, key: str):
        self.reconcile()

    def reconcile(self):
        nodes = self.store.list("nodes")
        want = {(n.name, n.spec.pod_cidr) for n in nodes if n.spec.pod_cidr}
        have = {(r.target_node, r.dest_cidr): r
                for r in self.routes.list_routes(self.cluster_name)}
        # routed reflects what the CLOUD actually holds after this pass,
        # not what we intended: a failed create must leave its node
        # NetworkUnavailable=True so the scheduler's node predicates keep
        # pods off it (ref updateNetworkingCondition on the create error
        # path, route_controller.go:186)
        routed = {t for t, c in want if (t, c) in have}
        errors = 0
        # sorted: create/delete order must not follow set hash order —
        # a mid-pass failure would otherwise leave a different prefix of
        # routes materialized run-to-run
        for target, cidr in sorted(want - set(have)):
            try:
                self.routes.create_route(
                    self.cluster_name, f"{target}-{cidr}",
                    Route(name=f"{target}-{cidr}", target_node=target,
                          dest_cidr=cidr))
                routed.add(target)
            except Exception:
                errors += 1
        for stale in sorted(set(have) - want):
            try:
                self.routes.delete_route(self.cluster_name, have[stale])
            except Exception:
                errors += 1
        for node in nodes:
            if not node.spec.pod_cidr:
                continue  # ipam hasn't run; ref skips such nodes too
            reachable = node.name in routed
            changed = set_node_condition(
                node, api.NODE_NETWORK_UNAVAILABLE,
                api.COND_FALSE if reachable else api.COND_TRUE,
                reason="RouteCreated" if reachable else "NoRouteCreated")
            if changed:
                self.store.update("nodes", node)
        if errors:
            raise RuntimeError(f"{errors} route operation(s) failed")
