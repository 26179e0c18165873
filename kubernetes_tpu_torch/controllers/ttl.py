"""TTL controller: scale node object-cache TTL hints with cluster size.

A copy of kubernetes_tpu/controllers/ttl.py; its relative imports
resolve in this package.

Reference: pkg/controller/ttl/ttl_controller.go — kubelets cache
secrets/configmaps with a TTL the control plane announces via the
`node.alpha.kubernetes.io/ttl` annotation; bigger clusters get longer
TTLs to shed apiserver load (ttl_controller.go:50 ttlBoundaries).
"""

from __future__ import annotations

from .base import Controller

TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"

# (cluster size threshold, ttl seconds) — ttl_controller.go:58
TTL_BOUNDARIES = [
    (100, 0),
    (500, 15),
    (1000, 30),
    (5000, 60),
    (float("inf"), 300),
]


def ttl_for_size(n_nodes: int) -> int:
    for bound, ttl in TTL_BOUNDARIES:
        if n_nodes <= bound:
            return ttl
    return 300


class TTLController(Controller):
    name = "ttl"

    def __init__(self, store):
        super().__init__(store)
        self.informer("nodes")

    def resync(self):
        for node in self.store.list("nodes"):
            self.enqueue(node)

    def sync(self, key: str):
        _, name = key.split("/", 1)
        node = (self.store.get("nodes", "default", name)
                or self.store.get("nodes", "", name))
        if node is None:
            return
        want = str(ttl_for_size(self.store.count("nodes")))
        ann = node.metadata.annotations
        if ann.get(TTL_ANNOTATION) == want:
            return
        ann[TTL_ANNOTATION] = want
        self.store.update("nodes", node)
