"""Pod garbage collection.

A copy of kubernetes_tpu/controllers/podgc.py; its relative imports
resolve in this package.

Reference: pkg/controller/podgc/gc_controller.go (gc:75 —
gcTerminated: keep at most `terminated_threshold` Succeeded/Failed pods;
gcOrphaned: delete pods bound to nodes that no longer exist;
gcUnscheduledTerminating: terminating pods never scheduled).
"""

from __future__ import annotations

from .base import Controller


class PodGCController(Controller):
    name = "podgc"

    def __init__(self, store, terminated_threshold: int = 100):
        super().__init__(store)
        self.terminated_threshold = terminated_threshold

    def sync(self, key: str):
        self.gc()

    def gc(self) -> int:
        deleted = 0
        pods = self.store.list("pods")
        node_names = {n.metadata.name for n in self.store.list("nodes")}
        # terminated beyond threshold, oldest (lowest rv) first
        terminated = sorted(
            (p for p in pods if p.status.phase in ("Succeeded", "Failed")),
            key=lambda p: p.metadata.resource_version)
        excess = len(terminated) - self.terminated_threshold
        for p in terminated[:max(0, excess)]:
            deleted += self._delete(p)
        for p in pods:
            if p.spec.node_name and p.spec.node_name not in node_names:
                deleted += self._delete(p)  # orphaned by node deletion
            elif p.metadata.deletion_timestamp is not None and \
                    not p.spec.node_name:
                deleted += self._delete(p)  # terminating, never scheduled
        return deleted

    def _delete(self, pod) -> int:
        try:
            self.store.delete("pods", pod.metadata.namespace,
                              pod.metadata.name)
            return 1
        except KeyError:
            return 0
