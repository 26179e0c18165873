"""Namespace lifecycle: cascading teardown on deletion.

A copy of kubernetes_tpu/controllers/namespace.py; its relative imports
resolve in this package.

Reference: pkg/controller/namespace/deletion/namespaced_resources_
deleter.go (Delete:77 — once phase=Terminating, delete all namespaced
content, then remove the 'kubernetes' finalizer and the namespace).
Deletion here is modeled by setting status.phase=Terminating (the
apiserver analog of a delete with finalizers pending).
"""

from __future__ import annotations

from ..runtime.store import Conflict
from .base import Controller

# namespaced kinds the deleter sweeps (deletion/namespaced_resources_
# deleter.go discovers these dynamically; the registry is our discovery)
_SWEEP = ["pods", "services", "replicationcontrollers", "replicasets",
          "statefulsets", "deployments", "daemonsets", "jobs", "cronjobs",
          "endpoints", "poddisruptionbudgets", "persistentvolumeclaims",
          "resourcequotas", "serviceaccounts", "secrets", "configmaps",
          "events"]


class NamespaceController(Controller):
    name = "namespace"

    def __init__(self, store):
        super().__init__(store)
        self.informer("namespaces",
                      on_add=self._ns_event,
                      on_update=lambda o, n: self._ns_event(n),
                      on_delete=lambda o: None)

    def _ns_event(self, ns_obj):
        if ns_obj.status.phase == "Terminating":
            self.queue.add(ns_obj.metadata.name)

    def sync(self, key: str):
        name = key.split("/")[-1]
        ns_obj = (self.store.get("namespaces", "", name)
                  or self.store.get("namespaces", "default", name))
        if ns_obj is None or ns_obj.status.phase != "Terminating":
            return
        for kind in _SWEEP:
            for obj in self.store.list(kind, name):
                try:
                    self.store.delete(kind, name, obj.metadata.name)
                except KeyError:
                    pass
        remaining = sum(len(self.store.list(kind, name)) for kind in _SWEEP)
        if remaining:
            raise RuntimeError(f"{remaining} objects remained; requeue")
        # content gone: drop the finalizer and the namespace itself
        ns_obj.spec.finalizers = []
        try:
            self.store.update("namespaces", ns_obj)
            self.store.delete("namespaces", ns_obj.metadata.namespace, name)
        except (Conflict, KeyError):
            pass
