"""ResourceQuota accounting.

A copy of kubernetes_tpu/controllers/resourcequota.py; its relative imports
resolve in this package.

Reference: pkg/controller/resourcequota/resource_quota_controller.go
(syncResourceQuota:253 — recompute status.used via the evaluators in
pkg/quota/evaluator/core; admission enforces against status).
"""

from __future__ import annotations

from ..api import resources as res
from ..api import types as api
from ..runtime.store import Conflict
from .base import Controller, is_pod_active


class ResourceQuotaController(Controller):
    name = "resourcequota"

    def __init__(self, store):
        super().__init__(store)
        self.informer("resourcequotas")
        self.informer("pods", enqueue_fn=self._pod_event)

    def _pod_event(self, pod):
        for q in self.store.list("resourcequotas", pod.metadata.namespace):
            self.enqueue(q)

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        quota = self.store.get("resourcequotas", ns, name)
        if quota is None:
            return
        pods = [p for p in self.store.list("pods", ns) if is_pod_active(p)]
        used = {"pods": len(pods)}
        cpu = mem = 0
        for p in pods:
            req = api.get_resource_request(p)
            cpu += req.get(res.CPU, 0)
            mem += req.get(res.MEMORY, 0)
        used["requests.cpu"] = cpu
        used["requests.memory"] = mem
        used["services"] = len(self.store.list("services", ns))
        used["persistentvolumeclaims"] = len(
            self.store.list("persistentvolumeclaims", ns))
        # only track what hard constrains (quota core evaluator Matches)
        used = {k: v for k, v in used.items()
                if k in quota.spec.hard or
                (k == "requests.cpu" and "cpu" in quota.spec.hard) or
                (k == "requests.memory" and "memory" in quota.spec.hard)}
        if quota.status.used == used and quota.status.hard == quota.spec.hard:
            return
        quota.status.hard = dict(quota.spec.hard)
        quota.status.used = used
        try:
            self.store.update("resourcequotas", quota)
        except (Conflict, KeyError):
            pass
