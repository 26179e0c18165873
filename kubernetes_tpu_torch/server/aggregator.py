"""APIService availability controller.

A copy of kubernetes_tpu/server/aggregator.py; its relative imports
resolve in this package.

Reference: kube-aggregator's available_controller
(pkg/controllers/status/available_controller.go:205 sync): an
APIService with a service backend is Available iff its service has
ready endpoints; local (service-less) APIServices are always Available.
Consumers (kubectl discovery, GC) read the condition instead of probing
the backend themselves.
"""

from __future__ import annotations

from ..api import types as api
from ..controllers.base import Controller


class APIServiceAvailabilityController(Controller):
    name = "apiservice-availability"

    def __init__(self, store):
        super().__init__(store)
        self.informer("apiservices")
        # endpoint changes flip availability: re-check every APIService
        self.informer("endpoints",
                      enqueue_fn=lambda *_: self.resync())

    def resync(self):
        for svc in self.store.list("apiservices"):
            self.enqueue(svc)

    def sync(self, key: str):
        _, name = key.split("/", 1)
        apisvc = (self.store.get("apiservices", "", name)
                  or self.store.get("apiservices", "default", name))
        if apisvc is None:
            return
        if not apisvc.spec.service_name:
            available, reason = True, "Local"
        else:
            ep = self.store.get("endpoints", apisvc.spec.service_namespace,
                                apisvc.spec.service_name)
            has_ready = any(s.addresses for s in (ep.subsets if ep else []))
            available = has_ready
            reason = "Passed" if has_ready else "MissingEndpoints"
        status = api.COND_TRUE if available else api.COND_FALSE
        for cond in apisvc.status.conditions:
            if cond.type == "Available":
                if cond.status == status:
                    return
                cond.status, cond.reason = status, reason
                break
        else:
            apisvc.status.conditions.append(
                api.APIServiceCondition("Available", status, reason))
        self.store.update("apiservices", apisvc)
