"""Horizontal Pod Autoscaler controller.

A copy of kubernetes_tpu/controllers/podautoscaler.py; its relative imports
resolve in this package.

Reference: pkg/controller/podautoscaler/horizontal.go:80
(NewHorizontalController) + replica_calculator.go. The control law,
reproduced exactly:

  usageRatio     = currentUtilization / targetUtilization
  desiredReplicas = ceil(usageRatio * currentReadyReplicas)
  no-op when |usageRatio - 1| <= tolerance (0.1, horizontal.go:62)
  clamp to [minReplicas, maxReplicas]

where currentUtilization = sum(pod cpu usage) / sum(pod cpu requests),
request-based, over the target's selected pods (metrics/utilization.go).

Stabilization windows (horizontal.go:409-419 via upscale/downscale
forbidden windows): after a scale event, further scale-UPs are forbidden
for 3 minutes and scale-DOWNs for 5 minutes, measured against
status.lastScaleTime.

The metrics source is pluggable: by default it reads `podmetrics`
objects from the store (metadata.name == pod name, usage["cpu"] in
millicores — what metrics-server publishes); pass `metrics_fn(pod) ->
Optional[int]` to plug anything else in, the seam the reference gets
from its MetricsClient interface (podautoscaler/metrics/interfaces.go).
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional

from ..api import resources as res
from ..api import types as api
from .base import Controller

TOLERANCE = 0.1  # horizontal.go:62 defaultTolerance
UPSCALE_FORBIDDEN_WINDOW = 3 * 60.0  # horizontal.go upscaleForbiddenWindow
DOWNSCALE_FORBIDDEN_WINDOW = 5 * 60.0

# scalable target kinds -> store plural: THE scale mapping, shared with
# the apiserver's /scale subresource (api/scale.py)
from ..api import scale as scaleapi  # noqa: E402
from ..api.scale import BUILTIN_SCALE_KINDS as SCALE_KINDS  # noqa: E402


class HorizontalPodAutoscalerController(Controller):
    name = "horizontalpodautoscaler"

    def __init__(self, store, metrics_fn: Optional[Callable] = None,
                 clock: Callable[[], float] = time.time):
        super().__init__(store)
        self.clock = clock
        self.metrics_fn = metrics_fn or self._store_metrics
        self.informer("horizontalpodautoscalers")
        # a metrics publish re-evaluates only the HPAs whose target
        # selects that pod — enqueueing every HPA per metric would cost
        # O(pods x HPAs) syncs per publish cycle. The periodic resync
        # (base.run()'s ticker; the reference polls every 30s,
        # horizontal.go:144) covers deferred decisions like forbidden
        # windows and custom metrics_fn sources with no store events.
        self.informer("podmetrics", enqueue_fn=self._enqueue_for_metric)

    def resync(self):
        for hpa in self.store.list("horizontalpodautoscalers"):
            self.enqueue(hpa)

    def _enqueue_for_metric(self, m, new=None):
        # a pod can only be selected by a same-namespace target, and the
        # rate-limiting queue dedups keys, so namespace-scoped enqueue
        # coalesces a publish cycle to at most one sync per local HPA —
        # resolving the exact target per metric would cost more than the
        # syncs it saves
        m = new if new is not None else m
        for hpa in self.store.list("horizontalpodautoscalers",
                                   m.metadata.namespace):
            self.enqueue(hpa)

    # -- metrics source ---------------------------------------------------------

    def _store_metrics(self, pod: api.Pod) -> Optional[int]:
        m = self.store.get("podmetrics", pod.namespace, pod.metadata.name)
        if m is None:
            return None
        return m.usage.get(res.CPU)

    # -- target plumbing --------------------------------------------------------

    def _get_target(self, hpa: api.HorizontalPodAutoscaler):
        """Resolve scaleTargetRef through the shared scale mapping —
        built-in workloads AND custom kinds whose CRD declares
        subresources.scale (the reference HPA goes through the
        polymorphic scale client for exactly this reason,
        horizontal.go scaleForResourceMappings). Returns
        (plural, target, mapping)."""

        ref = hpa.spec.scale_target_ref
        plural = SCALE_KINDS.get(ref.kind)
        if plural is None:
            crd = scaleapi.crd_for_kind(self.store, ref.kind)
            if crd is None or crd.spec.subresources is None or \
                    crd.spec.subresources.scale is None:
                return None, None, None
            plural = crd.spec.names.plural
        target = self.store.get(plural, hpa.metadata.namespace, ref.name)
        if target is None:
            return plural, None, None
        return plural, target, scaleapi.mapping_for(self.store, plural,
                                                    target)

    def _selected_pods(self, target, mapping=None) -> List[api.Pod]:
        if isinstance(target, api.CustomObject):
            # custom targets select pods through the Scale selector
            # string (status.selector from labelSelectorPath)
            from ..api.labels import Selector

            sel_str = (mapping[2] if mapping else "") or ""
            if not sel_str:
                return []
            try:
                s = Selector.parse(sel_str)
            except ValueError:
                return []
            return [p for p in self.store.list("pods",
                                               target.metadata.namespace)
                    if api.is_pod_active(p)
                    and s.matches(p.metadata.labels or {})]
        sel = target.spec.selector
        if sel is None:
            match = target.spec.template.metadata.labels \
                if target.spec.template else {}
            fits = lambda p: all(  # noqa: E731
                (p.metadata.labels or {}).get(k) == v
                for k, v in match.items())
        elif isinstance(sel, dict):
            fits = lambda p: all(  # noqa: E731
                (p.metadata.labels or {}).get(k) == v for k, v in sel.items())
        else:
            s = sel.to_selector()
            fits = lambda p: s.matches(p.metadata.labels or {})  # noqa: E731
        return [p for p in self.store.list("pods", target.metadata.namespace)
                if api.is_pod_active(p) and fits(p)]

    # -- the control loop -------------------------------------------------------

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        hpa = self.store.get("horizontalpodautoscalers", ns, name)
        if hpa is None:
            return

        plural, target, mapping = self._get_target(hpa)
        if target is None or mapping is None:
            return
        pods = self._selected_pods(target, mapping)
        current = scaleapi.get_spec_replicas(target, mapping[0])
        desired, utilization = self._desired_replicas(hpa, pods, current)
        before = (hpa.status.current_replicas,
                  hpa.status.current_cpu_utilization_percentage,
                  hpa.status.desired_replicas)
        hpa.status.current_replicas = current
        hpa.status.current_cpu_utilization_percentage = utilization
        scaled = False
        if desired is not None and desired != current \
                and self._scale_allowed(hpa, desired > current):
            scaleapi.set_spec_replicas(target, mapping[0], desired)
            self.store.update(plural, target)
            hpa.status.desired_replicas = desired
            hpa.status.last_scale_time = self.clock()
            scaled = True
        else:
            hpa.status.desired_replicas = current
        after = (hpa.status.current_replicas,
                 hpa.status.current_cpu_utilization_percentage,
                 hpa.status.desired_replicas)
        # update only on a real change: an unconditional write would
        # self-enqueue via the HPA informer and spin the workqueue
        if scaled or after != before:
            self.store.update("horizontalpodautoscalers", hpa)

    def _desired_replicas(self, hpa, pods, current):
        """replica_calculator.go:59 GetResourceReplicas: request-weighted
        utilization over pods with metrics. Pods without a sample are
        rebalanced conservatively (replica_calculator.go:338): counted at
        0 usage when the measured ratio says scale UP, and at 100% of
        request when it says scale DOWN — if that flips the direction,
        no scale. The [min, max] clamp applies UNCONDITIONALLY
        (horizontal.go normalizeDesiredReplicas): even an on-target or
        metrics-less HPA enforces its bounds."""
        def clamp(n):
            return max(hpa.spec.min_replicas, min(hpa.spec.max_replicas, n))

        total_request = 0
        total_usage = 0
        missing_request = 0
        sampled = 0
        eligible = 0  # pods with a CPU request: the replica multiplier
        # counts only these — a request-less pod can't contribute to
        # utilization, so extrapolating the ratio over it over-scales
        for p in pods:
            request = sum(c.resources.requests.get(res.CPU, 0)
                          for c in p.spec.containers)
            if request <= 0:
                continue
            eligible += 1
            usage = self.metrics_fn(p)
            if usage is None:
                missing_request += request
                continue
            total_request += request
            total_usage += usage
            sampled += 1
        if sampled == 0 or total_request == 0:
            bounded = clamp(current)
            return (None, None) if bounded == current else (bounded, None)
        utilization = int(round(100.0 * total_usage / total_request))
        target = max(1, hpa.spec.target_cpu_utilization_percentage)
        ratio = utilization / target
        if abs(ratio - 1.0) <= TOLERANCE:
            desired = clamp(current)
            return ((None, utilization) if desired == current
                    else (desired, utilization))
        if missing_request > 0:
            if ratio > 1.0:
                usage2, request2 = total_usage, total_request + missing_request
            else:
                usage2 = total_usage + missing_request
                request2 = total_request + missing_request
            ratio2 = (100.0 * usage2 / request2) / target
            if (ratio2 > 1.0) != (ratio > 1.0) \
                    or abs(ratio2 - 1.0) <= TOLERANCE:
                desired = clamp(current)
                return ((None, utilization) if desired == current
                        else (desired, utilization))
            ratio = ratio2
        desired = clamp(math.ceil(ratio * max(eligible, 1)))
        return (None, utilization) if desired == current \
            else (desired, utilization)

    def _scale_allowed(self, hpa, up: bool) -> bool:
        last = hpa.status.last_scale_time
        if last is None:
            return True
        window = UPSCALE_FORBIDDEN_WINDOW if up else DOWNSCALE_FORBIDDEN_WINDOW
        return self.clock() - last >= window
