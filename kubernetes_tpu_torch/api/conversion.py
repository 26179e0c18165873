"""Multi-version serving: wire-level conversion between API versions.

A copy of kubernetes_tpu/api/conversion.py; its relative imports resolve in this
package.

Analog of the reference's conversion machinery
(staging/src/k8s.io/apimachinery/pkg/conversion/converter.go:40 Converter;
pkg/apis/apps/v1beta1/conversion.go, pkg/apis/autoscaling/v1/conversion.go):
each kind has ONE hub schema (the dataclass model in api/types.py, which
is also the storage schema, like the reference's internal version) and
any number of additional served versions. A served version is a pair of
wire-dict transforms:

    to_hub(data)   request body at that version -> hub wire form
    from_hub(data) hub wire form -> response body at that version

Conversions operate on the encoded (camelCase JSON) representation, not
on dataclasses — the hub dataclasses stay the single in-memory model, so
informers, controllers, and the scheduler never see versioned types
(exactly the reference's "everything internal speaks internal types"
rule, SURVEY.md L1).

Registered pairs mirror real reference conversions:

  * apps/v1beta1 Deployment (pkg/apis/apps/v1beta1/): a nil selector
    defaults from template labels on the way in; spec.rollbackTo is
    preserved through the hub as the deprecated rollback annotation.
  * autoscaling/v2beta1 HorizontalPodAutoscaler
    (pkg/apis/autoscaling/v1/conversion.go:62
    Convert_v1_HorizontalPodAutoscalerSpec_To_autoscaling_...): the v1
    targetCPUUtilizationPercentage field <-> a v2beta1 Resource metric
    on cpu with targetAverageUtilization.
  * batch/v2alpha1 CronJob: schema-identical, tag-only (the reference
    served both batch/v1beta1 and v2alpha1 in 1.11).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple

WireFn = Callable[[Dict[str, Any]], Dict[str, Any]]

# kind -> {version -> (to_hub, from_hub)}; None = identity (tag-only)
_VERSIONS: Dict[str, Dict[str, Tuple[Optional[WireFn], Optional[WireFn]]]] = {}


def register_version(kind: str, version: str,
                     to_hub: Optional[WireFn] = None,
                     from_hub: Optional[WireFn] = None):
    """Serve `kind` at an additional apiVersion. to_hub/from_hub are
    wire-dict transforms; None means the schemas are identical and only
    the apiVersion tag differs."""
    _VERSIONS.setdefault(kind, {})[version] = (to_hub, from_hub)


def unregister_kind(kind: str):
    _VERSIONS.pop(kind, None)


def extra_versions(kind: str):
    return list(_VERSIONS.get(kind, ()))


def serves(kind: str, version: str, hub_version: str) -> bool:
    return version == hub_version or version in _VERSIONS.get(kind, ())


def set_versions(kind: str,
                 versions: Dict[str, Tuple[Optional[WireFn],
                                           Optional[WireFn]]]):
    """Atomically replace kind's served extra versions (one dict
    assignment) — re-registering a CRD must not open a window where a
    concurrent list/watch at an extra version finds the kind unserved."""
    if versions:
        _VERSIONS[kind] = dict(versions)
    else:
        _VERSIONS.pop(kind, None)


def to_hub(kind: str, data: Dict[str, Any], version: str,
           hub_version: str) -> Dict[str, Any]:
    """Request body at `version` -> hub wire form (converter.go Convert:
    the hub is the pivot; there are no version-to-version edges)."""
    if version == hub_version:
        return data
    fns = _VERSIONS.get(kind, {}).get(version)
    if fns is None:
        raise KeyError(f"{kind} is not served at {version}")
    data = copy.deepcopy(data)
    data["apiVersion"] = hub_version
    return fns[0](data) if fns[0] else data


def from_hub(kind: str, data: Dict[str, Any], version: str,
             hub_version: str, owned: bool = False) -> Dict[str, Any]:
    """Hub wire form -> response body at `version`. owned=True promises
    the caller built `data` fresh (encode_object does) so the converter
    may mutate it in place — skipping a deepcopy per object on the
    list/watch hot path."""
    if version == hub_version:
        return data
    fns = _VERSIONS.get(kind, {}).get(version)
    if fns is None:
        raise KeyError(f"{kind} is not served at {version}")
    if not owned:
        data = copy.deepcopy(data)
    data["apiVersion"] = version
    return fns[1](data) if fns[1] else data


# -- apps/v1beta1 Deployment ---------------------------------------------------

ROLLBACK_ANNOTATION = "deprecated.deployment.rollback.to"


def _deployment_v1beta1_to_hub(data):
    # v1beta1 defaulting: nil selector defaults from template labels
    # (pkg/apis/apps/v1beta1/defaults.go SetDefaults_DeploymentSpec —
    # shared with the other legacy workload kinds)
    data = _selector_default_to_hub(data)
    spec = data.get("spec") or {}
    # spec.rollbackTo exists only in v1beta1; the hub schema has no
    # field for it, so it survives as the deprecated annotation
    rb = spec.pop("rollbackTo", None)
    if rb is not None:
        meta = data.setdefault("metadata", {})
        ann = meta.setdefault("annotations", {})
        ann[ROLLBACK_ANNOTATION] = str(rb.get("revision", 0))
    data["spec"] = spec
    return data


def _deployment_v1beta1_from_hub(data):
    ann = ((data.get("metadata") or {}).get("annotations") or {})
    # pop, not get: the annotation IS the v1beta1 field in hub form —
    # leaving it behind would resurrect a rollbackTo the client deleted
    # on the next round trip
    rev = ann.pop(ROLLBACK_ANNOTATION, None)
    if rev is not None:
        spec = data.setdefault("spec", {})
        try:
            spec["rollbackTo"] = {"revision": int(rev)}
        except ValueError:
            pass
    return data


# -- autoscaling/v2beta1 HorizontalPodAutoscaler -------------------------------


METRICS_ANNOTATION = "autoscaling.alpha.kubernetes.io/metrics"


def _is_cpu_util(m):
    res = m.get("resource") or {}
    return (m.get("type") == "Resource" and res.get("name") == "cpu"
            and res.get("targetAverageUtilization") is not None)


def _hpa_v2beta1_to_hub(data):
    import json as _json

    spec = data.get("spec") or {}
    metrics = spec.pop("metrics", None) or []
    rest = []
    for m in metrics:
        if _is_cpu_util(m) and "targetCpuUtilizationPercentage" not in spec:
            spec["targetCpuUtilizationPercentage"] = \
                m["resource"]["targetAverageUtilization"]
        else:
            rest.append(m)
    if rest:
        # metrics the v1 hub can't express survive as the reference's
        # alpha annotation (pkg/apis/autoscaling/v1/conversion.go:37)
        ann = data.setdefault("metadata", {}).setdefault("annotations", {})
        ann[METRICS_ANNOTATION] = _json.dumps(rest)
    data["spec"] = spec
    # v2beta1 status.currentMetrics cpu utilization -> v1 status field
    status = data.get("status")
    if status:
        for m in status.pop("currentMetrics", None) or []:
            res = m.get("resource") or {}
            if m.get("type") == "Resource" and res.get("name") == "cpu" \
                    and res.get("currentAverageUtilization") is not None:
                status["currentCpuUtilizationPercentage"] = \
                    res["currentAverageUtilization"]
    return data


def _hpa_v2beta1_from_hub(data):
    import json as _json

    spec = data.get("spec") or {}
    metrics = []
    cpu = spec.pop("targetCpuUtilizationPercentage", None)
    if cpu is not None:
        metrics.append({
            "type": "Resource",
            "resource": {"name": "cpu", "targetAverageUtilization": cpu}})
    ann = ((data.get("metadata") or {}).get("annotations") or {})
    preserved = ann.pop(METRICS_ANNOTATION, None)
    if preserved:
        try:
            metrics.extend(_json.loads(preserved))
        except ValueError:
            pass
    if metrics:
        spec["metrics"] = metrics
    data["spec"] = spec
    status = data.get("status")
    if status:
        ccpu = status.pop("currentCpuUtilizationPercentage", None)
        if ccpu is not None:
            status["currentMetrics"] = [{
                "type": "Resource",
                "resource": {"name": "cpu",
                             "currentAverageUtilization": ccpu}}]
    return data


def _selector_default_to_hub(data):
    """Shared legacy-workload defaulting: a nil selector defaults from
    the template labels (pkg/apis/extensions/v1beta1/defaults.go
    SetDefaults_ReplicaSet / SetDefaults_DaemonSet — removed in
    apps/v1beta2+, where selector is required and immutable)."""
    spec = data.get("spec") or {}
    # nil-only defaulting: an EXPLICIT empty selector ({}) is a valid
    # match-everything selector in the legacy versions and must survive
    # the round-trip (the reference defaults only `Selector == nil`)
    if spec.get("selector") is None:
        tlabels = (((spec.get("template") or {}).get("metadata") or {})
                   .get("labels") or {})
        if tlabels:
            spec["selector"] = {"matchLabels": dict(tlabels)}
            data["spec"] = spec
    return data


def install_defaults():
    """Register the built-in multi-version pairs. The 1.11 reference
    serves the workload kinds at apps/v1 (hub here), apps/v1beta1,
    apps/v1beta2, and extensions/v1beta1 simultaneously
    (pkg/master/master.go InstallAPIs; pkg/apis/extensions)."""
    register_version("Deployment", "apps/v1beta1",
                     _deployment_v1beta1_to_hub, _deployment_v1beta1_from_hub)
    # extensions/v1beta1 Deployment carries the same legacy fields as
    # apps/v1beta1 (nil-selector defaulting + spec.rollbackTo)
    register_version("Deployment", "extensions/v1beta1",
                     _deployment_v1beta1_to_hub, _deployment_v1beta1_from_hub)
    # apps/v1beta2 dropped the legacy defaulting — wire shape == hub
    register_version("Deployment", "apps/v1beta2")
    register_version("ReplicaSet", "extensions/v1beta1",
                     _selector_default_to_hub)
    register_version("ReplicaSet", "apps/v1beta2")
    register_version("DaemonSet", "extensions/v1beta1",
                     _selector_default_to_hub)
    register_version("DaemonSet", "apps/v1beta2")
    register_version("StatefulSet", "apps/v1beta1",
                     _selector_default_to_hub)
    register_version("StatefulSet", "apps/v1beta2")
    register_version("HorizontalPodAutoscaler", "autoscaling/v2beta1",
                     _hpa_v2beta1_to_hub, _hpa_v2beta1_from_hub)
    register_version("CronJob", "batch/v2alpha1")
