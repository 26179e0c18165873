"""The polymorphic scale mapping: one place that knows how a kind's
replica count is read and written.

A copy of kubernetes_tpu/api/scale.py; its relative imports resolve in this
package.

Shared by the apiserver's /scale subresource and the HPA controller —
the reference routes both through the scale client
(staging/src/k8s.io/client-go/scale/client.go; HPA usage in
pkg/controller/podautoscaler/horizontal.go scaleForResourceMappings).
Built-in workload kinds map to spec/status.replicas; custom kinds map
through the dotted paths their CRD declares in subresources.scale.
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import scheme
from . import types as api

# kinds with a native Scale mapping (the reference's registry wires
# autoscaling/v1 Scale REST for exactly these:
# registry/apps/*/storage/storage.go ScaleREST + core RC)
BUILTIN_SCALE_KINDS = {
    "Deployment": "deployments",
    "ReplicaSet": "replicasets",
    "ReplicationController": "replicationcontrollers",
    "StatefulSet": "statefulsets",
}
BUILTIN_SCALE_PLURALS = frozenset(BUILTIN_SCALE_KINDS.values())


def crd_for_kind(store, kind: str):
    for crd in store.list("customresourcedefinitions"):
        if crd.spec.names.kind == kind:
            return crd
    return None


def dotted_get(wire: dict, path: str, default=None):
    cur = wire
    for part in [p for p in path.split(".") if p]:
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def dotted_set(wire: dict, path: str, value):
    parts = [p for p in path.split(".") if p]
    cur = wire
    for part in parts[:-1]:
        cur = cur.setdefault(part, {})
    cur[parts[-1]] = value


def mapping_for(store, plural: str,
                obj) -> Optional[Tuple[str, str, str]]:
    """-> (spec_replicas_path, status_replicas_path, selector string) or
    None when the kind serves no scale."""
    if plural in BUILTIN_SCALE_PLURALS:
        sel = ""
        s = getattr(obj.spec, "selector", None)
        if s is not None and getattr(s, "match_labels", None):
            sel = ",".join(f"{k}={v}"
                           for k, v in sorted(s.match_labels.items()))
        elif isinstance(s, dict) and s:
            # ReplicationController carries a bare map selector
            sel = ",".join(f"{k}={v}" for k, v in sorted(s.items()))
        return ".spec.replicas", ".status.replicas", sel
    if isinstance(obj, api.CustomObject):
        crd = crd_for_kind(store, obj.kind)
        if crd is not None and crd.spec.subresources is not None and \
                crd.spec.subresources.scale is not None:
            sc = crd.spec.subresources.scale
            sel = ""
            if sc.label_selector_path:
                wire = scheme.encode_object(obj)
                got = dotted_get(wire, sc.label_selector_path, "")
                # the Scale selector is a STRING field; a map-shaped
                # value at the path degrades to no selector rather than
                # crashing every consumer (HPA retry-loops otherwise)
                sel = got if isinstance(got, str) else ""
            return sc.spec_replicas_path, sc.status_replicas_path, sel
    return None


def get_spec_replicas(obj, spec_path: str) -> int:
    if isinstance(obj, api.CustomObject):
        got = dotted_get({"spec": obj.spec, "status": obj.status},
                         spec_path, 0)
        return got if isinstance(got, int) else 0
    return obj.spec.replicas


def set_spec_replicas(obj, spec_path: str, value: int):
    if isinstance(obj, api.CustomObject):
        dotted_set({"spec": obj.spec, "status": obj.status},
                   spec_path, value)
    else:
        obj.spec.replicas = value
