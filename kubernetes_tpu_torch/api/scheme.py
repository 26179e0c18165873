"""Scheme + codecs: the api-machinery serialization layer.

A copy of kubernetes_tpu/api/scheme.py; its relative imports resolve in this
package.

Analog of the reference's runtime.Scheme and serializer stack
(staging/src/k8s.io/apimachinery/pkg/runtime/scheme.go and
runtime/serializer/json/): a registry mapping kind names <-> Python
types <-> storage plurals, plus a generic JSON codec over the dataclass
object model in api/types.py. Wire format follows the reference's JSON
conventions — camelCase field names, top-level ``kind``/``apiVersion``
tags — so objects round-trip through the HTTP apiserver, kubectl, and
YAML manifests.

The dataclasses are the HUB schema — simultaneously the internal types
and the storage wire schema (resource quantities stay canonical int64s —
milli-CPU, bytes — as in schedulercache's Resource, node_info.go:131).
Additional served versions convert to/from the hub at the wire level
(api/conversion.py, the converter.go:40 analog): encode_object(obj,
version=...) emits any served version, decode_request() accepts any.
"""

from __future__ import annotations

import dataclasses
import json
from typing import (Any, Dict, List, Mapping, Optional, Tuple, Union,
                    get_args, get_origin, get_type_hints)

from . import conversion
from . import labels as lbl
from . import types as api

# -- kind registry (runtime.Scheme analog) ------------------------------------

# kind -> (plural, type, apiVersion, namespaced)
_REGISTRY: Dict[str, Tuple[str, type, str, bool]] = {}
_BY_PLURAL: Dict[str, str] = {}
_BY_TYPE: Dict[type, str] = {}


def register(kind: str, plural: str, typ: type, api_version: str = "v1",
             namespaced: bool = True):
    old = _REGISTRY.get(kind)
    if old is not None and old[0] != plural:
        # re-registration under a new plural (CRD rename): the retired
        # plural must stop resolving or it would route to a registry
        # entry that may later disappear (KeyError -> 500)
        _BY_PLURAL.pop(old[0], None)
    _REGISTRY[kind] = (plural, typ, api_version, namespaced)
    _BY_PLURAL[plural] = kind
    # every CRD-defined kind shares api.CustomObject, which tags itself:
    # the type->kind map keeps only the first (static) binding
    if typ not in _BY_TYPE:
        _BY_TYPE[typ] = kind


def crd_conflict(crd: "api.CustomResourceDefinition",
                 replacing: Optional[str] = None) -> Optional[str]:
    """Why this CRD may NOT be registered: its names must not collide
    with a built-in kind or another CRD — a CRD named 'Pod' would
    otherwise hijack (and, on deletion, unregister) the built-in
    server-wide. `replacing` names the kind an update supersedes, so a
    CRD renaming its own plural doesn't conflict with itself."""
    names = crd.spec.names
    existing = _REGISTRY.get(names.kind)
    if existing is not None:
        if existing[1] is not api.CustomObject:
            return f"kind {names.kind!r} is a built-in type"
        if names.kind != replacing and existing[0] != names.plural:
            return f"kind {names.kind!r} already defined by another CRD"
    served_by = _BY_PLURAL.get(names.plural)
    if served_by is not None and served_by not in (names.kind, replacing):
        return f"plural {names.plural!r} already served by {served_by!r}"
    return None


def register_dynamic(crd: "api.CustomResourceDefinition",
                     replacing: Optional[str] = None):
    """Serve a CRD's kind (apiextensions customresource_handler.go:
    instances decode to api.CustomObject). Raises ValueError on a name
    collision (see crd_conflict)."""
    msg = crd_conflict(crd, replacing)
    if msg is not None:
        raise ValueError(msg)
    names = crd.spec.names
    register(names.kind, names.plural, api.CustomObject,
             f"{crd.spec.group}/{crd.spec.version}",
             namespaced=crd.spec.scope == "Namespaced")
    # multi-version serving (apiextensions 1.11 spec.versions): every
    # listed version is served; non-storage versions convert by tag
    # rewrite only (CRDs have no conversion webhooks in 1.11 — all
    # versions share the schema, customresource_handler.go). Replaced
    # as one atomic swap so a concurrent list/watch at an extra version
    # never observes the kind momentarily unserved.
    conversion.set_versions(names.kind, {
        f"{crd.spec.group}/{v}": (None, None)
        for v in (crd.spec.versions or ()) if v != crd.spec.version})


def unregister(kind: str):
    """Remove a dynamically-registered kind (CRD deletion). Built-in
    kinds are never unregistered."""
    entry = _REGISTRY.get(kind)
    if entry is None or entry[1] is not api.CustomObject:
        return
    del _REGISTRY[kind]
    _BY_PLURAL.pop(entry[0], None)
    conversion.unregister_kind(kind)
    if _BY_TYPE.get(entry[1]) == kind:
        _BY_TYPE.pop(entry[1], None)


register("Pod", "pods", api.Pod)
register("CSIDriver", "csidrivers", api.CSIDriver,
         "storage.k8s.io/v1beta1", namespaced=False)
register("PodPreset", "podpresets", api.PodPreset,
         "settings.k8s.io/v1alpha1")
register("StorageClass", "storageclasses", api.StorageClass,
         "storage.k8s.io/v1", namespaced=False)
register("Node", "nodes", api.Node, namespaced=False)
register("Service", "services", api.Service)
register("ReplicationController", "replicationcontrollers", api.ReplicationController)
register("ReplicaSet", "replicasets", api.ReplicaSet, "apps/v1")
register("StatefulSet", "statefulsets", api.StatefulSet, "apps/v1")
register("Deployment", "deployments", api.Deployment, "apps/v1")
register("DaemonSet", "daemonsets", api.DaemonSet, "apps/v1")
register("ControllerRevision", "controllerrevisions", api.ControllerRevision,
         "apps/v1")
register("Job", "jobs", api.Job, "batch/v1")
register("CronJob", "cronjobs", api.CronJob, "batch/v1beta1")
register("PodDisruptionBudget", "poddisruptionbudgets", api.PodDisruptionBudget,
         "policy/v1beta1")
register("PodGroup", "podgroups", api.PodGroup,
         "scheduling.sigs.k8s.io/v1alpha1")
# scheduler weight profiles (shadow-scoring observatory, sched/weights.py)
register("WeightProfile", "weightprofiles", api.WeightProfile,
         "scheduling.sigs.k8s.io/v1alpha1")
register("PersistentVolume", "persistentvolumes", api.PersistentVolume,
         namespaced=False)
register("PersistentVolumeClaim", "persistentvolumeclaims", api.PersistentVolumeClaim)
register("Namespace", "namespaces", api.Namespace, namespaced=False)
register("Endpoints", "endpoints", api.Endpoints)
register("Event", "events", api.EventObject)
register("ResourceQuota", "resourcequotas", api.ResourceQuota)
register("ServiceAccount", "serviceaccounts", api.ServiceAccount)
register("Secret", "secrets", api.Secret)
register("ConfigMap", "configmaps", api.ConfigMap)
register("PriorityClass", "priorityclasses", api.PriorityClass,
         "scheduling.k8s.io/v1beta1", namespaced=False)
register("Lease", "leases", api.LeaseRecord, "coordination.k8s.io/v1",
         namespaced=False)
register("HorizontalPodAutoscaler", "horizontalpodautoscalers",
         api.HorizontalPodAutoscaler, "autoscaling/v1")
register("PodMetrics", "podmetrics", api.PodMetrics, "metrics.k8s.io/v1beta1")
register("APIService", "apiservices", api.APIService,
         "apiregistration.k8s.io/v1", namespaced=False)
register("PodSecurityPolicy", "podsecuritypolicies", api.PodSecurityPolicy,
         "policy/v1beta1", namespaced=False)
register("MutatingWebhookConfiguration", "mutatingwebhookconfigurations",
         api.MutatingWebhookConfiguration,
         "admissionregistration.k8s.io/v1beta1", namespaced=False)
register("ValidatingWebhookConfiguration", "validatingwebhookconfigurations",
         api.ValidatingWebhookConfiguration,
         "admissionregistration.k8s.io/v1beta1", namespaced=False)
register("LimitRange", "limitranges", api.LimitRange)
register("CertificateSigningRequest", "certificatesigningrequests",
         api.CertificateSigningRequest, "certificates.k8s.io/v1beta1",
         namespaced=False)
register("SelfSubjectAccessReview", "selfsubjectaccessreviews",
         api.SelfSubjectAccessReview, "authorization.k8s.io/v1",
         namespaced=False)
register("Role", "roles", api.Role, "rbac.authorization.k8s.io/v1")
register("ClusterRole", "clusterroles", api.ClusterRole,
         "rbac.authorization.k8s.io/v1", namespaced=False)
register("RoleBinding", "rolebindings", api.RoleBinding,
         "rbac.authorization.k8s.io/v1")
register("ClusterRoleBinding", "clusterrolebindings", api.ClusterRoleBinding,
         "rbac.authorization.k8s.io/v1", namespaced=False)
register("CustomResourceDefinition", "customresourcedefinitions",
         api.CustomResourceDefinition, "apiextensions.k8s.io/v1beta1",
         namespaced=False)
conversion.install_defaults()


def kind_for_plural(plural: str) -> Optional[str]:
    return _BY_PLURAL.get(plural)


def is_registered(kind: str) -> bool:
    return kind in _REGISTRY


def plural_for_kind(kind: str) -> str:
    return _REGISTRY[kind][0]


def type_for_kind(kind: str) -> type:
    return _REGISTRY[kind][1]


def kind_of(obj) -> Optional[str]:
    return _BY_TYPE.get(type(obj))


def api_version_for(kind: str) -> str:
    return _REGISTRY[kind][2]


def is_namespaced(kind: str) -> bool:
    return _REGISTRY[kind][3]


def all_kinds() -> List[str]:
    return list(_REGISTRY)


# -- multi-version serving -----------------------------------------------------


def served_versions(kind: str) -> List[str]:
    """Every apiVersion this kind is served at, hub (storage) first."""
    return [api_version_for(kind)] + conversion.extra_versions(kind)


def serves(kind: str, gv: str) -> bool:
    return conversion.serves(kind, gv, api_version_for(kind))


def convert_wire(kind: str, data: Dict[str, Any], to_version: str
                 ) -> Dict[str, Any]:
    """Hub wire dict -> `to_version` wire dict."""
    return conversion.from_hub(kind, data, to_version, api_version_for(kind))


def decode_request(kind: str, data: Mapping):
    """Wire dict at ANY served version -> hub object. The body's
    apiVersion tag picks the conversion; absent or hub-tagged bodies
    decode directly."""
    ver = data.get("apiVersion")
    hub = api_version_for(kind)
    if ver and ver != hub:
        data = conversion.to_hub(kind, dict(data), ver, hub)
    return decode(kind, data)


# -- field-name conversion -----------------------------------------------------


# wire names that break the mechanical snake->camel rule (initialisms
# the reference capitalizes wholesale)
_CAMEL_OVERRIDES = {
    "open_api_v3_schema": "openAPIV3Schema",
    "pod_ip": "podIP",
    "host_ip": "hostIP",
    "cluster_ip": "clusterIP",
    "pod_cidr": "podCIDR",
}


def _camel(name: str) -> str:
    special = _CAMEL_OVERRIDES.get(name)
    if special is not None:
        return special
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


# Element types for fields whose annotation is a bare ``tuple`` (frozen
# selector dataclasses in api/labels.py).
_TUPLE_ELEM: Dict[Tuple[str, str], Any] = {
    ("Requirement", "values"): str,
    ("Selector", "requirements"): lbl.Requirement,
    ("LabelSelector", "match_expressions"): lbl.Requirement,
}

_HINT_CACHE: Dict[type, Dict[str, Any]] = {}


def _hints(cls: type) -> Dict[str, Any]:
    h = _HINT_CACHE.get(cls)
    if h is None:
        h = get_type_hints(cls)
        _HINT_CACHE[cls] = h
    return h


# -- encode --------------------------------------------------------------------


def encode(value) -> Any:
    """Object -> plain JSON-able structure (camelCase keys)."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        out = {}
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            # drop empty/default-ish values for compact wire objects
            if v is None or v == {} or v == [] or v == ():
                continue
            out[_camel(f.name)] = encode(v)
        return out
    if isinstance(value, Mapping):
        return {k: encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [encode(v) for v in value]
    return value


def stable_hash(value, length: int = 40) -> str:
    """sha1 of the canonical sorted-JSON wire form (util/hash
    ComputeHash analog) — THE one content-hash idiom; template hashing,
    ControllerRevision identity, and generation fingerprints all go
    through here so canonicalization fixes land everywhere at once."""
    import hashlib
    enc = value if isinstance(value, (dict, list)) else encode(value)
    return hashlib.sha1(
        json.dumps(enc, sort_keys=True, default=str).encode()
    ).hexdigest()[:length]


def encode_object(obj, version: Optional[str] = None) -> Dict[str, Any]:
    """Top-level object -> dict with kind/apiVersion tags. Custom
    objects carry their own tags (all CRD kinds share one Python type).
    version requests a specific served version; the hub wire form is
    converted through api/conversion.py."""
    kind = getattr(obj, "kind", None) or kind_of(obj)
    if kind and kind in _REGISTRY:
        hub = api_version_for(kind)
    else:
        hub = getattr(obj, "api_version", None) or "v1"
    out = {"kind": kind, "apiVersion": hub}
    out.update(encode(obj))
    if version is not None and version != hub and kind:
        # owned=True: `out` was built fresh above, the converter may
        # mutate it instead of deep-copying every list/watch item
        out = conversion.from_hub(kind, out, version, hub, owned=True)
    return out


def to_json(obj) -> str:
    return json.dumps(encode_object(obj))


# -- decode --------------------------------------------------------------------


def _decode(value, hint, owner: str = "", fname: str = ""):
    if value is None:
        return None
    origin = get_origin(hint)
    if origin is Union:  # Optional[T]
        args = [a for a in get_args(hint) if a is not type(None)]
        return _decode(value, args[0], owner, fname)
    if dataclasses.is_dataclass(hint):
        return _decode_dataclass(value, hint)
    if origin in (dict, Mapping) or hint in (dict, Mapping):
        args = get_args(hint)
        vt = args[1] if len(args) == 2 else None
        return {k: (_decode(v, vt) if vt else v) for k, v in value.items()}
    if origin is list:
        (et,) = get_args(hint) or (None,)
        return [_decode(v, et) if et else v for v in value]
    if origin is tuple:
        args = get_args(hint)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_decode(v, args[0]) for v in value)
        return tuple(_decode(v, t) for v, t in zip(value, args))
    if hint is tuple:
        et = _TUPLE_ELEM.get((owner, fname))
        return tuple(_decode(v, et) if et and et is not str else v for v in value)
    return value


# resource-map fields whose values may arrive as quantity strings from
# YAML/JSON manifests ("100m", "1Gi") and must canonicalize to the int64
# convention (cpu -> milli, everything else -> base units) — the
# reference parses resource.Quantity at decode time
_RESOURCE_MAP_FIELDS = frozenset({
    "requests", "limits", "capacity", "allocatable", "hard", "used",
    "usage", "max", "min", "default", "default_request",
})


def _canon_resources(d: Dict[str, Any]) -> Dict[str, Any]:
    from . import resources as res

    out = {}
    for k, v in d.items():
        if isinstance(v, str):
            # quota keys spell cpu as "requests.cpu"/"limits.cpu" — all
            # CPU accounting is in milli-units
            is_cpu = k == res.CPU or k.endswith("." + res.CPU)
            out[k] = res.milli(v) if is_cpu else res.value(v)
        else:
            out[k] = v
    return out


def _decode_dataclass(data: Mapping, cls: type):
    hints = _hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        wire = _camel(f.name)
        if wire not in data:
            continue
        v = _decode(data[wire], hints[f.name], cls.__name__, f.name)
        if f.name in _RESOURCE_MAP_FIELDS and isinstance(v, dict):
            v = _canon_resources(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def decode(kind_or_type, data: Mapping):
    """kind name (or type) + wire dict -> object."""
    cls = kind_or_type if isinstance(kind_or_type, type) else type_for_kind(kind_or_type)
    return _decode_dataclass(data, cls)


def decode_object(data: Mapping):
    """Wire dict with a ``kind`` tag -> object."""
    kind = data.get("kind")
    if not kind or kind not in _REGISTRY:
        raise ValueError(f"unknown kind {kind!r}")
    return decode(kind, data)


def from_json(text: str):
    return decode_object(json.loads(text))
