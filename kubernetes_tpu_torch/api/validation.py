"""API object validation.

A copy of kubernetes_tpu/api/validation.py; its relative imports resolve in this
package.

Reference: pkg/apis/core/validation/validation.go (~6k LoC of per-kind
rules over apimachinery's field.Path / field.ErrorList). The same
shape is kept — path-addressed errors aggregated into a list so a bad
object reports every problem at once — over this model's flattened
types. The apiserver runs validation after admission mutators, exactly
where the reference's registry strategies call Validate
(registry/core/pod/strategy.go:79), and surfaces failures as 422.
"""

from __future__ import annotations

import functools
import re
from typing import List, Optional

from . import types as api

# apimachinery/pkg/util/validation/validation.go:32 IsDNS1123Subdomain
_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?"
                      r"(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*$")
_LABEL_VALUE = re.compile(r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$")
_QUALIFIED_NAME = re.compile(
    r"^([a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*/)?"
    r"[A-Za-z0-9]([-A-Za-z0-9_.]{0,61}[A-Za-z0-9])?$")


class ValidationError:
    """One field.Error (apimachinery field/errors.go)."""

    def __init__(self, field: str, value, detail: str):
        self.field = field
        self.value = value
        self.detail = detail

    def __repr__(self):
        return f"{self.field}: {self.detail} (got {self.value!r})"


class ErrorList(list):
    def add(self, field: str, value, detail: str):
        self.append(ValidationError(field, value, detail))

    def message(self) -> str:
        return "; ".join(repr(e) for e in self)


def validate_object_meta(meta: api.ObjectMeta, path: str = "metadata",
                         errs: Optional[ErrorList] = None) -> ErrorList:
    errs = errs if errs is not None else ErrorList()
    if not meta.name:
        errs.add(f"{path}.name", meta.name, "name is required")
    elif len(meta.name) > 253 or not _DNS1123.match(meta.name):
        errs.add(f"{path}.name", meta.name,
                 "must be a DNS-1123 subdomain")
    if meta.namespace and not _DNS1123.match(meta.namespace):
        errs.add(f"{path}.namespace", meta.namespace,
                 "must be a DNS-1123 subdomain")
    for k, v in (meta.labels or {}).items():
        if not _QUALIFIED_NAME.match(k):
            errs.add(f"{path}.labels", k, "invalid label key")
        if not _LABEL_VALUE.match(v) or len(v) > 63:
            errs.add(f"{path}.labels[{k}]", v, "invalid label value")
    return errs


def validate_pod(pod: api.Pod) -> ErrorList:
    """validation.go:2990 ValidatePod (spec subset this model carries)."""
    errs = validate_object_meta(pod.metadata)
    spec, path = pod.spec, "spec"
    if not spec.containers:
        errs.add(f"{path}.containers", [], "at least one container required")
    seen = set()
    for i, c in enumerate(spec.containers):
        cpath = f"{path}.containers[{i}]"
        if not c.name:
            errs.add(f"{cpath}.name", c.name, "name is required")
        elif c.name in seen:
            errs.add(f"{cpath}.name", c.name, "duplicate container name")
        seen.add(c.name)
        if c.image_pull_policy not in ("", "Always", "IfNotPresent", "Never"):
            errs.add(f"{cpath}.imagePullPolicy", c.image_pull_policy,
                     "must be Always, IfNotPresent or Never")
        req, lim = c.resources.requests, c.resources.limits
        for res, rv in (req or {}).items():
            if rv < 0:
                errs.add(f"{cpath}.resources.requests[{res}]", rv,
                         "must be non-negative")
            if lim and res in lim and rv > lim[res]:
                errs.add(f"{cpath}.resources.requests[{res}]", rv,
                         "must be <= limit")
        for res, rv in (lim or {}).items():
            if rv < 0:
                errs.add(f"{cpath}.resources.limits[{res}]", rv,
                         "must be non-negative")
    if spec.restart_policy not in ("Always", "OnFailure", "Never"):
        errs.add(f"{path}.restartPolicy", spec.restart_policy,
                 "must be Always, OnFailure or Never")
    vseen = set()
    for i, v in enumerate(spec.volumes):
        vpath = f"{path}.volumes[{i}]"
        if not v.name:
            errs.add(f"{vpath}.name", v.name, "name is required")
        elif v.name in vseen:
            errs.add(f"{vpath}.name", v.name, "duplicate volume name")
        vseen.add(v.name)
        sources = sum(bool(x) for x in (
            v.empty_dir, v.host_path, v.config_map, v.secret,
            v.downward_api, v.nfs_server, v.pvc_name, v.source_kind,
            v.projected))
        if sources > 1:
            errs.add(vpath, v.name, "may not specify more than one source")
    for i, t in enumerate(spec.tolerations):
        if t.operator not in (api.TOLERATION_OP_EQUAL,
                              api.TOLERATION_OP_EXISTS):
            errs.add(f"{path}.tolerations[{i}].operator", t.operator,
                     "must be Equal or Exists")
        if t.operator == api.TOLERATION_OP_EXISTS and t.value:
            errs.add(f"{path}.tolerations[{i}].value", t.value,
                     "must be empty with operator Exists")
    if spec.priority is not None and spec.priority > 2_000_000_000 \
            and not spec.priority_class_name.startswith("system-"):
        errs.add(f"{path}.priority", spec.priority,
                 "only system priority classes may exceed 2000000000")
    return errs


def validate_pod_update(new: api.Pod, old: api.Pod) -> ErrorList:
    """validation.go:3305 ValidatePodUpdate: spec is immutable except
    image, activeDeadline, tolerations additions; nodeName only via
    binding (transition from empty)."""
    errs = ErrorList()
    if old.spec.node_name and new.spec.node_name != old.spec.node_name:
        errs.add("spec.nodeName", new.spec.node_name,
                 "may not be changed once set")
    if len(new.spec.containers) != len(old.spec.containers):
        errs.add("spec.containers", len(new.spec.containers),
                 "may not add or remove containers")
    return errs


def validate_node(node: api.Node) -> ErrorList:
    errs = validate_object_meta(node.metadata)
    for res, v in (node.status.allocatable or {}).items():
        if v < 0:
            errs.add(f"status.allocatable[{res}]", v, "must be non-negative")
    for i, t in enumerate(node.spec.taints):
        if t.effect not in (api.NO_SCHEDULE, api.PREFER_NO_SCHEDULE,
                            api.NO_EXECUTE):
            errs.add(f"spec.taints[{i}].effect", t.effect,
                     "invalid taint effect")
        if not t.key:
            errs.add(f"spec.taints[{i}].key", t.key, "key is required")
    return errs


def validate_service(svc: api.Service) -> ErrorList:
    errs = validate_object_meta(svc.metadata)
    spec = svc.spec
    if spec.type not in ("ClusterIP", "NodePort", "LoadBalancer",
                         "ExternalName"):
        errs.add("spec.type", spec.type, "invalid service type")
    if spec.session_affinity not in ("None", "ClientIP"):
        errs.add("spec.sessionAffinity", spec.session_affinity,
                 "must be None or ClientIP")
    names = set()
    for i, p in enumerate(spec.ports):
        ppath = f"spec.ports[{i}]"
        if not (0 < p.port <= 65535):
            errs.add(f"{ppath}.port", p.port, "must be 1-65535")
        if p.node_port and not (0 < p.node_port <= 65535):
            errs.add(f"{ppath}.nodePort", p.node_port, "must be 1-65535")
        if p.protocol not in ("TCP", "UDP", "SCTP"):
            errs.add(f"{ppath}.protocol", p.protocol, "invalid protocol")
        if len(spec.ports) > 1 and not p.name:
            errs.add(f"{ppath}.name", p.name,
                     "required when multiple ports are present")
        if p.name and p.name in names:
            errs.add(f"{ppath}.name", p.name, "duplicate port name")
        names.add(p.name)
    if spec.type == "ExternalName" and not spec.external_name:
        errs.add("spec.externalName", spec.external_name,
                 "required for ExternalName services")
    return errs


def validate_pvc(pvc) -> ErrorList:
    errs = validate_object_meta(pvc.metadata)
    for res, v in (pvc.spec.requests or {}).items():
        if v < 0:
            errs.add(f"spec.resources.requests[{res}]", v,
                     "must be non-negative")
    return errs


def _validate_workload(obj, selector_required: bool = True) -> ErrorList:
    """Shared apps-workload shape: replicas >= 0; apps/v1 selector
    required and matching the template labels
    (pkg/apis/apps/validation ValidateDeployment/ReplicaSet...)."""
    errs = validate_object_meta(obj.metadata)
    replicas = getattr(obj.spec, "replicas", None)
    if replicas is not None and replicas < 0:
        errs.add("spec.replicas", replicas, "must be non-negative")
    sel = getattr(obj, "selector", None) or getattr(obj.spec, "selector",
                                                    None)
    template = getattr(obj.spec, "template", None) or \
        getattr(obj, "template", None)
    if selector_required and sel is None:
        errs.add("spec.selector", None, "selector is required")
    if sel is not None and template is not None:
        tlabels = getattr(getattr(template, "metadata", None), "labels",
                          None) or {}
        s = sel.to_selector() if hasattr(sel, "to_selector") else None
        if s is not None and s.requirements and not s.matches(tlabels):
            errs.add("spec.template.metadata.labels", tlabels,
                     "must match spec.selector")
    strategy = getattr(obj.spec, "update_strategy", None)
    if strategy is not None:
        # apps/validation ValidateDaemonSetUpdateStrategy: the type is
        # an enum and a RollingUpdate budget of 0 could never progress
        if strategy.type not in ("RollingUpdate", "OnDelete"):
            errs.add("spec.updateStrategy.type", strategy.type,
                     'must be "RollingUpdate" or "OnDelete"')
        elif strategy.type == "RollingUpdate" \
                and getattr(strategy, "max_unavailable", 1) < 1:
            errs.add("spec.updateStrategy.rollingUpdate.maxUnavailable",
                     strategy.max_unavailable, "must be at least 1")
        # StatefulSet strategies carry a partition instead of a budget
        # (apps/validation ValidateStatefulSetUpdateStrategy)
        if getattr(strategy, "partition", 0) < 0:
            errs.add("spec.updateStrategy.rollingUpdate.partition",
                     strategy.partition, "must be non-negative")
    return errs


def validate_namespace(ns) -> ErrorList:
    errs = ErrorList()
    # namespace names are DNS-1123 LABELS (no dots)
    if not ns.metadata.name or "." in ns.metadata.name \
            or not _DNS1123.match(ns.metadata.name):
        errs.add("metadata.name", ns.metadata.name,
                 "must be a DNS-1123 label")
    return errs


def validate_pv(pv) -> ErrorList:
    errs = validate_object_meta(pv.metadata)
    for res_, v in (pv.spec.capacity or {}).items():
        if v < 0:
            errs.add(f"spec.capacity[{res_}]", v, "must be non-negative")
    if pv.spec.source_kind == "CSI" and not pv.spec.csi_driver:
        errs.add("spec.csi.driver", "", "driver name is required")
    return errs


def validate_pv_update(new, old) -> ErrorList:
    """PV source is immutable (validation.go ValidatePersistentVolumeUpdate)."""
    errs = ErrorList()
    if (new.spec.source_kind, new.spec.source_id) != \
            (old.spec.source_kind, old.spec.source_id):
        errs.add("spec.source", new.spec.source_kind,
                 "volume source is immutable")
    return errs


def validate_pvc_update(new, old) -> ErrorList:
    """Claim spec immutable after bind except the binder's own
    volumeName transition (ValidatePersistentVolumeClaimUpdate)."""
    errs = ErrorList()
    if old.spec.volume_name and \
            new.spec.volume_name != old.spec.volume_name:
        errs.add("spec.volumeName", new.spec.volume_name,
                 "is immutable after binding")
    if old.spec.volume_name and \
            new.spec.storage_class_name != old.spec.storage_class_name:
        errs.add("spec.storageClassName", new.spec.storage_class_name,
                 "is immutable after binding")
    return errs


def validate_service_update(new, old) -> ErrorList:
    """clusterIP immutable once allocated (ValidateServiceUpdate)."""
    errs = ErrorList()
    if old.spec.cluster_ip and new.spec.cluster_ip != old.spec.cluster_ip:
        errs.add("spec.clusterIP", new.spec.cluster_ip,
                 "may not change once set")
    return errs


def validate_rbac_role(role) -> ErrorList:
    """ValidatePolicyRule (rbac/validation): every rule names verbs and
    either resources WITH apiGroups, or nonResourceURLs. Requiring
    apiGroups here is what makes the authorizer's strict
    empty-matches-nothing semantics (server/auth.py) unsurprising."""
    errs = validate_object_meta(role.metadata)
    for i, r in enumerate(role.rules or []):
        rp = f"rules[{i}]"
        if not r.verbs:
            errs.add(f"{rp}.verbs", [], "at least one verb is required")
        has_res = bool(r.resources)
        has_nonres = bool(r.non_resource_urls)
        if not has_res and not has_nonres:
            errs.add(f"{rp}.resources", [],
                     "resources or nonResourceURLs is required")
        if has_res and not r.api_groups:
            errs.add(f"{rp}.apiGroups", [],
                     "apiGroups is required for resource rules "
                     '([""] selects the core group)')
    return errs


def validate_rbac_binding(b) -> ErrorList:
    errs = validate_object_meta(b.metadata)
    if not getattr(b.role_ref, "name", ""):
        errs.add("roleRef.name", "", "roleRef is required")
    for i, s in enumerate(b.subjects or []):
        if s.kind not in ("User", "Group", "ServiceAccount"):
            errs.add(f"subjects[{i}].kind", s.kind, "invalid subject kind")
        if not s.name:
            errs.add(f"subjects[{i}].name", s.name, "name is required")
    return errs


def validate_rbac_binding_update(new, old) -> ErrorList:
    """roleRef is immutable (rbac/validation ValidateRoleBindingUpdate)."""
    errs = ErrorList()
    if (new.role_ref.kind, new.role_ref.name) != \
            (old.role_ref.kind, old.role_ref.name):
        errs.add("roleRef", new.role_ref.name, "roleRef is immutable")
    return errs


def validate_hpa(hpa) -> ErrorList:
    errs = validate_object_meta(hpa.metadata)
    if hpa.spec.max_replicas <= 0:
        errs.add("spec.maxReplicas", hpa.spec.max_replicas,
                 "must be greater than 0")
    if hpa.spec.min_replicas is not None and \
            hpa.spec.min_replicas > hpa.spec.max_replicas:
        errs.add("spec.minReplicas", hpa.spec.min_replicas,
                 "must not exceed maxReplicas")
    return errs


def validate_pdb(pdb) -> ErrorList:
    errs = validate_object_meta(pdb.metadata)
    if pdb.spec.min_available is not None and \
            getattr(pdb.spec, "max_unavailable", None) is not None:
        errs.add("spec", None,
                 "minAvailable and maxUnavailable are mutually exclusive")
    return errs


QUOTA_SCOPES = ("BestEffort", "NotBestEffort", "Terminating",
                "NotTerminating")


def validate_resource_quota(q) -> ErrorList:
    errs = validate_object_meta(q.metadata)
    for k, v in (q.spec.hard or {}).items():
        if v < 0:
            errs.add(f"spec.hard[{k}]", v, "must be non-negative")
    for s in getattr(q.spec, "scopes", None) or []:
        # unknown scopes must be 422s (ValidateResourceQuotaSpec): a
        # typo'd scope silently matching everything would turn a scoped
        # quota into an unscoped one
        if s not in QUOTA_SCOPES:
            errs.add("spec.scopes", s,
                     f"must be one of {', '.join(QUOTA_SCOPES)}")
    return errs


def validate_configmap(cm) -> ErrorList:
    errs = validate_object_meta(cm.metadata)
    for k in (cm.data or {}):
        if not re.match(r"^[-._a-zA-Z0-9]+$", k):
            errs.add(f"data[{k}]", k, "invalid key name")
    return errs


def validate_cronjob(cj) -> ErrorList:
    errs = validate_object_meta(cj.metadata)
    schedule = getattr(cj.spec, "schedule", "")
    if not schedule or len(schedule.split()) != 5:
        errs.add("spec.schedule", schedule,
                 "must be a 5-field cron expression")
    return errs


def validate_priority_class(pc) -> ErrorList:
    errs = validate_object_meta(pc.metadata)
    if pc.value > 1_000_000_000 and not pc.metadata.name.startswith(
            "system-"):
        errs.add("value", pc.value,
                 "only system classes may exceed 1000000000")
    return errs


def validate_podgroup(pg) -> ErrorList:
    """Gang admission gates on minMember; a non-positive value would
    either release gangs instantly (0) or wedge them forever (<0)."""
    errs = validate_object_meta(pg.metadata)
    if pg.spec.min_member < 1:
        errs.add("spec.minMember", pg.spec.min_member, "must be at least 1")
    return errs


def validate_job(job) -> ErrorList:
    errs = validate_object_meta(job.metadata)
    for fname in ("completions", "parallelism", "backoff_limit"):
        v = getattr(job.spec, fname, None)
        if v is not None and v < 0:
            errs.add(f"spec.{fname}", v, "must be non-negative")
    return errs


# kind plural -> validator; update validators get (new, old).
# Kinds without a specific entry still get validate_object_meta via
# validate() — every served built-in kind reports field-addressed 422s.
VALIDATORS = {
    "pods": validate_pod,
    "nodes": validate_node,
    "services": validate_service,
    "persistentvolumeclaims": validate_pvc,
    "persistentvolumes": validate_pv,
    "namespaces": validate_namespace,
    "deployments": _validate_workload,
    "replicasets": _validate_workload,
    "statefulsets": _validate_workload,
    "daemonsets": _validate_workload,
    "replicationcontrollers": functools.partial(
        _validate_workload, selector_required=False),
    "jobs": validate_job,
    "cronjobs": validate_cronjob,
    "configmaps": validate_configmap,
    "secrets": validate_configmap,
    "roles": validate_rbac_role,
    "clusterroles": validate_rbac_role,
    "rolebindings": validate_rbac_binding,
    "clusterrolebindings": validate_rbac_binding,
    "horizontalpodautoscalers": validate_hpa,
    "poddisruptionbudgets": validate_pdb,
    "podgroups": validate_podgroup,
    "resourcequotas": validate_resource_quota,
    "priorityclasses": validate_priority_class,
}

UPDATE_VALIDATORS = {
    "pods": validate_pod_update,
    "services": validate_service_update,
    "persistentvolumes": validate_pv_update,
    "persistentvolumeclaims": validate_pvc_update,
    "rolebindings": validate_rbac_binding_update,
    "clusterrolebindings": validate_rbac_binding_update,
}


def validate(kind: str, obj, old=None) -> ErrorList:
    errs = ErrorList()
    v = VALIDATORS.get(kind)
    if v is not None:
        errs.extend(v(obj))
    elif hasattr(obj, "metadata"):
        # no kind-specific rules yet: metadata is still validated for
        # EVERY served kind (name/namespace/labels shape)
        errs.extend(validate_object_meta(obj.metadata))
    if old is not None:
        uv = UPDATE_VALIDATORS.get(kind)
        if uv is not None:
            errs.extend(uv(obj, old))
    return errs
