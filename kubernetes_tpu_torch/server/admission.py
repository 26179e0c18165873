"""Admission control chain.

A copy of kubernetes_tpu/server/admission.py; its relative imports resolve in this
package.

Analog of the reference's admission framework (apiserver/pkg/admission/
chain.go) with a representative subset of the 23 in-tree plugins
(plugin/pkg/admission/): NamespaceLifecycle, Priority,
DefaultTolerationSeconds, ResourceQuota, NodeRestriction. Plugins
mutate and/or validate the object before it reaches storage
(endpoints/handlers/create.go admission step).
"""

from __future__ import annotations

from typing import List, Optional

from ..api import types as api
from ..runtime.store import ObjectStore
from .auth import UserInfo


class AdmissionError(Exception):
    """Admission denial -> HTTP 403 (reference: admission errors are
    apierrors.NewForbidden). Plugins may set a different status code —
    rate limiters reject with 429 (errors.NewTooManyRequests) so clients
    retry instead of treating the throttle as a permanent denial."""

    def __init__(self, message: str, code: int = 403):
        super().__init__(message)
        self.code = code


class AdmissionPlugin:
    name = "plugin"

    def admit(self, op: str, kind: str, obj, old, user: Optional[UserInfo],
              store: ObjectStore):
        """op in {create, update, delete}. kind is the storage plural.
        Mutate obj in place or raise AdmissionError."""


class NamespaceLifecycle(AdmissionPlugin):
    """Reject creates in missing or terminating namespaces
    (plugin/pkg/admission/namespace/lifecycle/admission.go)."""

    name = "NamespaceLifecycle"
    immortal = ("default", "kube-system", "kube-public")

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind == "namespaces":
            return
        ns = getattr(obj.metadata, "namespace", "")
        if not ns:
            return
        nsobj = store.get("namespaces", "", ns) or store.get(
            "namespaces", "default", ns)
        if nsobj is None:
            if ns in self.immortal:
                return  # auto-created namespaces
            raise AdmissionError(f"namespace {ns} not found")
        if nsobj.status.phase == "Terminating":
            raise AdmissionError(f"namespace {ns} is terminating")


class PriorityAdmission(AdmissionPlugin):
    """Resolve priorityClassName -> spec.priority
    (plugin/pkg/admission/priority/admission.go)."""

    name = "Priority"

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind != "pods":
            return
        pcn = obj.spec.priority_class_name
        if pcn:
            pc = store.get("priorityclasses", "", pcn) or store.get(
                "priorityclasses", "default", pcn)
            if pc is None:
                raise AdmissionError(f"priority class {pcn} not found")
            obj.spec.priority = pc.value
        elif obj.spec.priority is None:
            default = next((p for p in store.list("priorityclasses")
                            if getattr(p, "global_default", False)), None)
            obj.spec.priority = default.value if default else 0


class DefaultTolerationSeconds(AdmissionPlugin):
    """Add default notready/unreachable NoExecute tolerations with
    tolerationSeconds=300 (plugin/pkg/admission/defaulttolerationseconds)."""

    name = "DefaultTolerationSeconds"
    NOT_READY = "node.kubernetes.io/not-ready"
    UNREACHABLE = "node.kubernetes.io/unreachable"

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind != "pods":
            return
        tols = obj.spec.tolerations
        have_nr = any(t.key in ("", self.NOT_READY) and
                      t.effect in ("", api.NO_EXECUTE) for t in tols)
        have_ur = any(t.key in ("", self.UNREACHABLE) and
                      t.effect in ("", api.NO_EXECUTE) for t in tols)
        if not have_nr:
            tols.append(api.Toleration(key=self.NOT_READY, operator="Exists",
                                       effect=api.NO_EXECUTE,
                                       toleration_seconds=300))
        if not have_ur:
            tols.append(api.Toleration(key=self.UNREACHABLE, operator="Exists",
                                       effect=api.NO_EXECUTE,
                                       toleration_seconds=300))


# quota evaluator registry (pkg/quota/evaluator/core): per-kind usage
# contributions. A kind's evaluator returns {quota key -> delta} for one
# object; object COUNTS are served under both the legacy core key
# ("pods", "services", ...) and the generic count/<resource> form.
def _pod_usage(pod):
    req = api.get_resource_request(pod)
    return {"pods": 1, "count/pods": 1,
            "requests.cpu": req.get("cpu", 0), "cpu": req.get("cpu", 0),
            "requests.memory": req.get("memory", 0),
            "memory": req.get("memory", 0)}


def _service_usage(svc):
    out = {"services": 1, "count/services": 1}
    if svc.spec.type == "NodePort":
        out["services.nodeports"] = 1
    elif svc.spec.type == "LoadBalancer":
        out["services.loadbalancers"] = 1
    return out


def _pvc_usage(pvc):
    return {"persistentvolumeclaims": 1,
            "count/persistentvolumeclaims": 1,
            "requests.storage": (pvc.spec.requests or {}).get("storage", 0)}


QUOTA_EVALUATORS = {
    "pods": _pod_usage,
    "services": _service_usage,
    "persistentvolumeclaims": _pvc_usage,
    "configmaps": lambda o: {"configmaps": 1, "count/configmaps": 1},
    "secrets": lambda o: {"secrets": 1, "count/secrets": 1},
    "replicationcontrollers": lambda o: {
        "replicationcontrollers": 1, "count/replicationcontrollers": 1},
}


def _quota_live(kind: str, obj) -> bool:
    """Does this object currently consume quota? (pods: active only —
    the same predicate the controller's recompute uses)."""
    return kind != "pods" or api.is_pod_active(obj)


class ResourceQuotaAdmission(AdmissionPlugin):
    """Enforce hard quotas per namespace across the evaluator set —
    pod counts + compute requests, service counts (incl. nodeports/
    loadbalancers), PVC counts + storage requests, and generic object
    counts (plugin/pkg/admission/resourcequota +
    pkg/quota/evaluator/core)."""

    name = "ResourceQuota"

    @staticmethod
    def _scopes_match(scopes, kind, obj) -> bool:
        """pkg/quota scopes.go matchesScope: a scoped quota only counts
        objects every scope selects. Non-pod kinds never match a scoped
        quota (scopes are pod properties)."""
        if not scopes:
            return True
        if kind != "pods":
            return False
        for scope in scopes:
            qos = api.pod_qos_class(obj)
            terminating = obj.spec.active_deadline_seconds is not None
            if scope == "BestEffort" and qos != api.QOS_BEST_EFFORT:
                return False
            if scope == "NotBestEffort" and qos == api.QOS_BEST_EFFORT:
                return False
            if scope == "Terminating" and not terminating:
                return False
            if scope == "NotTerminating" and terminating:
                return False
        return True

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind not in QUOTA_EVALUATORS:
            return
        ns = obj.metadata.namespace
        quotas = [q for q in store.list("resourcequotas", ns)]
        if not quotas:
            return
        evaluator = QUOTA_EVALUATORS[kind]
        delta = evaluator(obj)
        used_by_quota: dict = {}
        for q in quotas:
            scopes = q.spec.scopes
            if not self._scopes_match(scopes, kind, obj):
                continue  # this quota doesn't govern the new object
            relevant = {k for k in q.spec.hard if k in delta}
            if not relevant:
                continue
            key_s = tuple(sorted(scopes))
            if key_s not in used_by_quota:
                used: dict = {}
                for existing in store.list(kind, ns):
                    if not _quota_live(kind, existing):
                        continue
                    if not self._scopes_match(scopes, kind, existing):
                        continue
                    for k, v in evaluator(existing).items():
                        used[k] = used.get(k, 0) + v
                used_by_quota[key_s] = used
            used = used_by_quota[key_s]
            for key, limit in q.spec.hard.items():
                if key not in delta:
                    continue
                total = used.get(key, 0) + delta[key]
                if total > limit:
                    raise AdmissionError(
                        f"exceeded quota {q.metadata.name}: {key} "
                        f"{total} > {limit}")


class NodeRestriction(AdmissionPlugin):
    """Kubelet identities (system:nodes group, user system:node:<name>) may
    only update their own Node object and pods bound to it
    (plugin/pkg/admission/noderestriction/admission.go)."""

    name = "NodeRestriction"

    def admit(self, op, kind, obj, old, user, store):
        if user is None or "system:nodes" not in user.groups:
            return
        node_name = user.name[len("system:node:"):] \
            if user.name.startswith("system:node:") else ""
        if kind == "nodes" and obj is not None:
            if obj.metadata.name != node_name:
                raise AdmissionError(
                    f"node {node_name} cannot modify node {obj.metadata.name}")
        if kind == "pods" and op in ("update", "delete"):
            target = obj if obj is not None else old
            if target is not None and target.spec.node_name and \
                    target.spec.node_name != node_name:
                raise AdmissionError(
                    f"node {node_name} cannot modify pod bound to "
                    f"{target.spec.node_name}")


class LimitRanger(AdmissionPlugin):
    """plugin/pkg/admission/limitranger: apply per-container request
    defaults from the namespace's LimitRanges, then enforce min/max on
    requests (defaulting BEFORE validation, limitranger/admission.go)."""

    name = "LimitRanger"

    def admit(self, op, kind, obj, old, user, store):
        if kind != "pods" or op != "create":
            return
        all_items = [it for lr in store.list("limitranges", obj.namespace)
                     for it in lr.spec.limits]
        items = [it for it in all_items if it.type == "Container"]
        # Pod-type limits bound the POD AGGREGATE — min against summed
        # requests, max against summed LIMITS (falling back to the
        # request when a container sets no limit), matching
        # limitranger/admission.go PodLimitFunc's Pod branch
        pod_items = [i for i in all_items if i.type == "Pod"]
        if pod_items:
            req_totals: dict = {}
            lim_totals: dict = {}
            for c in obj.spec.containers:
                for r, v in c.resources.requests.items():
                    req_totals[r] = req_totals.get(r, 0) + v
                # sorted: the float accumulation below rounds in
                # iteration order, and set order follows the per-process
                # string hash seed
                for r in sorted(set(c.resources.requests)
                                | set(c.resources.limits)):
                    v = c.resources.limits.get(
                        r, c.resources.requests.get(r, 0))
                    lim_totals[r] = lim_totals.get(r, 0) + v
            for it in pod_items:
                for r, lo in it.min.items():
                    if req_totals.get(r, 0) < lo:
                        raise AdmissionError(
                            f"minimum {r} usage per Pod is {lo}; pod "
                            f"{obj.metadata.name!r} requests "
                            f"{req_totals.get(r, 0)}")
                for r, hi in it.max.items():
                    if lim_totals.get(r, 0) > hi:
                        raise AdmissionError(
                            f"maximum {r} usage per Pod is {hi}; pod "
                            f"{obj.metadata.name!r} limits "
                            f"{lim_totals.get(r)}")
        if not items:
            return
        for c in obj.spec.containers:
            reqs = c.resources.requests
            lims = c.resources.limits
            for it in items:
                for r, v in it.default.items():
                    lims.setdefault(r, v)
                for r, v in it.default_request.items():
                    # limitranger/admission.go: absent defaultRequest
                    # falls back to the default limit
                    reqs.setdefault(r, v)
                for r, v in it.default.items():
                    reqs.setdefault(r, v)
            for it in items:
                for r, lo in it.min.items():
                    if reqs.get(r, 0) < lo:
                        raise AdmissionError(
                            f"minimum {r} usage per Container is {lo}; "
                            f"container {c.name!r} requests {reqs.get(r, 0)}")
                for r, hi in it.max.items():
                    if reqs.get(r, 0) > hi:
                        raise AdmissionError(
                            f"maximum {r} usage per Container is {hi}; "
                            f"container {c.name!r} requests {reqs.get(r)}")
                    if r in lims and lims[r] > hi:
                        raise AdmissionError(
                            f"maximum {r} usage per Container is {hi}; "
                            f"container {c.name!r} limits {lims[r]}")


class ServiceAccountAdmission(AdmissionPlugin):
    """plugin/pkg/admission/serviceaccount: default
    spec.serviceAccountName to 'default', require the account to exist
    (admission.go DefaultServiceAccountName + fetch check), and inject
    the SA's token Secret as a pod VOLUME unless the SA opts out via
    automountServiceAccountToken=false (admission.go
    mountServiceAccountToken, collapsed to volume injection — this pod
    model carries no per-container mount paths)."""

    name = "ServiceAccount"

    def admit(self, op, kind, obj, old, user, store):
        if kind != "pods" or op != "create":
            return
        if not obj.spec.service_account_name:
            obj.spec.service_account_name = "default"
        sa = store.get("serviceaccounts", obj.namespace,
                       obj.spec.service_account_name)
        if sa is None:
            raise AdmissionError(
                f"service account {obj.namespace}/"
                f"{obj.spec.service_account_name} not found")
        if getattr(sa, "automount_service_account_token", True) is False:
            return
        token_secret = f"{sa.metadata.name}-token"
        vol_name = f"{sa.metadata.name}-token"
        if store.get("secrets", obj.namespace, token_secret) is None:
            return  # tokens controller hasn't minted it yet
        if not any(v.name == vol_name for v in obj.spec.volumes):
            obj.spec.volumes = list(obj.spec.volumes) + [
                api.Volume(name=vol_name, secret=token_secret)]


POD_NODE_SELECTOR_ANNOTATION = "scheduler.alpha.kubernetes.io/node-selector"


class PodNodeSelector(AdmissionPlugin):
    """plugin/pkg/admission/podnodeselector: merge the namespace's
    node-selector annotation into pod.spec.nodeSelector; a conflicting
    pod selector is forbidden."""

    name = "PodNodeSelector"

    def admit(self, op, kind, obj, old, user, store):
        if kind != "pods" or op != "create":
            return
        ns = store.get("namespaces", "", obj.namespace) or \
            store.get("namespaces", "default", obj.namespace)
        if ns is None:
            return
        raw = (ns.metadata.annotations or {}).get(
            POD_NODE_SELECTOR_ANNOTATION, "")
        if not raw:
            return
        for pair in raw.split(","):
            k, _, v = pair.strip().partition("=")
            if not k:
                continue
            cur = obj.spec.node_selector.get(k)
            if cur is not None and cur != v:
                raise AdmissionError(
                    f"pod node selector {k}={cur} conflicts with namespace "
                    f"node selector {k}={v}")
            obj.spec.node_selector[k] = v


class AlwaysPullImages(AdmissionPlugin):
    """Force imagePullPolicy=Always on every container so multi-tenant
    nodes can't read a neighbor's cached private image
    (plugin/pkg/admission/alwayspullimages/admission.go:48)."""

    name = "AlwaysPullImages"

    def admit(self, op, kind, obj, old, user, store):
        if kind != "pods" or op not in ("create", "update"):
            return
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            c.image_pull_policy = "Always"


class SecurityContextDeny(AdmissionPlugin):
    """Reject privileged containers
    (plugin/pkg/admission/securitycontext/scdeny/admission.go:57; the
    model carries the privileged bit only)."""

    name = "SecurityContextDeny"

    def admit(self, op, kind, obj, old, user, store):
        # create AND update: an update could otherwise flip a container
        # privileged after admission (ref scdeny handles both ops)
        if kind != "pods" or op not in ("create", "update"):
            return
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            if c.privileged:
                raise AdmissionError(
                    f"container {c.name!r}: privileged containers are "
                    f"not allowed")


class EventRateLimit(AdmissionPlugin):
    """Token-bucket rate limit on Event writes, server-scoped
    (plugin/pkg/admission/eventratelimit/admission.go:69; qps/burst per
    the server limit type in its config API)."""

    name = "EventRateLimit"

    def __init__(self, qps: float = 50.0, burst: int = 100, clock=None):
        import threading
        import time as _time

        self.qps = qps
        self.burst = burst
        self.clock = clock or _time.monotonic
        self._tokens = float(burst)
        self._last = self.clock()
        # the apiserver is threaded: concurrent event creates must not
        # interleave the read-modify-write of the bucket
        self._mu = threading.Lock()

    def admit(self, op, kind, obj, old, user, store):
        if kind != "events" or op != "create":
            return
        with self._mu:
            now = self.clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.qps)
            self._last = now
            if self._tokens < 1.0:
                raise AdmissionError("event rate limit exceeded", code=429)
            self._tokens -= 1.0


class PodTolerationRestriction(AdmissionPlugin):
    """Merge namespace default tolerations into pods and enforce the
    namespace whitelist
    (plugin/pkg/admission/podtolerationrestriction/admission.go:96).
    Namespace annotations (JSON lists of {key,operator,value,effect}):
      scheduler.alpha.kubernetes.io/defaultTolerations
      scheduler.alpha.kubernetes.io/tolerationsWhitelist
    """

    name = "PodTolerationRestriction"

    DEFAULTS_ANN = "scheduler.alpha.kubernetes.io/defaultTolerations"
    WHITELIST_ANN = "scheduler.alpha.kubernetes.io/tolerationsWhitelist"

    @staticmethod
    def _parse(raw) -> List[api.Toleration]:
        import json

        try:
            docs = json.loads(raw)
            if not isinstance(docs, list):
                raise ValueError("expected a JSON list")
            return [api.Toleration(key=d.get("key", ""),
                                   operator=d.get("operator", "Equal"),
                                   value=d.get("value", ""),
                                   effect=d.get("effect", ""))
                    for d in docs]
        except (ValueError, AttributeError, TypeError) as e:
            # a bad namespace annotation must reject pods with a
            # descriptive admission error, not 500 every create
            raise AdmissionError(
                f"invalid toleration annotation on namespace: {e}")

    def admit(self, op, kind, obj, old, user, store):
        if kind != "pods" or op != "create":
            return
        ns = store.get("namespaces", "", obj.metadata.namespace) or \
            store.get("namespaces", "default", obj.metadata.namespace)
        if ns is None:
            return
        ann = ns.metadata.annotations or {}
        if self.DEFAULTS_ANN in ann:
            existing = {(t.key, t.operator, t.value, t.effect)
                        for t in obj.spec.tolerations}
            for t in self._parse(ann[self.DEFAULTS_ANN]):
                if (t.key, t.operator, t.value, t.effect) not in existing:
                    obj.spec.tolerations.append(t)
        if self.WHITELIST_ANN in ann:
            allowed = {(t.key, t.operator, t.value, t.effect)
                       for t in self._parse(ann[self.WHITELIST_ANN])}
            for t in obj.spec.tolerations:
                if (t.key, t.operator, t.value, t.effect) not in allowed:
                    raise AdmissionError(
                        f"toleration {t.key!r} not allowed by namespace "
                        f"whitelist")


class LimitPodHardAntiAffinityTopology(AdmissionPlugin):
    """Required pod anti-affinity may only use the hostname topology key
    (plugin/pkg/admission/antiaffinity/admission.go:54 — unbounded
    topology keys let one pod exclude whole zones/regions)."""

    name = "LimitPodHardAntiAffinityTopology"

    def admit(self, op, kind, obj, old, user, store):
        if kind != "pods" or op not in ("create", "update"):
            return
        aff = obj.spec.affinity
        if aff is None or aff.pod_anti_affinity is None:
            return
        for term in aff.pod_anti_affinity.required:
            if term.topology_key != "kubernetes.io/hostname":
                raise AdmissionError(
                    f"required pod anti-affinity topology key must be "
                    f"kubernetes.io/hostname, got {term.topology_key!r}")


class ExtendedResourceToleration(AdmissionPlugin):
    """Auto-tolerate taints named after extended resources the pod
    requests (plugin/pkg/admission/extendedresourcetoleration/
    admission.go:54): clusters taint accelerator nodes with the resource
    name so only requesting pods land there."""

    name = "ExtendedResourceToleration"

    @staticmethod
    def _extended(res_name: str) -> bool:
        return "/" in res_name and not res_name.startswith("kubernetes.io/")

    def admit(self, op, kind, obj, old, user, store):
        if kind != "pods" or op != "create":
            return
        wanted = set()
        for c in list(obj.spec.containers) + list(obj.spec.init_containers):
            for res_name in (c.resources.requests or {}):
                if self._extended(str(res_name)):
                    wanted.add(str(res_name))
        have = {t.key for t in obj.spec.tolerations}
        for res_name in sorted(wanted - have):
            obj.spec.tolerations.append(api.Toleration(
                key=res_name, operator=api.TOLERATION_OP_EXISTS))


class PodSecurityPolicyAdmission(AdmissionPlugin):
    """Validate pods against the registered PodSecurityPolicies: a pod
    is admitted if ANY policy allows every aspect of it
    (plugin/pkg/admission/security/podsecuritypolicy/admission.go:171;
    the reference additionally filters policies by RBAC `use` authority,
    which this model folds into policy existence)."""

    name = "PodSecurityPolicy"

    VOLUME_FIELDS = (
        ("empty_dir", "emptyDir"), ("host_path", "hostPath"),
        ("config_map", "configMap"), ("secret", "secret"),
        ("downward_api", "downwardAPI"), ("nfs_server", "nfs"),
        ("pvc_name", "persistentVolumeClaim"), ("projected", "projected"),
        ("source_kind", None))  # PD-family kinds use the kind name itself

    @classmethod
    def _volume_kind(cls, v: api.Volume) -> str:
        for attr, name in cls.VOLUME_FIELDS:
            if getattr(v, attr):
                return name if name is not None else v.source_kind
        return "unknown"

    def _allows(self, psp: api.PodSecurityPolicy, pod: api.Pod) -> bool:
        spec = psp.spec
        for c in list(pod.spec.containers) + list(pod.spec.init_containers):
            if c.privileged and not spec.privileged:
                return False
            for p in c.ports:
                hp = getattr(p, "host_port", 0)
                # default-DENY: a host port needs an explicit allowing
                # range (ref PSP hostPorts semantics; unlike
                # allowedHostPaths, where empty means unrestricted)
                if hp and not any(lo <= hp <= hi
                                  for lo, hi in spec.host_ports):
                    return False
        for v in pod.spec.volumes:
            kind = self._volume_kind(v)
            if "*" not in spec.volumes and kind not in spec.volumes:
                return False
            if kind == "hostPath" and spec.allowed_host_paths and not any(
                    v.host_path.startswith(pref)
                    for pref in spec.allowed_host_paths):
                return False
        return True

    def admit(self, op, kind, obj, old, user, store):
        if kind != "pods" or op != "create":
            return
        policies = store.list("podsecuritypolicies")
        if not policies:
            return  # no PSPs registered: admission is a no-op (ref same)
        if not any(self._allows(psp, obj) for psp in policies):
            raise AdmissionError(
                "unable to validate against any pod security policy")


class PodPresetAdmission(AdmissionPlugin):
    """Inject env/volumes from matching PodPresets at pod creation
    (plugin/pkg/admission/podpreset/admission.go): every PodPreset in
    the pod's namespace whose selector matches the pod's labels merges
    its env into every container and appends its volumes; applied
    presets are recorded in annotations. A conflict (same env key,
    different value) skips the preset entirely, as in the reference."""

    name = "PodPreset"

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind != "pods":
            return
        for preset in store.list("podpresets", obj.metadata.namespace):
            sel = (preset.selector.to_selector()
                   if preset.selector is not None else None)
            if sel is not None and sel.requirements and \
                    not sel.matches(obj.metadata.labels or {}):
                continue
            conflict = any(
                c.env.get(k) not in (None, v)
                for c in obj.spec.containers
                for k, v in preset.env.items())
            if conflict:
                continue
            for c in obj.spec.containers:
                merged = dict(preset.env)
                merged.update(c.env or {})
                c.env = merged
            existing = {v.name for v in obj.spec.volumes}
            obj.spec.volumes.extend(v for v in preset.volumes
                                    if v.name not in existing)
            obj.metadata.annotations = dict(obj.metadata.annotations or {})
            obj.metadata.annotations[
                f"podpreset.admission.kubernetes.io/podpreset-"
                f"{preset.metadata.name}"] = \
                str(preset.metadata.resource_version)


class ImagePolicyWebhook(AdmissionPlugin):
    """POST an ImageReview to a backend webhook; deny pods whose images
    the backend rejects (plugin/pkg/admission/imagepolicy/admission.go).
    default_allow governs backend failure (the kubeconfig's
    defaultAllow)."""

    name = "ImagePolicyWebhook"

    def __init__(self, backend_url: str, default_allow: bool = False,
                 timeout: float = 5.0):
        self.backend_url = backend_url
        self.default_allow = default_allow
        self.timeout = timeout

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind != "pods":
            return
        import json as _json
        import urllib.error
        import urllib.request

        review = {"apiVersion": "imagepolicy.k8s.io/v1alpha1",
                  "kind": "ImageReview",
                  "spec": {"containers": [{"image": c.image}
                                          for c in obj.spec.containers],
                           "namespace": obj.metadata.namespace}}
        req = urllib.request.Request(
            self.backend_url, data=_json.dumps(review).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                resp = _json.loads(r.read() or b"{}")
        except (urllib.error.URLError, OSError, ValueError):
            if self.default_allow:
                return
            raise AdmissionError(
                "image policy webhook unreachable (defaultAllow=false)")
        status = resp.get("status", {})
        if not status.get("allowed", False):
            raise AdmissionError(
                f"image policy denied: "
                f"{status.get('reason', 'unspecified')}")


class OwnerReferencesPermissionEnforcement(AdmissionPlugin):
    """Setting blockOwnerDeletion on an owner reference requires update
    permission on the owner's finalizers subresource
    (plugin/pkg/admission/gc/gc_admission.go) — otherwise any creator
    could block foreground deletion of objects it cannot touch."""

    name = "OwnerReferencesPermissionEnforcement"

    def __init__(self, authorizer=None):
        self.authorizer = authorizer

    def admit(self, op, kind, obj, old, user, store):
        if op not in ("create", "update") or self.authorizer is None \
                or user is None:
            return
        refs = getattr(obj.metadata, "owner_references", None) or []
        old_blocking = {r.uid for r in
                        (getattr(old.metadata, "owner_references", None)
                         or [])
                        if r.block_owner_deletion} if old is not None else set()
        for ref in refs:
            if not ref.block_owner_deletion or ref.uid in old_blocking:
                continue
            from ..api import scheme

            plural = scheme.plural_for_kind(ref.kind) or ref.kind.lower()
            if not self.authorizer.authorize(
                    user, "update", f"{plural}/finalizers",
                    namespace=obj.metadata.namespace, name=ref.name):
                raise AdmissionError(
                    f"user {user.name} cannot set blockOwnerDeletion on "
                    f"{ref.kind}/{ref.name}: no update permission on "
                    f"{plural}/finalizers")


class DenyEscalatingExec(AdmissionPlugin):
    """Deny exec/attach into privileged or host-namespace pods
    (plugin/pkg/admission/exec/admission.go DenyEscalatingExec) — an
    exec into a privileged container is a node escalation."""

    name = "DenyEscalatingExec"

    def admit(self, op, kind, obj, old, user, store):
        if kind not in ("pods/exec", "pods/attach"):
            return
        if any(c.privileged for c in obj.spec.containers) \
                or obj.spec.host_network:
            raise AdmissionError(
                f"cannot exec into or attach to a privileged or "
                f"host-namespace pod {obj.metadata.name}")


class DefaultStorageClass(AdmissionPlugin):
    """Claims without a storage class get the cluster default
    (plugin/pkg/admission/storageclass/setdefault/admission.go);
    ambiguous defaults (two marked) reject, as in the reference."""

    name = "DefaultStorageClass"

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind != "persistentvolumeclaims":
            return
        if obj.spec.storage_class_name:
            return
        defaults = [sc for sc in store.list("storageclasses")
                    if sc.is_default]
        if not defaults:
            return
        if len(defaults) > 1:
            raise AdmissionError(
                f"{len(defaults)} default StorageClasses were found")
        sc = defaults[0]
        obj.spec.storage_class_name = sc.metadata.name
        if sc.provisioner:
            obj.metadata.annotations = dict(obj.metadata.annotations or {})
            obj.metadata.annotations.setdefault(
                "volume.beta.kubernetes.io/storage-provisioner",
                sc.provisioner)


class NamespaceAutoProvision(AdmissionPlugin):
    """Create the namespace on first use instead of rejecting
    (plugin/pkg/admission/namespace/autoprovision) — the
    NamespaceLifecycle alternative for soft-multitenancy clusters."""

    name = "NamespaceAutoProvision"

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind == "namespaces":
            return
        ns = getattr(obj.metadata, "namespace", "")
        if not ns:
            return
        if store.get("namespaces", "", ns) is None and \
                store.get("namespaces", "default", ns) is None:
            from ..runtime.store import Conflict

            try:
                store.create("namespaces", api.Namespace(
                    metadata=api.ObjectMeta(name=ns),
                    status=api.NamespaceStatus(phase="Active")))
            except Conflict:
                pass


class AlwaysAdmit(AdmissionPlugin):
    """Accept everything (plugin/pkg/admission/admit) — the no-op
    plugin kept for explicit configuration parity; deprecated in the
    reference the same way."""

    name = "AlwaysAdmit"

    def admit(self, op, kind, obj, old, user, store):
        return


class AlwaysDeny(AdmissionPlugin):
    """Reject everything (plugin/pkg/admission/deny) — used in tests
    and to fence a server off during maintenance; never in the default
    chain."""

    name = "AlwaysDeny"

    def admit(self, op, kind, obj, old, user, store):
        raise AdmissionError("admission plugin AlwaysDeny denied the request")


class NamespaceExists(AdmissionPlugin):
    """Reject objects created in namespaces that don't exist
    (plugin/pkg/admission/namespace/exists) — the standalone
    existence check; NamespaceLifecycle subsumes it in the default
    chain but operators can still select it alone."""

    name = "NamespaceExists"
    immortal = ("default", "kube-system", "kube-public")

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind == "namespaces":
            return
        from ..api import scheme

        k = scheme.kind_for_plural(kind.split("/")[0])
        if k is not None and not scheme.is_namespaced(k):
            return  # cluster-scoped: GetNamespace() is empty in the ref
        ns = getattr(obj.metadata, "namespace", "")
        if not ns or ns in self.immortal:
            return
        if store.get("namespaces", "", ns) is None and \
                store.get("namespaces", "default", ns) is None:
            raise AdmissionError(f"namespace {ns} does not exist", code=404)


class DenyExecOnPrivileged(AdmissionPlugin):
    """Deny exec/attach into pods with privileged containers
    (plugin/pkg/admission/exec/admission.go DenyExecOnPrivileged — the
    deprecated narrower sibling of DenyEscalatingExec: privileged
    containers only, host namespaces allowed)."""

    name = "DenyExecOnPrivileged"

    def admit(self, op, kind, obj, old, user, store):
        if kind not in ("pods/exec", "pods/attach"):
            return
        if any(c.privileged for c in obj.spec.containers):
            raise AdmissionError(
                f"cannot exec into or attach to a privileged container "
                f"in pod {obj.metadata.name}")


class PersistentVolumeClaimResize(AdmissionPlugin):
    """plugin/pkg/admission/storage/persistentvolume/resize: shrinking a
    claim is always forbidden, and growing one requires a bound claim
    whose StorageClass sets allowVolumeExpansion."""

    name = "PersistentVolumeClaimResize"

    def admit(self, op, kind, obj, old, user, store):
        from ..api import resources as res

        if op != "update" or kind != "persistentvolumeclaims" or \
                old is None:
            return
        new_req = obj.spec.requests.get(res.STORAGE, 0)
        old_req = old.spec.requests.get(res.STORAGE, 0)
        if new_req == old_req:
            return
        if new_req < old_req:
            raise AdmissionError(
                "persistent volume claims cannot be shrunk: requested "
                f"{new_req} < current {old_req}", code=422)
        if not old.spec.volume_name:
            raise AdmissionError(
                "only bound claims can be expanded", code=422)
        sc_name = old.spec.storage_class_name
        sc = store.get("storageclasses", "", sc_name) or \
            store.get("storageclasses", "default", sc_name)
        if sc is None or not sc.allow_volume_expansion:
            raise AdmissionError(
                "only claims whose StorageClass sets "
                "allowVolumeExpansion can be expanded", code=403)


class PersistentVolumeLabel(AdmissionPlugin):
    """Stamp cloud zone/region failure-domain labels onto new
    PersistentVolumes (plugin/pkg/admission/storage/persistentvolume/
    label) so NoVolumeZoneConflict can fence pods to the volume's
    zone. Operator-constructed with the cluster's cloud provider, like
    the reference's admission config."""

    name = "PersistentVolumeLabel"
    ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
    REGION_LABEL = "failure-domain.beta.kubernetes.io/region"

    def __init__(self, cloud=None):
        self.cloud = cloud

    def admit(self, op, kind, obj, old, user, store):
        if op != "create" or kind != "persistentvolumes" \
                or self.cloud is None:
            return
        zones = self.cloud.zones()
        if zones is None:
            return
        zone = zones.get_zone()
        labels = dict(obj.metadata.labels or {})
        labels.setdefault(self.ZONE_LABEL, zone.failure_domain)
        labels.setdefault(self.REGION_LABEL, zone.region)
        obj.metadata.labels = labels


class AdmissionChain:
    """Ordered plugin chain (admission/chain.go chainAdmissionHandler)."""

    def __init__(self, plugins: Optional[List[AdmissionPlugin]] = None):
        self.plugins = plugins if plugins is not None else []

    @staticmethod
    def default() -> "AdmissionChain":
        """The reference's recommended order (kubeapiserver/options/
        plugins.go): mutators before validators, quota last.
        Config-requiring plugins (ImagePolicyWebhook needs a backend,
        OwnerReferencesPermissionEnforcement an authorizer,
        NamespaceAutoProvision replaces NamespaceLifecycle) are
        constructed explicitly by operators, as in the reference's
        --enable-admission-plugins."""
        return AdmissionChain([NamespaceLifecycle(), PodPresetAdmission(),
                               LimitRanger(), DefaultStorageClass(),
                               PersistentVolumeClaimResize(),
                               ServiceAccountAdmission(), PodNodeSelector(),
                               PriorityAdmission(),
                               DefaultTolerationSeconds(),
                               NodeRestriction(), DenyEscalatingExec(),
                               ResourceQuotaAdmission()])

    def admit(self, op: str, kind: str, obj, old, user: Optional[UserInfo],
              store: ObjectStore):
        for p in self.plugins:
            p.admit(op, kind, obj, old, user, store)
