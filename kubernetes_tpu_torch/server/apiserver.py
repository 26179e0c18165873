"""HTTP REST API server over the object store.

A copy of kubernetes_tpu/server/apiserver.py; its relative imports resolve in this
package.

The reference's kube-apiserver reduced to its load-bearing walls:

  handler chain   authn -> authz -> admission -> storage
                  (apiserver/pkg/server/config.go
                   DefaultBuildHandlerChainFunc; admission runs inside the
                   create/update handlers, endpoints/handlers/create.go)
  REST mapping    /api/v1/... and /apis/<group>/<version>/... routes to
                  per-resource CRUD (endpoints/installer.go ->
                  registry/generic/registry/store.go)
  watch           ?watch=true streams JSON-lines watch events served from
                  the broadcaster's in-memory window (storage/cacher.go);
                  a too-old resourceVersion returns 410 Gone
  subresources    pods/<name>/binding (the scheduler's bind POST,
                  registry/core/pod/storage BindingREST), pods/<name>/status,
                  nodes/<name>/status, namespaces/<name>/finalize
  ops endpoints   /healthz, /metrics, /version, /api, /apis

Wire format: JSON with camelCase keys via api/scheme.py codecs.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, quote, urlparse

from ..api import scheme
from ..api import types as api
from ..runtime.store import Conflict, ObjectStore
from ..runtime.watch import Broadcaster, TooOld
from ..api import validation
from .admission import AdmissionChain, AdmissionError
from .auth import RBACAuthorizer, TokenAuthenticator, UserInfo


class APIError(Exception):
    def __init__(self, code: int, reason: str, message: str):
        super().__init__(message)
        self.code, self.reason, self.message = code, reason, message


def _status_body(code: int, reason: str, message: str,
                 status: str = "Failure") -> bytes:
    return json.dumps({"kind": "Status", "apiVersion": "v1", "status": status,
                       "reason": reason, "message": message, "code": code}).encode()


# verbs per HTTP method (reference: endpoints/installer.go mapping)
_VERBS = {"GET": "get", "POST": "create", "PUT": "update",
          "PATCH": "patch", "DELETE": "delete"}


def _openapi_type(t) -> dict:
    """Python type annotation -> OpenAPI v2 schema fragment."""
    import dataclasses
    import typing

    origin = typing.get_origin(t)
    args = typing.get_args(t)
    if origin is list:
        return {"type": "array",
                "items": _openapi_type(args[0]) if args else {}}
    if origin is dict or t in (dict, typing.Dict):
        # bare Dict/dict (e.g. ControllerRevision.data): untyped object
        return {"type": "object",
                "additionalProperties":
                    _openapi_type(args[1]) if len(args) == 2 else {}}
    if origin is typing.Union:  # Optional[X]
        inner = [a for a in typing.get_args(t) if a is not type(None)]
        return _openapi_type(inner[0]) if inner else {}
    if t is str:
        return {"type": "string"}
    if t is int:
        return {"type": "integer"}
    if t is float:
        return {"type": "number"}
    if t is bool:
        return {"type": "boolean"}
    if dataclasses.is_dataclass(t):
        return {"$ref": f"#/definitions/{t.__name__}"}
    return {}


_openapi_cache: Dict[frozenset, dict] = {}


def _openapi_spec() -> dict:
    """Swagger 2.0 document over every registered kind (definitions from
    dataclass reflection; paths list the CRUD routes the REST mapper
    serves). Cached per registered-kind set — the reflection walk is
    dozens of types deep and kinds only change on CRD (de)registration."""
    import dataclasses
    import typing

    cache_key = frozenset(scheme.all_kinds())
    hit = _openapi_cache.get(cache_key)
    if hit is not None:
        return hit

    definitions: Dict[str, dict] = {}

    def add_def(t):
        name = t.__name__
        if name in definitions or not dataclasses.is_dataclass(t):
            return
        definitions[name] = {"type": "object", "properties": {}}
        try:
            hints = typing.get_type_hints(t)
        except Exception:
            hints = {f.name: f.type for f in dataclasses.fields(t)}
        for f in dataclasses.fields(t):
            ft = hints.get(f.name, f.type)
            definitions[name]["properties"][f.name] = _openapi_type(ft)
            for sub in _walk_types(ft):
                add_def(sub)

    def _walk_types(t):
        origin = typing.get_origin(t)
        if origin in (list, dict):
            for a in typing.get_args(t):
                yield from _walk_types(a)
        elif origin is typing.Union:
            for a in typing.get_args(t):
                if a is not type(None):
                    yield from _walk_types(a)
        elif dataclasses.is_dataclass(t):
            yield t
        return

    paths = {}
    for kind in sorted(scheme.all_kinds()):
        typ = scheme.type_for_kind(kind)
        add_def(typ)
        plural = scheme.plural_for_kind(kind)
        gv = scheme.api_version_for(kind)
        prefix = (f"/api/{gv}" if "/" not in gv else f"/apis/{gv}")
        base = (f"{prefix}/namespaces/{{namespace}}/{plural}"
                if scheme.is_namespaced(kind) else f"{prefix}/{plural}")
        ref = {"$ref": f"#/definitions/{typ.__name__}"}
        paths[base] = {"get": {"responses": {"200": {}}},
                       "post": {"parameters": [{"in": "body",
                                               "schema": ref}],
                                "responses": {"201": {}}}}
        paths[base + "/{name}"] = {
            "get": {"responses": {"200": {"schema": ref}}},
            "put": {"responses": {"200": {}}},
            "delete": {"responses": {"200": {}}}}
    spec = {"swagger": "2.0",
            "info": {"title": "kubernetes_tpu", "version": "v1.11-tpu"},
            "paths": paths, "definitions": definitions}
    _openapi_cache.clear()  # one live entry: kind-set changes are rare
    _openapi_cache[cache_key] = spec
    return spec


class APIServer:
    def __init__(self, store: ObjectStore,
                 authenticator: Optional[TokenAuthenticator] = None,
                 authorizer: Optional[RBACAuthorizer] = None,
                 admission: Optional[AdmissionChain] = None,
                 audit_sink: Optional[Callable[[dict], None]] = None,
                 metrics_providers: Optional[List[Callable[[], str]]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 reconcile_endpoints: bool = False,
                 max_in_flight: int = 0, max_mutating_in_flight: int = 0,
                 audit_policy: str = "Metadata", tls=None):
        self.store = store
        self.broadcaster = Broadcaster(store)
        self.authenticator = authenticator
        self.authorizer = authorizer
        self.admission = admission if admission is not None else AdmissionChain()
        self.audit_sink = audit_sink
        self.metrics_providers = metrics_providers or []
        self.request_count: Dict[str, int] = {}
        self._count_lock = threading.Lock()
        self._reconcile_endpoints = reconcile_endpoints
        self.endpoint_reconciler = None
        # flow control (filters/maxinflight.go): bounded concurrent
        # requests, split readonly/mutating; saturation -> 429
        self._readonly_sem = (threading.BoundedSemaphore(max_in_flight)
                              if max_in_flight > 0 else None)
        self._mutating_sem = (
            threading.BoundedSemaphore(max_mutating_in_flight)
            if max_mutating_in_flight > 0 else None)
        # audit policy level (auditpolicy: "None" disables the sink,
        # "Metadata" records verb/resource/user — the reference's levels
        # minus request-body capture)
        self.audit_policy = audit_policy
        # CRD-lite (apiextensions-apiserver): creating a
        # CustomResourceDefinition registers its kind in the scheme so
        # /apis/<group>/<version>/<plural> CRUD+watch routes resolve;
        # deleting it unregisters. Pre-existing CRDs (durable store
        # restart) register during the informer's initial list.
        from ..runtime.informer import SharedInformer

        def _crd_add(crd):
            try:
                scheme.register_dynamic(crd)
            except ValueError:
                pass  # conflicting CRD written by a direct store writer

        def _crd_update(old, new):
            if old.spec.names.kind != new.spec.names.kind:
                scheme.unregister(old.spec.names.kind)
            try:
                scheme.register_dynamic(new, replacing=old.spec.names.kind)
            except ValueError:
                pass  # conflicting CRD from a direct store writer

        self._crd_informer = SharedInformer(store, "customresourcedefinitions")
        self._crd_informer.add_event_handler(
            on_add=_crd_add, on_update=_crd_update,
            on_delete=lambda crd: scheme.unregister(crd.spec.names.kind))

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # silence default stderr logging
                pass

            def _dispatch(self):
                try:
                    server._handle(self)
                except APIError as e:
                    self._send(e.code, _status_body(e.code, e.reason, e.message))
                except BrokenPipeError:
                    pass
                except Exception as e:  # 500 InternalError
                    self._send(500, _status_body(500, "InternalError", repr(e)))

            do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _dispatch

            def _send(self, code: int, body: bytes,
                      content_type: str = "application/json"):
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", content_type)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        # tls: a pki.ClusterCA. Serve HTTPS with a CA-issued serving
        # cert; client certs are verified by the handshake against the
        # same CA and their subject becomes the request's x509 identity
        # (authentication/request/x509/x509.go:76 reads the verified
        # peer chain from the TLS layer — the real thing, not a header).
        self._tls = tls
        self._kubelet_client_ctx = None
        if tls is not None:
            from . import pki

            key_pem, cert_pem = pki.issue_server_cert(
                tls, "kube-apiserver",
                dns_sans=("localhost", "kubernetes", "kubernetes.default",
                          "kubernetes.default.svc"),
                ip_sans=("127.0.0.1",))
            pki.wrap_http_server(self.httpd, pki.server_ssl_context(
                tls.ca_cert_pem, cert_pem, key_pem))
            # the apiserver is itself a TLS CLIENT toward kubelets (the
            # exec/log proxy); kubelet servers demand a CA-issued client
            # cert, so mint the kubelet-client identity the reference
            # keeps in apiserver-kubelet-client.crt
            ck_pem, ccsr = pki.make_csr("kube-apiserver",
                                        ("system:masters",))
            self._kubelet_client_ctx = pki.client_ssl_context(
                tls.ca_cert_pem, tls.sign_csr(ccsr), ck_pem)
        scheme_str = "https" if tls is not None else "http"
        self.url = f"{scheme_str}://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "APIServer":
        self._bootstrap_priority_classes()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="apiserver", daemon=True)
        self._thread.start()
        if self._reconcile_endpoints:
            # HA scale-out: publish this replica in the shared
            # "kubernetes" Endpoints under a lease (master.go:199-248)
            from .reconciler import EndpointReconciler

            host, port = self.httpd.server_address[:2]
            # host:port as the replica identity — unlike the reference's
            # one-IP-per-master assumption, in-process replicas share the
            # host and differ by port
            self.endpoint_reconciler = EndpointReconciler(
                self.store, f"{host}:{port}", port).start()
        return self

    def stop(self):
        if self.endpoint_reconciler is not None:
            self.endpoint_reconciler.stop()
            self.endpoint_reconciler = None
        self.httpd.shutdown()
        self.httpd.server_close()
        # deregister this server's store watchers: a replaced apiserver
        # (kubeadm upgrade) must not keep consuming every event through
        # its dead broadcaster/CRD informer forever
        unwatch = getattr(self.store, "unwatch", None)
        if unwatch is not None:
            unwatch(self.broadcaster._on_event)
            unwatch(self._crd_informer._handle)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- handler chain ---------------------------------------------------------

    def _handle(self, h):
        parsed = urlparse(h.path)
        parts = [p for p in parsed.path.split("/") if p]
        query = parse_qs(parsed.query)

        # authn runs first — ops endpoints bypass authz/admission but not
        # authentication (healthz stays open, like the reference's
        # always-allowed /healthz delegating authorizer path)
        user = None
        if self.authenticator is not None and parts != ["healthz"]:
            peer = None
            if self._tls is not None:
                from . import pki

                peer = pki.peer_identity(h.connection)
            auth_req = getattr(self.authenticator, "authenticate_request",
                               None)
            user = (auth_req(h.headers, peer) if auth_req is not None else
                    self.authenticator.authenticate(
                        h.headers.get("Authorization")))
            if user is None:
                raise APIError(401, "Unauthorized", "authentication failed")
        if parts == ["healthz"]:
            return h._send(200, b"ok", "text/plain")
        if parts == ["version"]:
            return h._send(200, json.dumps(
                {"major": "1", "minor": "11", "gitVersion": "v1.11.0-tpu"}).encode())
        if parts == ["metrics"]:
            text = self._metrics_text()
            return h._send(200, text.encode(), "text/plain")
        if parts == ["api"]:
            return h._send(200, json.dumps({"kind": "APIVersions",
                                            "versions": ["v1"]}).encode())
        if parts == ["apis"]:
            groups = sorted({gv.split("/")[0]
                             for k in scheme.all_kinds()
                             for gv in scheme.served_versions(k)
                             if "/" in gv})
            return h._send(200, json.dumps({"kind": "APIGroupList",
                                            "groups": groups}).encode())
        if parts == ["openapi", "v2"]:
            # OpenAPI v2 spec generated from the dataclass model
            # (apiserver's /openapi/v2, k8s.io/kube-openapi; consumed by
            # kubectl explain/validation in the reference)
            return h._send(200, json.dumps(_openapi_spec()).encode())
        # per-group resource discovery (endpoints/installer.go's
        # APIResourceList; what a RESTMapper consumes)
        gv = None
        if len(parts) == 2 and parts[0] == "api":
            gv = parts[1]
        elif len(parts) == 3 and parts[0] == "apis":
            gv = f"{parts[1]}/{parts[2]}"
        if gv is not None and h.command == "GET":
            resources = [
                {"name": scheme.plural_for_kind(k), "kind": k,
                 "namespaced": scheme.is_namespaced(k)}
                for k in sorted(scheme.all_kinds())
                if scheme.serves(k, gv)]
            if resources:
                return h._send(200, json.dumps(
                    {"kind": "APIResourceList", "groupVersion": gv,
                     "resources": resources}).encode())

        route = self._route(parts)
        if route is None:
            # aggregation (kube-aggregator): an APIService claiming this
            # group/version proxies the request to its backing service
            # (pkg/apiserver/handler_proxy.go). The aggregator sits
            # BEHIND the standard filters: authz, flow control, and
            # audit all apply before the proxy hop.
            backend = (self._aggregated_backend(parts)
                       if len(parts) >= 3 and parts[0] == "apis" else None)
            if backend is not None:
                # attribute extraction mirrors _route: the RBAC resource
                # is the aggregated plural, not the 'namespaces' path
                # segment, and a collection GET authorizes as 'list'
                rest = parts[3:]
                res_ns = None
                if rest and rest[0] == "namespaces" and len(rest) >= 3:
                    res_ns, rest = rest[1], rest[2:]
                plural = rest[0] if rest else None
                name = rest[1] if len(rest) > 1 else None
                verb = _VERBS[h.command]
                if verb == "get" and name is None:
                    verb = "list"
                if plural is None:
                    # group-root (/apis/<group>/<version>) is a
                    # nonResourceURL in the reference, not a resource named
                    # after the group. GET discovery is granted to every
                    # subject (the system:discovery bootstrap binding covers
                    # authenticated AND unauthenticated in 1.11); any other
                    # verb must still be authorized, against the path
                    plural = "/" + "/".join(parts)
                    if (verb not in ("get", "list")
                            and self.authorizer is not None
                            and user is not None
                            and not self.authorizer.authorize(
                                user, verb, plural, namespace=res_ns,
                                name=name)):
                        raise APIError(403, "Forbidden",
                                       f"user {user.name} cannot {verb} "
                                       f"{plural}")
                elif self.authorizer is not None and user is not None:
                    if not self.authorizer.authorize(user, verb, plural,
                                                     namespace=res_ns,
                                                     name=name):
                        raise APIError(403, "Forbidden",
                                       f"user {user.name} cannot {verb} "
                                       f"{plural}")
                sem = (self._readonly_sem if verb in ("get", "list")
                       else self._mutating_sem)
                if sem is not None and not sem.acquire(blocking=False):
                    raise APIError(429, "TooManyRequests",
                                   "server request limit reached, retry later")
                try:
                    self._audit(user, verb, plural, res_ns, name)
                    return self._serve_aggregated(h, backend, parsed)
                finally:
                    if sem is not None:
                        sem.release()
            raise APIError(404, "NotFound", f"path {parsed.path!r} not found")
        plural, namespace, name, sub, gv = route
        verb = _VERBS[h.command]
        if verb == "get" and query.get("watch", ["false"])[0] == "true":
            verb = "watch"
        if verb == "get" and name is None:
            verb = "list"
        if verb == "delete" and name is None:
            # DELETE on a collection URL (installer.go maps it to the
            # "deletecollection" verb — its own RBAC attribute)
            verb = "deletecollection"

        # flow control: watches are long-lived and exempt (the reference
        # exempts them too, maxinflight.go:49)
        sem = None
        if verb != "watch":
            # nonMutatingRequestVerbs is exactly get/list/watch
            # (maxinflight.go): patch and the subresource writes are
            # mutating
            sem = (self._readonly_sem if verb in ("get", "list") else
                   self._mutating_sem)
        if sem is not None and not sem.acquire(blocking=False):
            raise APIError(429, "TooManyRequests",
                           "server request limit reached, retry later")
        try:
            return self._serve_authorized(h, query, user, plural, namespace,
                                          name, sub, verb, gv)
        finally:
            if sem is not None:
                sem.release()

    def _serve_authorized(self, h, query, user, plural, namespace, name,
                          sub, verb, gv=None):

        # authz (filters/authorization.go) — namespace/name make
        # namespaced Roles and resourceNames evaluable; subresources
        # authorize as their own attribute ("pods/exec", "pods/status")
        # so a create-pods grant does NOT imply exec into pods
        attr = f"{plural}/{sub}" if sub else plural
        if self.authorizer is not None and user is not None:
            if not self.authorizer.authorize(user, verb, attr,
                                             namespace=namespace, name=name):
                raise APIError(403, "Forbidden",
                               f"user {user.name} cannot {verb} {attr}")

        with self._count_lock:
            key = f"{verb}:{plural}"
            self.request_count[key] = self.request_count.get(key, 0) + 1

        self._audit(user, verb, plural, namespace, name)

        if verb == "watch":
            return self._serve_watch(h, plural, query, gv)
        if verb == "list":
            return self._serve_list(h, plural, namespace, query, gv)
        if verb == "get":
            if sub == "log" and plural == "pods":
                return self._serve_pod_log(h, namespace, name, query)
            if sub == "attach" and plural == "pods":
                return self._serve_pod_attach(h, namespace, name, query)
            if sub == "scale":
                return self._serve_scale(h, plural, namespace, name, user,
                                         write=False)
            return self._serve_get(h, plural, namespace, name, gv)
        if verb == "create":
            if sub == "binding":
                return self._serve_binding(h, namespace, name)
            if sub == "eviction":
                return self._serve_eviction(h, user, namespace, name)
            if sub == "exec" and plural == "pods":
                return self._serve_pod_exec(h, namespace, name)
            if sub == "portforward" and plural == "pods":
                return self._serve_pod_portforward(h, namespace, name)
            return self._serve_create(h, plural, namespace, user, gv)
        if verb in ("update", "patch"):
            if sub == "scale":
                return self._serve_scale(h, plural, namespace, name, user,
                                         write=True)
            return self._serve_update(h, plural, namespace, name, sub, user,
                                      patch=(verb == "patch"), gv=gv)
        if verb == "delete":
            return self._serve_delete(h, plural, namespace, name, user,
                                      query=query)
        if verb == "deletecollection":
            return self._serve_delete_collection(h, plural, namespace,
                                                 query, user)
        raise APIError(405, "MethodNotAllowed", f"{h.command} unsupported")

    # -- kubelet proxy subresources (pods/<name>/log, /exec) -------------------

    def _kubelet_target(self, namespace, name):
        """Resolve a pod's kubelet serving endpoint through its Node's
        daemon endpoint (registry/core/pod/rest/log.go LogLocation ->
        pod.Spec.NodeName -> NodeDaemonEndpoints)."""
        pod = self._find("pods", namespace, name)
        if pod is None:
            raise APIError(404, "NotFound", f"pod {name!r} not found")
        if not pod.spec.node_name:
            raise APIError(400, "BadRequest",
                           f"pod {name!r} is not scheduled to a node")
        from ..utils.net import node_daemon_endpoint

        ep = node_daemon_endpoint(self.store, pod.spec.node_name)
        if ep is None:
            raise APIError(400, "BadRequest",
                           f"node {pod.spec.node_name!r} does not expose "
                           f"a kubelet endpoint")
        container = (pod.spec.containers[0].name
                     if pod.spec.containers else "")
        return pod, ep[0], ep[1], container

    def _kubelet_proxy(self, h, method, host, port, path, body=None,
                       timeout: float = 10.0):
        import http.client

        if self._kubelet_client_ctx is not None:
            conn = http.client.HTTPSConnection(
                host, port, timeout=timeout,
                context=self._kubelet_client_ctx)
        else:
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            h._send(resp.status, data,
                    resp.getheader("Content-Type", "text/plain"))
            return True
        except OSError as e:
            hint = ""
            if self._kubelet_client_ctx is not None:
                # a TLS cluster requires TLS kubelets (the reference's
                # kubelet always serves HTTPS); a plain-HTTP kubelet
                # registered in a secure cluster fails the handshake here
                hint = (" (secure cluster: the kubelet must serve TLS — "
                        "Kubelet.serve(tls=cluster_ca))")
            raise APIError(503, "ServiceUnavailable",
                           f"kubelet unreachable: {e}{hint}")
        finally:
            conn.close()

    def _serve_pod_log(self, h, namespace, name, query):
        """GET pods/<name>/log — proxied to the kubelet's
        /containerLogs/<ns>/<pod>/<container> (pod/rest/log.go)."""
        pod, host, port, default_c = self._kubelet_target(namespace, name)
        container = query.get("container", [default_c])[0]
        tail = query.get("tailLines", [None])[0]
        if tail is not None:
            try:
                int(tail)
            except ValueError:
                raise APIError(400, "BadRequest",
                               f"tailLines {tail!r} is not an integer")
        # quote: the container name is client-controlled — unescaped
        # '/', '?', '#' would rewrite the proxied kubelet path
        path = (f"/containerLogs/{quote(pod.metadata.namespace, safe='')}/"
                f"{quote(pod.metadata.name, safe='')}/"
                f"{quote(container, safe='')}")
        params = []
        if tail:
            params.append(f"tailLines={tail}")
        if query.get("previous", ["false"])[0] == "true":
            params.append("previous=true")
        if params:
            path += "?" + "&".join(params)
        return self._kubelet_proxy(h, "GET", host, port, path)

    def _serve_pod_exec(self, h, namespace, name):
        """POST pods/<name>/exec — proxied to the kubelet's /exec
        (server.go:325 getExec; one-shot JSON here, not SPDY). Admission
        runs on the subresource attribute (DenyEscalatingExec gates
        privileged pods, plugin/pkg/admission/exec)."""
        pod, host, port, default_c = self._kubelet_target(namespace, name)
        try:
            self.admission.admit("create", "pods/exec", pod, None, None,
                                 self.store)
        except AdmissionError as e:
            raise APIError(getattr(e, "code", 403), "Forbidden", str(e))
        data = self._read_body(h)
        container = data.get("container") or default_c
        path = (f"/exec/{quote(pod.metadata.namespace, safe='')}/"
                f"{quote(pod.metadata.name, safe='')}/"
                f"{quote(str(container), safe='')}")
        return self._kubelet_proxy(h, "POST", host, port, path,
                                   body=json.dumps(
                                       {"command": data.get("command"),
                                        "stdin": data.get("stdin")}))

    def _serve_pod_attach(self, h, namespace, name, query):
        """GET pods/<name>/attach — proxied to the kubelet's /attach
        long-poll (server.go:640 getAttach; SPDY collapsed to follow-mode
        polling, see kubelet/server.py)."""
        pod, host, port, default_c = self._kubelet_target(namespace, name)
        try:
            self.admission.admit("create", "pods/attach", pod, None, None,
                                 self.store)
        except AdmissionError as e:
            raise APIError(getattr(e, "code", 403), "Forbidden", str(e))
        container = query.get("container", [default_c])[0]
        q = []
        wait = 2.0
        for key in ("since", "waitSeconds"):
            v = query.get(key, [None])[0]
            if v is not None:
                if key == "waitSeconds":
                    try:
                        wait = min(float(v), 30.0)
                    except ValueError:
                        raise APIError(400, "BadRequest",
                                       f"waitSeconds {v!r} is not a number")
                q.append(f"{key}={quote(v, safe='')}")
        path = (f"/attach/{quote(pod.metadata.namespace, safe='')}/"
                f"{quote(pod.metadata.name, safe='')}/"
                f"{quote(container, safe='')}")
        if q:
            path += "?" + "&".join(q)
        # the proxy must outlive the kubelet's long-poll window or an
        # idle container turns into a bogus 503 at waitSeconds > 10
        return self._kubelet_proxy(h, "GET", host, port, path,
                                   timeout=wait + 10.0)

    def _serve_pod_portforward(self, h, namespace, name):
        """POST pods/<name>/portforward — proxied to the kubelet, which
        opens a TCP relay to the pod's listener and returns its address
        (server.go:751 getPortForward; the SPDY data channel is a real
        TCP relay here, so bytes genuinely flow end to end)."""
        pod, host, port, _c = self._kubelet_target(namespace, name)
        data = self._read_body(h)
        path = (f"/portForward/{quote(pod.metadata.namespace, safe='')}/"
                f"{quote(pod.metadata.name, safe='')}")
        return self._kubelet_proxy(h, "POST", host, port, path,
                                   body=json.dumps(
                                       {"port": data.get("port")}))

    # -- aggregation (kube-aggregator) -----------------------------------------

    def _aggregated_backend(self, parts):
        """APIServiceSpec claiming /apis/<group>/<version>, or None."""
        group, version = parts[1], parts[2]
        for apisvc in self.store.list("apiservices"):
            if (apisvc.spec.group == group
                    and apisvc.spec.version == version
                    and apisvc.spec.service_name):
                return apisvc.spec
        return None

    def _serve_aggregated(self, h, svc_ref, parsed):
        """Proxy /apis/<group>/<version>/... to the APIService's backing
        service endpoints (handler_proxy.go:109 ServeHTTP: resolve the
        service, forward verbatim, relay the response). svc_ref is the
        APIServiceSpec resolved by the caller — re-resolving here could
        race a concurrent APIService deletion into a 500."""
        group, version = svc_ref.group, svc_ref.version
        ep = self.store.get("endpoints", svc_ref.service_namespace,
                            svc_ref.service_name)
        # pick the subset port matching the APIService's service_port
        # (handler_proxy.go resolves the named/numbered service port, not
        # blindly the first one); fall back to the declared port itself
        backends = [(a.ip, next((p.port for p in s.ports
                                 if p.port == svc_ref.service_port),
                                next((p.port for p in s.ports),
                                     svc_ref.service_port)))
                    for s in (ep.subsets if ep else [])
                    for a in s.addresses]
        if not backends:
            raise APIError(503, "ServiceUnavailable",
                           f"no endpoints for aggregated API "
                           f"{version}.{group}")
        host, port = backends[0]
        import http.client

        body = b""
        length = int(h.headers.get("Content-Length") or 0)
        if length:
            body = h.rfile.read(length)
        conn = http.client.HTTPConnection(host, port, timeout=10)
        try:
            url = parsed.path + (f"?{parsed.query}" if parsed.query else "")
            conn.request(h.command, url, body=body or None,
                         headers={"Content-Type":
                                  h.headers.get("Content-Type",
                                                "application/json")})
            resp = conn.getresponse()
            data = resp.read()
            h._send(resp.status, data,
                    resp.getheader("Content-Type", "application/json"))
            return True
        except OSError as e:
            raise APIError(503, "ServiceUnavailable",
                           f"aggregated API backend unreachable: {e}")
        finally:
            conn.close()

    # -- routing ---------------------------------------------------------------

    def _route(self, parts: List[str]):
        """path segments -> (plural, namespace, name, subresource,
        requested groupVersion). A plural addressed under a groupVersion
        its kind is not served at does not route (404 — the reference's
        installer only registers served versions)."""
        if len(parts) >= 2 and parts[0] == "api" and parts[1] == "v1":
            rest, gv = parts[2:], "v1"
        elif len(parts) >= 3 and parts[0] == "apis":
            rest, gv = parts[3:], f"{parts[1]}/{parts[2]}"
        else:
            return None
        if not rest:
            return None
        if rest[0] == "namespaces" and len(rest) >= 3:
            ns, rest2 = rest[1], rest[2:]
        else:
            ns, rest2 = None, rest
        plural = rest2[0]
        kind = scheme.kind_for_plural(plural)
        if kind is None or not scheme.serves(kind, gv):
            return None
        name = rest2[1] if len(rest2) > 1 else None
        sub = rest2[2] if len(rest2) > 2 else None
        return plural, ns, name, sub, gv

    def _find(self, plural: str, namespace: Optional[str], name: str):
        kind = scheme.kind_for_plural(plural)
        for ns in ([namespace] if namespace is not None
                   else ["default", ""]):
            obj = self.store.get(plural, ns, name)
            if obj is not None:
                return obj
        if namespace is not None and not scheme.is_namespaced(kind):
            for ns in ("default", ""):
                obj = self.store.get(plural, ns, name)
                if obj is not None:
                    return obj
        return None

    def _bootstrap_priority_classes(self):
        """The built-in system PriorityClasses every cluster serves
        (registry/scheduling/rest/storage_scheduling.go
        PostStartHook: system-node-critical 2000001000,
        system-cluster-critical 2000000000) — control-plane pods name
        them and the kubelet's critical-pod preemption keys off their
        values."""
        for name, value in (("system-node-critical", 2_000_001_000),
                            ("system-cluster-critical", 2_000_000_000)):
            try:
                self.store.create("priorityclasses", api.PriorityClass(
                    metadata=api.ObjectMeta(name=name, namespace=""),
                    value=value,
                    description="Built-in system priority class"))
            except Conflict:
                pass  # already bootstrapped (durable store restart)

    # -- custom resource validation/subresources -------------------------------

    def _crd_for_kind(self, kind: str):
        from ..api import scale as scaleapi

        return scaleapi.crd_for_kind(self.store, kind)

    @staticmethod
    def _check_crd_schema(crd):
        """Structural 422 for a CRD's openAPIV3Schema and subresource
        declarations — one gate for create AND update (a replace must
        not smuggle in the broken pattern create would have refused)."""
        sub = crd.spec.subresources
        if sub is not None and sub.scale is not None:
            # apiextensions validation.go ValidateCustomResourceDefinition
            # Subresources: the dotted replica paths must live under
            # .spec/.status — anything else would make every /scale write
            # a silent no-op (dotted_set grafts into a dead branch) while
            # the HPA retry-loops against it
            sc = sub.scale

            def _under(path, root):
                # dot-boundary check: '.specSelector.n' must NOT pass as
                # being under '.spec'
                return path == root or (path or "").startswith(root + ".")

            if not _under(sc.spec_replicas_path, ".spec"):
                raise APIError(
                    422, "Invalid",
                    f"spec.subresources.scale.specReplicasPath: "
                    f"{sc.spec_replicas_path!r} must begin with .spec")
            if not _under(sc.status_replicas_path, ".status"):
                raise APIError(
                    422, "Invalid",
                    f"spec.subresources.scale.statusReplicasPath: "
                    f"{sc.status_replicas_path!r} must begin with .status")
        if crd.spec.validation is None:
            return
        from ..api.crdschema import schema_errors

        serrs = schema_errors(crd.spec.validation.open_api_v3_schema)
        if serrs:
            raise APIError(422, "Invalid",
                           "; ".join(f"{p}: {m}" for p, m in serrs))

    def _validate_custom(self, obj, crd):
        """CustomResourceValidation enforcement: the whole wire object
        is checked against the CRD's openAPIV3Schema; failures are
        field-addressed 422s like built-in kinds
        (apiextensions-apiserver pkg/apiserver/validation)."""
        if crd is None or crd.spec.validation is None:
            return
        from ..api.crdschema import validate_schema

        wire = scheme.encode_object(obj)
        errors = validate_schema(
            wire, crd.spec.validation.open_api_v3_schema)
        if errors:
            msg = "; ".join(f"{p}: {m}" for p, m in errors)
            raise APIError(422, "Invalid",
                           f"{obj.kind} {obj.metadata.name!r} is invalid: "
                           f"{msg}")

    # -- scale subresource -----------------------------------------------------

    def _scale_mapping(self, plural, obj):
        """-> (spec_path, status_path, selector_str) or None when the
        kind has no scale subresource (shared mapping: api/scale.py)."""
        from ..api import scale as scaleapi

        return scaleapi.mapping_for(self.store, plural, obj)

    def _scale_wire(self, obj, plural, mapping):
        from ..api import scale as scaleapi

        spec_path, status_path, sel = mapping
        wire = scheme.encode_object(obj)
        status = {"replicas": scaleapi.dotted_get(wire, status_path, 0) or 0}
        if sel:
            status["selector"] = sel
        return {
            "kind": "Scale", "apiVersion": "autoscaling/v1",
            "metadata": {"name": obj.metadata.name,
                         "namespace": obj.metadata.namespace,
                         "resourceVersion":
                             obj.metadata.resource_version},
            "spec": {"replicas":
                     scaleapi.dotted_get(wire, spec_path, 0) or 0},
            "status": status,
        }

    def _serve_scale(self, h, plural, namespace, name, user, write):
        """GET/PUT <plural>/<name>/scale: the polymorphic Scale
        subresource every scalable kind serves
        (registry ScaleREST Get/Update)."""
        obj = self._find(plural, namespace, name)
        if obj is None:
            raise APIError(404, "NotFound", f"{plural} {name!r} not found")
        mapping = self._scale_mapping(plural, obj)
        if mapping is None:
            raise APIError(
                404, "NotFound",
                f"the server could not find the requested resource "
                f"({plural}/{name}/scale)")
        if write:
            import copy

            body = self._read_body(h)
            want = body.get("spec", {}).get("replicas")
            if not isinstance(want, int) or want < 0:
                raise APIError(422, "Invalid",
                               "spec.replicas must be a non-negative "
                               "integer")
            rv = body.get("metadata", {}).get("resourceVersion")
            if rv and str(rv) != str(obj.metadata.resource_version):
                raise APIError(409, "Conflict",
                               f"resourceVersion {rv} != "
                               f"{obj.metadata.resource_version}")
            # mutate a CLONE: the stored object must not change until
            # admission + validation admit the write (a rejected scale
            # must leave the store untouched, like every other verb)
            from ..api import scale as scaleapi

            new = copy.deepcopy(obj)
            scaleapi.set_spec_replicas(new, mapping[0], want)
            try:
                self.admission.admit("update", plural, new, obj, user,
                                     self.store)
            except AdmissionError as e:
                raise APIError(getattr(e, "code", 403), "Forbidden", str(e))
            # the scale path enforces the SAME rules as a direct update:
            # schema caps on CRs, field validation on built-ins
            if isinstance(new, api.CustomObject):
                self._validate_custom(new, self._crd_for_kind(new.kind))
            else:
                errs = validation.validate(plural, new, old=obj)
                if errs:
                    raise APIError(422, "Invalid", errs.message())
            try:
                self.store.update(plural, new)
            except Conflict as e:
                raise APIError(409, "Conflict", str(e))
            except KeyError:
                raise APIError(404, "NotFound",
                               f"{plural} {name!r} not found")
            obj = new
        return h._send(200, json.dumps(
            self._scale_wire(obj, plural, mapping)).encode())

    # -- verbs -----------------------------------------------------------------

    @staticmethod
    def _filter_by_selectors(objs, query):
        """?labelSelector / ?fieldSelector filtering, shared by list and
        deletecollection (the reference routes both through the same
        storage predicate)."""
        sel = query.get("labelSelector", [None])[0]
        if sel:
            from ..api.labels import Selector

            # full set-based syntax (labels.Parse: =, !=, in, notin,
            # exists, !key); malformed selectors are client errors
            try:
                parsed = Selector.parse(sel)
            except ValueError:
                raise APIError(400, "BadRequest",
                               f"unparseable labelSelector {sel!r}")
            objs = [o for o in objs
                    if parsed.matches(o.metadata.labels or {})]
        fsel = query.get("fieldSelector", [None])[0]
        if fsel:
            for kv in fsel.split(","):
                k, _, v = kv.partition("=")
                if k == "spec.nodeName":
                    # non-pod kinds have no spec.nodeName: match nothing
                    # rather than 500 on the attribute access
                    objs = [o for o in objs
                            if getattr(getattr(o, "spec", None),
                                       "node_name", None) == v]
                elif k == "metadata.name":
                    objs = [o for o in objs if o.metadata.name == v]
                elif k == "metadata.namespace":
                    objs = [o for o in objs
                            if o.metadata.namespace == v]
                elif k == "status.phase":
                    objs = [o for o in objs
                            if getattr(getattr(o, "status", None),
                                       "phase", None) == v]
                else:
                    raise APIError(400, "BadRequest",
                                   f"unsupported fieldSelector {k!r}")
        return objs

    def _serve_list(self, h, plural, namespace, query, gv=None):
        # items and resourceVersion must come from ONE store view: read
        # separately, a write landing between them yields a list whose
        # rv claims to cover objects it does not contain — a reflector
        # then watches from that rv and the missed writes are invisible
        # until a forced relist (the exact silent-wedge the watch-stream
        # staleness watchdog exists to break, but the server must not
        # manufacture it)
        with self.store._lock:
            listed = self.store.list(plural, namespace)
            list_rv = self.store.latest_resource_version
        objs = self._filter_by_selectors(listed, query)
        kind = scheme.kind_for_plural(plural)
        # APIListChunking (1.11 beta; apiserver/pkg/storage continue
        # tokens): ?limit=N pages a deterministic (namespace, name)
        # ordering, ?continue resumes strictly after the token's last
        # key — the same key-range resumption etcd pagination gives the
        # reference (objects created mid-walk before the cursor are
        # skipped, after it are included; no duplicates either way).
        cont_out = None
        limit = query.get("limit", [None])[0]
        cont_in = query.get("continue", [None])[0]
        if limit is not None or cont_in:
            import base64

            objs = sorted(objs, key=lambda o: (o.metadata.namespace or "",
                                               o.metadata.name))
            if cont_in:
                try:
                    last_ns, _, last_name = base64.urlsafe_b64decode(
                        cont_in.encode()).decode().partition("/")
                except Exception:
                    raise APIError(400, "BadRequest",
                                   "malformed continue token")
                objs = [o for o in objs
                        if ((o.metadata.namespace or ""), o.metadata.name)
                        > (last_ns, last_name)]
            if limit is not None:
                try:
                    n = int(limit)
                except ValueError:
                    raise APIError(400, "BadRequest",
                                   f"invalid limit {limit!r}")
                if 0 < n < len(objs):
                    last = objs[n - 1]
                    cont_out = base64.urlsafe_b64encode(
                        f"{last.metadata.namespace or ''}/"
                        f"{last.metadata.name}".encode()).decode()
                    objs = objs[:n]
        if self._wants_binary(h) and self._binary_ok(kind, gv) \
                and cont_out is None:
            from ..api import binary

            h._send(200, binary.dumps_list(kind, objs, list_rv),
                    content_type=binary.CONTENT_TYPE)
            return
        meta = {"resourceVersion": str(list_rv)}
        if cont_out:
            meta["continue"] = cont_out
        body = json.dumps({
            "kind": kind + "List",
            "apiVersion": gv or scheme.api_version_for(kind),
            "metadata": meta,
            "items": [scheme.encode_object(o, version=gv)
                      for o in objs]}).encode()
        h._send(200, body)

    @staticmethod
    def _wants_binary(h) -> bool:
        """Content negotiation (the reference negotiates
        application/vnd.kubernetes.protobuf the same way)."""
        from ..api import binary

        return binary.CONTENT_TYPE in (h.headers.get("Accept") or "")

    @staticmethod
    def _binary_ok(kind, gv) -> bool:
        """The binary codec writes hub-form objects only; a request at a
        converted version must get JSON (silently serving hub-tagged
        bytes would flip the served version on the Accept header)."""
        return gv is None or gv == scheme.api_version_for(kind)

    def _serve_get(self, h, plural, namespace, name, gv=None):
        obj = self._find(plural, namespace, name)
        if obj is None:
            raise APIError(404, "NotFound", f"{plural} {name!r} not found")
        if self._wants_binary(h) and \
                self._binary_ok(scheme.kind_for_plural(plural), gv):
            from ..api import binary

            h._send(200, binary.dumps(obj), content_type=binary.CONTENT_TYPE)
            return
        h._send(200, json.dumps(scheme.encode_object(obj, version=gv)).encode())

    def _read_body(self, h) -> dict:
        length = int(h.headers.get("Content-Length", 0))
        raw = h.rfile.read(length) if length else b"{}"
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise APIError(400, "BadRequest", f"invalid JSON: {e}")

    def _serve_create(self, h, plural, namespace, user, gv=None):
        kind = scheme.kind_for_plural(plural)
        data = self._read_body(h)
        data.setdefault("kind", kind)
        if gv is not None:
            # the path's groupVersion governs decoding; an untagged body
            # posted to a versioned path is that version (create.go
            # decodes with the request-scope kind)
            data.setdefault("apiVersion", gv)
        try:
            obj = scheme.decode_request(kind, data)
        except Exception as e:
            raise APIError(400, "BadRequest", f"cannot decode {kind}: {e}")
        if namespace is not None and scheme.is_namespaced(kind):
            obj.metadata.namespace = namespace
        if plural == "selfsubjectaccessreviews":
            # virtual resource: evaluated against the live authorizer,
            # never stored (registry/authorization/selfsubjectaccessreview/
            # rest.go:48). With no authorizer configured every request is
            # allowed, matching this server's open-by-default posture.
            ra = obj.spec.resource_attributes
            if self.authorizer is None or user is None:
                obj.status.allowed = True
                obj.status.reason = "no authorizer configured"
            else:
                obj.status.allowed = self.authorizer.authorize(
                    user, ra.verb, ra.resource, namespace=ra.namespace,
                    name=ra.name)
            return h._send(201, json.dumps(
                scheme.encode_object(obj, version=gv)).encode())
        if plural == "certificatesigningrequests" and user is not None:
            # the requestor identity is SERVER-stamped from the request
            # context, never client-claimed — INCLUDING anonymous: an
            # anonymous CSR carrying forged system:bootstrappers groups
            # must not reach the auto-approver (pkg/registry/certificates/
            # certificates/strategy.go PrepareForCreate)
            obj.spec.username = user.name
            obj.spec.groups = list(user.groups)
        try:
            self.admission.admit("create", plural, obj, None, user, self.store)
        except AdmissionError as e:
            code = getattr(e, "code", 403)
            raise APIError(code,
                           "TooManyRequests" if code == 429 else "Forbidden",
                           str(e))
        # validation runs AFTER admission mutators, like the registry
        # strategies' Validate (registry/core/pod/strategy.go:79); a bad
        # object reports every field error at once as a 422
        errs = validation.validate(plural, obj)
        if errs:
            raise APIError(422, "Invalid", errs.message())
        if isinstance(obj, api.CustomObject):
            crd = self._crd_for_kind(obj.kind)
            if crd is not None and crd.spec.subresources is not None and \
                    crd.spec.subresources.status:
                # status subresource enabled: the main resource never
                # accepts client status (apiextensions strategy
                # PrepareForCreate drops it) — BEFORE validation, so a
                # discarded status can't fail the create
                obj.status = {}
            self._validate_custom(obj, crd)
        if plural == "services":
            self._allocate_service(obj)
        if plural == "customresourcedefinitions":
            msg = scheme.crd_conflict(obj)
            if msg is not None:
                raise APIError(409, "AlreadyExists", msg)
            self._check_crd_schema(obj)
        try:
            self.store.create(plural, obj)
        except Conflict as e:
            raise APIError(409, "AlreadyExists", str(e))
        if plural == "customresourcedefinitions":
            # register synchronously too: with async event dispatch
            # (NativeObjectStore) the informer may run after this 201 is
            # sent, 404ing an immediately-following instance create;
            # register_dynamic is idempotent so the informer's later
            # delivery is harmless
            scheme.register_dynamic(obj)
        h._send(201, json.dumps(scheme.encode_object(obj, version=gv)).encode())

    # service-cluster-ip-range / --service-node-port-range defaults
    # (cmd/kube-apiserver/app/options: 10.0.0.0/24, 30000-32767)
    SERVICE_IP_PREFIX = "10.0.0."
    NODE_PORT_RANGE = (30000, 32767)

    def _allocate_service(self, svc):
        """Service REST allocation (registry/core/service/rest.go +
        ipallocator/portallocator): assign a free clusterIP unless
        headless ("None") or ExternalName; assign free NodePorts for
        NodePort/LoadBalancer ports. User-supplied values that collide
        with an existing allocation are 422s, like the reference's
        ErrAllocated path."""
        # exclusion is by IDENTITY (namespace, name) — never by uid: a
        # created manifest may carry a copied uid from `get -o yaml` of
        # another service, which must still collide
        me = (svc.metadata.namespace, svc.metadata.name)
        existing = [s for s in self.store.list("services")
                    if (s.metadata.namespace, s.metadata.name) != me]
        used_ips = {s.spec.cluster_ip for s in existing
                    if s.spec.cluster_ip not in ("", "None")}
        used_ports = {p.node_port for s in existing
                      for p in s.spec.ports if p.node_port}
        if svc.spec.type not in ("NodePort", "LoadBalancer"):
            # releasing a type change: stale nodePorts would otherwise
            # stay allocated forever (the reference clears them when the
            # type stops needing them)
            for p in svc.spec.ports:
                p.node_port = 0
        if svc.spec.type != "ExternalName" \
                and svc.spec.cluster_ip not in ("None",):
            if svc.spec.cluster_ip:
                if svc.spec.cluster_ip in used_ips:
                    raise APIError(
                        422, "Invalid",
                        f"spec.clusterIP: {svc.spec.cluster_ip} "
                        f"is already allocated")
            else:
                for i in range(1, 255):
                    ip = f"{self.SERVICE_IP_PREFIX}{i}"
                    if ip not in used_ips:
                        svc.spec.cluster_ip = ip
                        break
                else:
                    raise APIError(500, "InternalError",
                                   "service IP range exhausted")
        if svc.spec.type in ("NodePort", "LoadBalancer"):
            lo, hi = self.NODE_PORT_RANGE
            for p in svc.spec.ports:
                if p.node_port:
                    if p.node_port in used_ports:
                        raise APIError(
                            422, "Invalid",
                            f"spec.ports: nodePort {p.node_port} "
                            f"is already allocated")
                    used_ports.add(p.node_port)
            for p in svc.spec.ports:
                if not p.node_port:
                    for cand in range(lo, hi + 1):
                        if cand not in used_ports:
                            p.node_port = cand
                            used_ports.add(cand)
                            break
                    else:
                        raise APIError(500, "InternalError",
                                       "node port range exhausted")

    def _serve_update(self, h, plural, namespace, name, sub, user, patch,
                      gv=None):
        kind = scheme.kind_for_plural(plural)
        old = self._find(plural, namespace, name)
        if old is None:
            raise APIError(404, "NotFound", f"{plural} {name!r} not found")
        data = self._read_body(h)
        if gv is not None and not patch and sub in ("status", "finalize"):
            # subresource graft happens in HUB form below; a body sent at
            # a non-hub version must convert first or version-specific
            # fields would silently vanish into unknown hub keys
            kind_hub = scheme.api_version_for(kind)
            if gv != kind_hub:
                from ..api import conversion as _conv

                if not ({"status", "spec", "kind"} & set(data)):
                    data = {"status": data}  # bare-status body
                data.setdefault("apiVersion", gv)
                data = _conv.to_hub(kind, data, gv, kind_hub)
        if patch:
            # the patch applies against the object AS SERVED at the
            # request's version (patch.go works on versioned bytes), and
            # the merged result converts back through the hub
            merged = scheme.encode_object(old, version=gv)
            _merge_patch(merged, data)
            data = merged
        elif sub == "status":
            # status subresource: replace status, keep spec (registry
            # UpdateStatus strategy)
            full = scheme.encode_object(old)
            full["status"] = data.get("status", data)
            data = full
        elif sub == "finalize":
            full = scheme.encode_object(old)
            if "spec" in data:
                full["spec"] = data["spec"]
            data = full
        if gv is not None:
            data.setdefault("apiVersion", gv)
        try:
            obj = scheme.decode_request(kind, data)
        except Exception as e:
            raise APIError(400, "BadRequest", f"cannot decode {kind}: {e}")
        # optimistic concurrency: a nonzero stale resourceVersion is a 409
        # (GuaranteedUpdate / etcd3 ModRevision CAS, storage/etcd3/store.go:262)
        if obj.metadata.resource_version and \
                obj.metadata.resource_version != old.metadata.resource_version:
            raise APIError(409, "Conflict",
                           f"resourceVersion {obj.metadata.resource_version} "
                           f"!= {old.metadata.resource_version}")
        obj.metadata.namespace = old.metadata.namespace
        obj.metadata.name = old.metadata.name
        obj.metadata.uid = old.metadata.uid
        if plural == "certificatesigningrequests":
            # the requestor identity is SERVER-owned on update too
            # (strategy PrepareForUpdate copies it) — rewriting
            # spec.username would otherwise re-aim the self-node
            # approval check at someone else's identity
            obj.spec.username = old.spec.username
            obj.spec.groups = list(old.spec.groups)
        try:
            self.admission.admit("update", plural, obj, old, user, self.store)
        except AdmissionError as e:
            code = getattr(e, "code", 403)
            raise APIError(code,
                           "TooManyRequests" if code == 429 else "Forbidden",
                           str(e))
        if isinstance(obj, api.CustomObject):
            crd = self._crd_for_kind(obj.kind)
            subres = crd.spec.subresources if crd is not None else None
            if sub == "status" and (subres is None or not subres.status):
                # /status is only served once the CRD opts in
                # (apiextensions customresource_handler.go serveStatus)
                raise APIError(404, "NotFound",
                               f"{plural}/status not enabled")
            if subres is not None and subres.status:
                if sub == "status":
                    # status writes never touch spec
                    obj.spec = old.spec
                else:
                    # spec writes never touch status (strategy
                    # PrepareForUpdate with status subresource on)
                    obj.status = old.status
            # the WHOLE object validates on every write path — status
            # updates included (the reference's status strategy runs the
            # same schema, so a typed status stays typed)
            self._validate_custom(obj, crd)
        if sub not in ("status", "finalize"):
            errs = validation.validate(plural, obj, old=old)
            if errs:
                raise APIError(422, "Invalid", errs.message())
        if plural == "services" and not sub:
            # updates can add NodePort ports / switch type — allocate
            # the same way creates do (clusterIP immutability is already
            # enforced by validation above)
            self._allocate_service(obj)
        if plural == "customresourcedefinitions":
            # validate BEFORE touching the registry or the store: a
            # rejected rename must leave the old kind fully served
            self._check_crd_schema(obj)
            msg = scheme.crd_conflict(obj, replacing=old.spec.names.kind)
            if msg is not None:
                raise APIError(409, "Conflict", msg)
        # deletionTimestamp is SERVER-owned in both directions: a PUT
        # can neither clear a pending deletion nor SET one (a client-
        # supplied mark would delete through the update verb, bypassing
        # delete admission, or falsely Terminate a live object)
        obj.metadata.deletion_timestamp = old.metadata.deletion_timestamp
        try:
            self.store.update(plural, obj)
        except Conflict as e:
            raise APIError(409, "Conflict", str(e))
        completed = False
        if obj.metadata.deletion_timestamp is not None and \
                not obj.metadata.finalizers:
            # the last finalizer was just removed from an object marked
            # for deletion: complete it (store.go
            # deleteWithoutFinalizers)
            completed = True
            try:
                self.store.delete(plural, obj.metadata.namespace,
                                  obj.metadata.name)
            except KeyError:
                pass
        if plural == "customresourcedefinitions":
            if completed:
                # the CRD just ceased to exist: the kind must stop being
                # served, not get re-registered
                scheme.unregister(obj.spec.names.kind)
            else:
                # with the in-process store the CRD informer already
                # applied this synchronously inside store.update; this
                # inline pass is for stores with async watch dispatch
                # (NativeObjectStore). Both paths are idempotent.
                if obj.spec.names.kind != old.spec.names.kind:
                    scheme.unregister(old.spec.names.kind)
                scheme.register_dynamic(obj, replacing=old.spec.names.kind)
        h._send(200, json.dumps(scheme.encode_object(obj, version=gv)).encode())

    def _serve_delete(self, h, plural, namespace, name, user, query=None):
        obj = self._find(plural, namespace, name)
        if obj is None:
            raise APIError(404, "NotFound", f"{plural} {name!r} not found")
        try:
            self.admission.admit("delete", plural, None, obj, user, self.store)
        except AdmissionError as e:
            code = getattr(e, "code", 403)
            raise APIError(code,
                           "TooManyRequests" if code == 429 else "Forbidden",
                           str(e))
        # graceful pod deletion (registry/core/pod/strategy.go
        # CheckGracefulDelete + store.go updateForGracefulDeletion):
        # an EXPLICIT ?gracePeriodSeconds on a running, node-bound pod
        # only MARKS the object; the pod's kubelet runs preStop/stops
        # containers and then force-deletes. -1 asks for the spec's
        # terminationGracePeriodSeconds; 0 is an immediate force delete.
        # (Divergence, documented: with no query at all the delete is
        # immediate — the in-process controllers and tests drive the
        # store directly and never wait on a kubelet.)
        raw = (query or {}).get("gracePeriodSeconds", [None])[0]
        if raw is not None and plural == "pods":
            try:
                grace = int(raw)
            except ValueError:
                raise APIError(400, "BadRequest",
                               f"invalid gracePeriodSeconds {raw!r}")
            if grace == -1:
                grace = obj.spec.termination_grace_period_seconds
            elif grace < 0:
                # only -1 is a sentinel; any other negative is a typo
                # that must NOT silently force-delete
                raise APIError(422, "Invalid",
                               f"gracePeriodSeconds must be >= 0 "
                               f"(or -1 for the spec default), "
                               f"got {grace}")
            is_mirror = "kubernetes.io/config.mirror" in (
                obj.metadata.annotations or {})
            if grace > 0 and obj.spec.node_name and not is_mirror and \
                    obj.status.phase in ("", "Pending", "Running"):
                if obj.metadata.deletion_timestamp is None:
                    obj.metadata.deletion_timestamp = time.time()
                obj.metadata.deletion_grace_period_seconds = grace
                self.store.update(plural, obj)
                h._send(200, _status_body(
                    200, "Success",
                    f"{name} marked for graceful deletion "
                    f"(grace {grace}s)", status="Success"))
                return
        self._delete_or_mark(plural, obj)
        h._send(200, _status_body(200, "Success", f"{name} deleted",
                                  status="Success"))

    def _serve_delete_collection(self, h, plural, namespace, query, user):
        """DELETE on a collection URL (registry Store.DeleteCollection):
        every object the label/field selectors match is deleted through
        the same admission + finalizer gate as a single delete."""
        objs = self._filter_by_selectors(self.store.list(plural, namespace),
                                         query)
        deleted = 0
        for obj in objs:
            try:
                self.admission.admit("delete", plural, None, obj, user,
                                     self.store)
            except AdmissionError:
                continue  # per-object admission veto skips, not aborts
            self._delete_or_mark(plural, obj)
            deleted += 1
        h._send(200, _status_body(
            200, "Success", f"{deleted} {plural} deleted",
            status="Success"))

    def _delete_or_mark(self, plural, obj) -> bool:
        """Finalizer-gated deletion (registry/generic/registry/store.go
        Delete -> updateForGracefulDeletionAndFinalizers): with
        finalizers present, only mark deletion_timestamp — the object
        disappears when the last finalizer clears (see _serve_update).
        EVERY server-side delete (DELETE verb, eviction) goes through
        here. Returns True when the object was actually removed."""
        if getattr(obj.metadata, "finalizers", None):
            if obj.metadata.deletion_timestamp is None:
                obj.metadata.deletion_timestamp = time.time()
                self.store.update(plural, obj)
            return False
        self.store.delete(plural, obj.metadata.namespace,
                          obj.metadata.name)
        if plural == "customresourcedefinitions":
            scheme.unregister(obj.spec.names.kind)
        return True

    def _serve_binding(self, h, namespace, name):
        """POST pods/<name>/binding (BindingREST.Create,
        registry/core/pod/storage/storage.go)."""
        data = self._read_body(h)
        target = (data.get("target") or {}).get("name", "")
        if not target:
            raise APIError(400, "BadRequest", "binding.target.name required")
        pod = self._find("pods", namespace, name)
        if pod is None:
            raise APIError(404, "NotFound", f"pod {name!r} not found")
        try:
            self.store.bind(pod, target)
        except Conflict as e:
            raise APIError(409, "Conflict", str(e))
        h._send(201, _status_body(201, "Success", "bound", status="Success"))

    def _serve_eviction(self, h, user, namespace, name):
        """POST pods/<name>/eviction — PDB-respecting delete
        (registry/core/pod EvictionREST)."""
        pod = self._find("pods", namespace, name)
        if pod is None:
            raise APIError(404, "NotFound", f"pod {name!r} not found")
        for pdb in self.store.list("poddisruptionbudgets", pod.metadata.namespace):
            sel = pdb.selector
            if sel is not None and sel.matches(pod.metadata.labels or {}) \
                    and pdb.disruptions_allowed <= 0:
                raise APIError(429, "TooManyRequests",
                               f"pdb {pdb.metadata.name} disallows eviction")
        # finalizer-gated like every server-side delete (the reference's
        # eviction goes through the registry Delete and respects them)
        self._delete_or_mark("pods", pod)
        h._send(201, _status_body(201, "Success", "evicted", status="Success"))

    # -- watch -----------------------------------------------------------------

    def _serve_watch(self, h, plural, query, gv=None):
        rv = query.get("resourceVersion", [None])[0]
        since = int(rv) if rv not in (None, "", "0") else None
        timeout = float(query.get("timeoutSeconds", ["30"])[0])
        sel = query.get("labelSelector", [None])[0]
        parsed_sel = None
        if sel:
            from ..api.labels import Selector

            try:
                parsed_sel = Selector.parse(sel)
            except ValueError:
                raise APIError(400, "BadRequest",
                               f"unparseable labelSelector {sel!r}")

        def _matches(o) -> bool:
            return parsed_sel is None or \
                parsed_sel.matches(o.metadata.labels or {})
        # resourceVersion=0: deliver current state as synthetic ADDED events
        # then go live (cacher's GetAllEventsSince for zero version,
        # storage/watch_cache.go) — must snapshot state and open the live
        # watcher under one view to not drop or duplicate events
        initial: List[object] = []
        try:
            if rv == "0":
                with self.store._lock:
                    initial = self.store.list(plural)
                    watcher = self.broadcaster.watch(
                        kind=plural,
                        since_rv=self.store.latest_resource_version)
            else:
                watcher = self.broadcaster.watch(kind=plural, since_rv=since)
        except TooOld as e:
            raise APIError(410, "Expired", str(e))
        try:
            h.send_response(200)
            h.send_header("Content-Type", "application/json")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()
            for obj in initial:
                if not _matches(obj):
                    continue
                line = (json.dumps(
                    {"type": "ADDED",
                     "object": scheme.encode_object(obj, version=gv)})
                    + "\n").encode()
                h.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
            if initial:
                h.wfile.flush()
            deadline = time.monotonic() + timeout
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                ev = watcher.next(timeout=min(left, 1.0))
                if ev is None:
                    if watcher.stopped:
                        break
                    continue
                etype = ev.type
                if parsed_sel is not None:
                    # cacher watch filtering incl. TRANSITIONS
                    # (storage/cacher.go watchFilterFunc over prevObject):
                    # entering the selector surfaces as ADDED, leaving
                    # as DELETED, outside-only events are dropped
                    cur_m = _matches(ev.obj)
                    old_m = ev.old is not None and _matches(ev.old)
                    if etype == "MODIFIED":
                        if cur_m and not old_m:
                            etype = "ADDED"
                        elif old_m and not cur_m:
                            etype = "DELETED"
                        elif not cur_m:
                            continue
                    elif not cur_m:
                        continue
                line = (json.dumps(
                    {"type": etype,
                     "object": scheme.encode_object(ev.obj, version=gv)})
                    + "\n").encode()
                h.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
                h.wfile.flush()
            h.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, socket.error):
            pass
        finally:
            watcher.stop()
            h.close_connection = True

    # -- cross-cutting ---------------------------------------------------------

    def _audit(self, user: Optional[UserInfo], verb, plural, namespace, name):
        if self.audit_sink is None or self.audit_policy == "None":
            return
        self.audit_sink({"ts": time.time(),
                         "user": user.name if user else "",
                         "verb": verb, "resource": plural,
                         "namespace": namespace or "", "name": name or ""})

    def _metrics_text(self) -> str:
        lines = ["# TYPE apiserver_request_count counter"]
        with self._count_lock:
            for key, n in sorted(self.request_count.items()):
                verb, res = key.split(":", 1)
                lines.append(
                    f'apiserver_request_count{{verb="{verb}",resource="{res}"}} {n}')
        for provider in self.metrics_providers:
            lines.append(provider())
        return "\n".join(lines) + "\n"


def _merge_patch(target: dict, patch: dict):
    """RFC 7386 merge patch (the reference default is strategic merge;
    merge patch covers the framework's PATCH uses). When the target key
    is absent or non-dict, a dict-valued patch recurses into a FRESH
    dict so nested null deletion markers are stripped instead of leaking
    into the stored object as literal nulls (RFC 7386 §2)."""
    for k, v in patch.items():
        if v is None:
            target.pop(k, None)
        elif isinstance(v, dict):
            if not isinstance(target.get(k), dict):
                target[k] = {}
            _merge_patch(target[k], v)
        else:
            target[k] = v
