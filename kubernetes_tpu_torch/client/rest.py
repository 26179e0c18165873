"""REST client over the API server.

A copy of kubernetes_tpu/client/rest.py; its relative imports resolve in this
package.

Analog of client-go's rest.RESTClient + typed clientset verbs
(client-go/rest/client.go, kubernetes/typed/core/v1): List/Get/Create/
Update/Patch/Delete plus the pod binding and eviction subresources, and
a streaming Watch that decodes JSON-lines watch events.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, Iterator, List, Optional, Tuple

from ..api import scheme
from ..utils import faultpoints


def _selector_query(label_selector=None, field_selector=None) -> List[str]:
    """Selector args (dict or raw string) -> query fragments. One
    encoder for list() and delete_collection() — the safe-char set
    keeps set-based syntax (`in (a,b)`, `!key`) readable server-side."""
    from urllib.parse import quote

    def enc(sel):
        if isinstance(sel, str):
            return quote(sel, safe="=,!()")
        return quote(",".join(f"{k}={v}" for k, v in sel.items()),
                     safe="=,")

    q = []
    if label_selector:
        q.append("labelSelector=" + enc(label_selector))
    if field_selector:
        q.append("fieldSelector=" + enc(field_selector))
    return q


def pem_arg(v):
    """CLI PEM argument: literal PEM text, or @/path/to/file."""
    if v and v.startswith("@"):
        with open(v[1:]) as f:
            return f.read()
    return v


class APIStatusError(Exception):
    def __init__(self, code: int, reason: str, message: str):
        super().__init__(f"{code} {reason}: {message}")
        self.code, self.reason, self.message = code, reason, message


class RESTClient:
    def __init__(self, base_url: str, token: Optional[str] = None,
                 user_agent: str = "kubernetes-tpu-client",
                 binary: bool = False,
                 client_cert_pem: Optional[str] = None,
                 client_key_pem: Optional[str] = None,
                 ca_cert_pem: Optional[str] = None,
                 insecure_skip_verify: bool = False):
        """binary=True negotiates the compact binary wire codec for GETs
        (api/binary.py — the reference's
        application/vnd.kubernetes.protobuf role).

        TLS (https base_url): ca_cert_pem is the kubeconfig
        certificate-authority-data analog — the server's chain must
        verify against it. client_cert_pem + client_key_pem form an
        x509 client credential issued by the cluster CA (kubeadm join /
        CSR flow), presented in the TLS handshake (mTLS); the server
        reads the identity from the verified peer chain.
        insecure_skip_verify skips server verification — used only by
        kubeadm join's trust-on-first-use cluster-info fetch."""
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.user_agent = user_agent
        self.binary = binary
        self._ssl_ctx = None
        if self.base_url.startswith("https"):
            if insecure_skip_verify:
                import ssl

                self._ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                self._ssl_ctx.check_hostname = False
                self._ssl_ctx.verify_mode = ssl.CERT_NONE
                if client_cert_pem and client_key_pem:
                    from ..server.pki import _load_cert_chain

                    _load_cert_chain(self._ssl_ctx, client_cert_pem,
                                     client_key_pem)
            elif ca_cert_pem:
                from ..server import pki

                self._ssl_ctx = pki.client_ssl_context(
                    ca_cert_pem, client_cert_pem, client_key_pem)
            else:
                raise ValueError(
                    "https server requires ca_cert_pem (or, for the "
                    "bootstrap cluster-info fetch, insecure_skip_verify)")
        elif client_cert_pem or client_key_pem:
            # an x509 credential only authenticates through a TLS
            # handshake; silently dropping it over plain http would turn
            # this client into system:anonymous with no indication
            raise ValueError(
                "client_cert_pem/client_key_pem require an https server "
                "(x509 identity comes from the TLS handshake)")

    # -- plumbing --------------------------------------------------------------

    def _path(self, plural: str, namespace: Optional[str], name: Optional[str],
              sub: Optional[str] = None) -> str:
        kind = scheme.kind_for_plural(plural)
        if kind is None:
            # unknown plural (e.g. a CRD this client hasn't discovered):
            # send a core-group request and let the server answer 404 —
            # a URL-building crash would mask the real error
            parts = ["/api/v1"]
            if namespace is not None:
                parts.append(f"namespaces/{namespace}")
            parts.append(plural)
            if name:
                parts.append(name)
            return "/".join(parts)
        ver = scheme.api_version_for(kind)
        prefix = f"/api/{ver}" if "/" not in ver else f"/apis/{ver}"
        parts = [prefix]
        if namespace is not None and scheme.is_namespaced(kind):
            parts.append(f"namespaces/{namespace}")
        parts.append(plural)
        if name:
            parts.append(name)
        if sub:
            parts.append(sub)
        return "/".join(parts)

    def request_bytes(self, method: str, path: str,
                      body: Optional[dict] = None, query: str = "",
                      accept: Optional[str] = None,
                      timeout: Optional[float] = None):
        """Raw round trip -> (body bytes, response Content-Type).
        `timeout` is the per-attempt socket deadline (default 30s) —
        binds pass a tighter one so a hung POST turns into a retryable
        error instead of stalling a binder thread for half a minute."""
        # chaos seam: an armed `rest.request` fault fails (or delays)
        # every control-plane round trip — the apiserver-flap scenario
        # the reflector backoff and bind reconciler exist to absorb.
        # `drop` models the request never reaching the wire.
        if faultpoints.fire("rest.request", payload=(method, path)):
            raise OSError(f"rest.request fault: {method} {path} dropped")
        url = self.base_url + path + (f"?{query}" if query else "")
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        req.add_header("User-Agent", self.user_agent)
        if accept:
            req.add_header("Accept", accept)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req,
                                        timeout=30 if timeout is None
                                        else timeout,
                                        context=self._ssl_ctx) as resp:
                return resp.read(), resp.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            try:
                status = json.loads(e.read())
            except Exception:
                status = {}
            raise APIStatusError(e.code, status.get("reason", e.reason or ""),
                                 status.get("message", ""))

    def request(self, method: str, path: str, body: Optional[dict] = None,
                query: str = "", timeout: Optional[float] = None) -> dict:
        raw, _ = self.request_bytes(method, path, body=body, query=query,
                                    timeout=timeout)
        return json.loads(raw or b"{}")

    # -- verbs -----------------------------------------------------------------

    def list(self, plural: str, namespace: Optional[str] = None,
             label_selector=None, field_selector=None,
             timeout: Optional[float] = None
             ) -> Tuple[List[object], int]:
        """Returns (items, list resourceVersion). Selectors may be
        {key: value} dicts or raw selector STRINGS (set-based
        expressions like "tier in (a,b)" pass through verbatim to the
        server's parser). `timeout` bounds the whole request — callers
        on the leader loop (reflector relists, recovery truth checks)
        pass a budget so one hung LIST can't ride the 30s socket
        default."""
        return self._list_once(plural, namespace,
                               _selector_query(label_selector,
                                               field_selector),
                               timeout=timeout)

    def list_paged(self, plural: str, namespace: Optional[str] = None,
                   page_size: int = 500) -> Tuple[List[object], int]:
        """Chunked list (client-go tools/pager ListPager): walk
        ?limit=N/?continue pages until the server stops returning a
        continue token. Same result as list(), bounded peak payload."""
        kind = scheme.kind_for_plural(plural)
        items: List[object] = []
        cont = None
        while True:
            q = [f"limit={page_size}"]
            if cont:
                q.append(f"continue={cont}")
            path = self._path(plural, namespace, None)
            data = self.request("GET", path, query="&".join(q))
            items.extend(scheme.decode(kind, d)
                         for d in data.get("items", []))
            rv = int(data.get("metadata", {}).get("resourceVersion", "0"))
            cont = data.get("metadata", {}).get("continue")
            if not cont:
                return items, rv

    def _list_once(self, plural, namespace, q, timeout=None):
        path = self._path(plural, namespace, None)
        if self.binary:
            from ..api import binary

            raw, ctype = self.request_bytes("GET", path,
                                            query="&".join(q),
                                            accept=binary.CONTENT_TYPE,
                                            timeout=timeout)
            if ctype.startswith(binary.CONTENT_TYPE):
                return binary.loads_list(raw)
            data = json.loads(raw or b"{}")
        else:
            data = self.request("GET", path, query="&".join(q),
                                timeout=timeout)
        kind = scheme.kind_for_plural(plural)
        items = [scheme.decode(kind, d) for d in data.get("items", [])]
        rv = int(data.get("metadata", {}).get("resourceVersion", "0"))
        return items, rv

    def get(self, plural: str, namespace: Optional[str], name: str,
            timeout: Optional[float] = None):
        path = self._path(plural, namespace, name)
        if self.binary:
            from ..api import binary

            raw, ctype = self.request_bytes("GET", path,
                                            accept=binary.CONTENT_TYPE,
                                            timeout=timeout)
            if ctype.startswith(binary.CONTENT_TYPE):
                return binary.loads(raw)
            return scheme.decode(scheme.kind_for_plural(plural),
                                 json.loads(raw or b"{}"))
        data = self.request("GET", path, timeout=timeout)
        return scheme.decode(scheme.kind_for_plural(plural), data)

    def create(self, plural: str, obj, namespace: Optional[str] = None):
        ns = namespace if namespace is not None else getattr(
            obj.metadata, "namespace", None)
        data = self.request("POST", self._path(plural, ns, None),
                            body=scheme.encode_object(obj))
        return scheme.decode(scheme.kind_for_plural(plural), data)

    def update(self, plural: str, obj, sub: Optional[str] = None):
        path = self._path(plural, obj.metadata.namespace, obj.metadata.name, sub)
        data = self.request("PUT", path, body=scheme.encode_object(obj))
        return scheme.decode(scheme.kind_for_plural(plural), data)

    def update_status(self, plural: str, obj):
        return self.update(plural, obj, sub="status")

    def patch(self, plural: str, namespace: Optional[str], name: str,
              patch: dict):
        data = self.request("PATCH", self._path(plural, namespace, name),
                            body=patch)
        return scheme.decode(scheme.kind_for_plural(plural), data)

    def delete(self, plural: str, namespace: Optional[str], name: str,
               grace_period_seconds: Optional[int] = None):
        q = (f"gracePeriodSeconds={grace_period_seconds}"
             if grace_period_seconds is not None else "")
        self.request("DELETE", self._path(plural, namespace, name),
                     query=q)

    def delete_collection(self, plural: str,
                          namespace: Optional[str] = None,
                          label_selector=None, field_selector=None):
        """Server-side deletecollection (one request deletes every
        match; its own RBAC verb). Selectors as in list()."""
        self.request("DELETE", self._path(plural, namespace, None),
                     query="&".join(_selector_query(label_selector,
                                                    field_selector)))

    def get_scale(self, plural: str, namespace: Optional[str],
                  name: str) -> dict:
        """GET the polymorphic Scale subresource (scale client
        scaleclient.ScalesGetter analog)."""
        return self.request("GET", self._path(plural, namespace, name,
                                              sub="scale"))

    def update_scale(self, plural: str, namespace: Optional[str], name: str,
                     replicas: int) -> dict:
        return self.request(
            "PUT", self._path(plural, namespace, name, sub="scale"),
            body={"kind": "Scale", "apiVersion": "autoscaling/v1",
                  "spec": {"replicas": replicas}})

    def bind(self, namespace: str, pod_name: str, node_name: str,
             timeout: Optional[float] = None):
        """POST pods/<name>/binding (scheduler.go:409 Bind). `timeout`
        bounds the single attempt; retry policy lives in the caller's
        bind reconciler, not here."""
        self.request("POST", self._path("pods", namespace, pod_name, "binding"),
                     body={"kind": "Binding", "apiVersion": "v1",
                           "metadata": {"name": pod_name},
                           "target": {"kind": "Node", "name": node_name}},
                     timeout=timeout)

    def evict(self, namespace: str, pod_name: str):
        self.request("POST", self._path("pods", namespace, pod_name, "eviction"),
                     body={"kind": "Eviction", "apiVersion": "policy/v1beta1"})

    # -- watch -----------------------------------------------------------------

    def watch(self, plural: str, resource_version: Optional[int] = None,
              timeout_seconds: float = 30.0,
              stop: Optional[threading.Event] = None,
              label_selector=None
              ) -> Iterator[Tuple[str, object]]:
        """Yields (event_type, object). Returns when the server closes the
        stream (timeout) or `stop` is set. Raises APIStatusError(410) when
        the resourceVersion is too old — caller relists (reflector.go).
        label_selector filters server-side (transitions translate to
        ADDED/DELETED like the cacher)."""
        # same chaos seam as request_bytes: watch-stream establishment is
        # a REST round trip too (a faulting one exercises the reflector's
        # jittered relist backoff)
        if faultpoints.fire("rest.request", payload=("WATCH", plural)):
            raise OSError(f"rest.request fault: watch {plural} dropped")
        q = f"watch=true&timeoutSeconds={timeout_seconds:g}"
        if resource_version is not None:
            q += f"&resourceVersion={resource_version}"
        for frag in _selector_query(label_selector, None):
            q += "&" + frag
        url = self.base_url + self._path(plural, None, None) + "?" + q
        req = urllib.request.Request(url)
        req.add_header("User-Agent", self.user_agent)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        kind = scheme.kind_for_plural(plural)
        try:
            resp = urllib.request.urlopen(req, timeout=timeout_seconds + 10,
                                          context=self._ssl_ctx)
        except urllib.error.HTTPError as e:
            try:
                status = json.loads(e.read())
            except Exception:
                status = {}
            raise APIStatusError(e.code, status.get("reason", e.reason or ""),
                                 status.get("message", ""))
        with resp:
            while stop is None or not stop.is_set():
                try:
                    line = resp.readline()
                except (socket.timeout, OSError):
                    return
                if not line:
                    return
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                yield ev["type"], scheme.decode(kind, ev["object"])
