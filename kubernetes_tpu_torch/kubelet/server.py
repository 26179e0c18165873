"""The kubelet's HTTP serving surface: logs, exec, pods, healthz.

A copy of kubernetes_tpu/kubelet/server.py; its relative imports
resolve in this package.

Reference: pkg/kubelet/server/server.go — the kubelet runs an HTTPS
server the apiserver proxies into for the debugging plane:
  GET  /containerLogs/<ns>/<pod>/<container>   (server.go getContainerLogs)
  POST /exec/<ns>/<pod>/<container>            (server.go:325 getExec)
  GET  /pods                                   (server.go getPods)
  GET  /healthz

Security: with `tls` set (a pki.ClusterCA) the server speaks HTTPS with
a CA-issued serving cert and REQUIRES a CA-issued client cert in the
handshake; exec/containerLogs additionally demand the caller be the
apiserver's kubelet-client identity or a system:masters holder — so the
apiserver's RBAC check on pods/exec cannot be bypassed by connecting to
the kubelet port directly (the reference delegates kubelet authz to the
apiserver via SubjectAccessReview; the cert-identity gate is this
framework's collapsed form). Without `tls` (embedded/test clusters) the
server is plain HTTP and open — matching the in-process store's trust
model where every component already shares memory.

Divergence, deliberate: exec is a one-shot JSON request/response against
the fake runtime instead of a SPDY/websocket stream — the control flow
(apiserver proxy -> kubelet -> runtime) is the part being reproduced.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..api import scheme


class KubeletServer:
    def __init__(self, kubelet, host: str = "127.0.0.1", port: int = 0,
                 tls=None):
        self.kubelet = kubelet
        self._tls = tls
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                outer._handle(self, "GET")

            def do_POST(self):
                outer._handle(self, "POST")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        if tls is not None:
            from ..server import pki

            key_pem, cert_pem = pki.issue_server_cert(
                tls, f"system:node:{kubelet.node_name}")
            pki.wrap_http_server(self._httpd, pki.server_ssl_context(
                tls.ca_cert_pem, cert_pem, key_pem,
                require_client_cert=True))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "KubeletServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"kubelet-server-{self.kubelet.node_name}")
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- routing ----------------------------------------------------------------

    def _find_pod(self, namespace: str, pod_name: str):
        pod = self.kubelet.store.get("pods", namespace, pod_name)
        if pod is None or pod.spec.node_name != self.kubelet.node_name:
            return None  # only pods bound to THIS node are served
        return pod

    @staticmethod
    def _runtime_uid(pod) -> str:
        """The uid the RUNTIME knows the pod by. A static pod's
        apiserver object is its mirror, whose containers run under the
        file-derived static uid recorded in the mirror annotation
        (pod/mirror_client.go TranslatePodUID) — without this
        translation logs/exec/attach/stats against static pods 404."""
        from .kubelet import MIRROR_ANNOTATION

        return ((pod.metadata.annotations or {}).get(MIRROR_ANNOTATION)
                or pod.metadata.uid)

    def _authorized(self, h) -> bool:
        """Exec/log callers must hold the apiserver's kubelet-client
        identity or system:masters (see module docstring). Plain-HTTP
        servers (tls=None) don't gate — in-process trust model."""
        if self._tls is None:
            return True
        from ..server import pki

        peer = pki.peer_identity(h.connection)
        if peer is None:
            return False
        cn, orgs = peer
        return cn == "kube-apiserver" or "system:masters" in orgs

    def _handle(self, h, method: str):
        parsed = urlparse(h.path)
        parts = [p for p in parsed.path.split("/") if p]
        query = parse_qs(parsed.query)
        if parts == ["healthz"]:
            return h._send(200, b"ok", "text/plain")
        if parts and parts[0] in ("containerLogs", "exec", "attach",
                                  "portForward") and not self._authorized(h):
            return h._send(403, b"forbidden", "text/plain")
        if parts == ["stats", "summary"] and method == "GET":
            # server_stats.go + apis/stats/v1alpha1 Summary: node-level
            # aggregates plus per-pod, per-container cpu/memory. Usage
            # comes from the runtime's cadvisor seam (set_usage).
            return h._send(200, json.dumps(self._summary()).encode())
        if parts == ["pods"] and method == "GET":
            pods = [p for p in self.kubelet.store.list("pods")
                    if p.spec.node_name == self.kubelet.node_name]
            return h._send(200, json.dumps(
                {"kind": "PodList",
                 "items": [scheme.encode_object(p) for p in pods]}).encode())
        if len(parts) == 4 and parts[0] == "containerLogs" \
                and method == "GET":
            _, ns, pod_name, container = parts
            pod = self._find_pod(ns, pod_name)
            if pod is None:
                return h._send(404, b"pod not found", "text/plain")
            tail = query.get("tailLines", [None])[0]
            if tail is not None:
                try:
                    tail = int(tail)
                except ValueError:
                    return h._send(400, b"tailLines must be an integer",
                                   "text/plain")
            previous = query.get("previous", ["false"])[0] == "true"
            lines = self.kubelet.runtime.container_logs(
                self._runtime_uid(pod), container, tail=tail,
                previous=previous)
            if lines is None:
                return h._send(404, f"container {container!r} not found"
                               .encode(), "text/plain")
            return h._send(200, ("\n".join(lines) + "\n").encode()
                           if lines else b"", "text/plain")
        if len(parts) == 4 and parts[0] == "exec" and method == "POST":
            _, ns, pod_name, container = parts
            pod = self._find_pod(ns, pod_name)
            if pod is None:
                return h._send(404, b"pod not found", "text/plain")
            length = int(h.headers.get("Content-Length") or 0)
            try:
                body = json.loads(h.rfile.read(length) or b"{}")
                cmd = list(body.get("command") or [])
                stdin = body.get("stdin")
            except (ValueError, TypeError):
                return h._send(400, b"bad exec body", "text/plain")
            if not cmd:
                return h._send(400, b"no command", "text/plain")
            rc, out = self.kubelet.runtime.exec_in_container(
                self._runtime_uid(pod), container, cmd, stdin=stdin)
            return h._send(200, json.dumps(
                {"exitCode": rc, "output": out}).encode())
        if len(parts) == 4 and parts[0] == "attach" and method == "GET":
            # server.go:640 getAttach. SPDY streaming collapses to a
            # long-poll over the container's live log stream: return the
            # lines appended at/after ?since=<index> (waiting up to
            # ?waitSeconds for new output), plus the next cursor — the
            # client re-arms to follow the stream.
            _, ns, pod_name, container = parts
            pod = self._find_pod(ns, pod_name)
            if pod is None:
                return h._send(404, b"pod not found", "text/plain")
            try:
                since = int(query.get("since", ["0"])[0])
                wait = min(float(query.get("waitSeconds", ["2"])[0]), 30.0)
            except ValueError:
                return h._send(400, b"bad attach query", "text/plain")
            import time as _time

            deadline = _time.monotonic() + wait
            while True:
                lines = self.kubelet.runtime.container_logs(
                    self._runtime_uid(pod), container)
                if lines is None:
                    return h._send(404, f"container {container!r} not "
                                   f"found".encode(), "text/plain")
                if len(lines) > since or _time.monotonic() >= deadline:
                    break
                _time.sleep(0.02)
            return h._send(200, json.dumps(
                {"lines": lines[since:], "next": len(lines)}).encode())
        if len(parts) == 3 and parts[0] == "portForward" and method == "POST":
            # server.go:751 getPortForward. The SPDY data channel becomes
            # a real TCP relay: the kubelet opens an ephemeral listener
            # and pipes every accepted connection to the pod's declared
            # backend (FakeRuntime.register_pod_server — the hollow
            # analog of the container process's socket). Returns the
            # relay address; bytes then flow client->kubelet->pod.
            _, ns, pod_name = parts
            pod = self._find_pod(ns, pod_name)
            if pod is None:
                return h._send(404, b"pod not found", "text/plain")
            length = int(h.headers.get("Content-Length") or 0)
            try:
                body = json.loads(h.rfile.read(length) or b"{}")
                port = int(body.get("port"))
            except (ValueError, TypeError):
                return h._send(400, b"bad portForward body", "text/plain")
            backend = self.kubelet.runtime.pod_server(self._runtime_uid(pod),
                                                      port)
            if backend is None:
                return h._send(400, f"pod {pod_name!r} has no listener "
                               f"on port {port}".encode(), "text/plain")
            relay_port = self._start_relay(backend)
            return h._send(200, json.dumps(
                {"host": "127.0.0.1", "port": relay_port}).encode())
        h._send(404, b"not found", "text/plain")

    def _summary(self) -> dict:
        """Summary API document (apis/stats/v1alpha1/types.go shapes:
        usageNanoCores / workingSetBytes; podRef name/namespace/uid)."""
        pods = [p for p in self.kubelet.store.list("pods")
                if p.spec.node_name == self.kubelet.node_name]
        pod_docs = []
        node_cpu_nanos = 0
        node_mem = 0
        for p in pods:
            containers = []
            cpu_nanos = 0
            mem = 0
            for st in self.kubelet.runtime.container_stats(self._runtime_uid(p)):
                c_nanos = st.cpu_millicores * 1_000_000
                containers.append({
                    "name": st.name,
                    "cpu": {"usageNanoCores": c_nanos},
                    "memory": {"workingSetBytes": st.memory_bytes}})
                cpu_nanos += c_nanos
                mem += st.memory_bytes
            pod_docs.append({
                "podRef": {"name": p.metadata.name,
                           "namespace": p.metadata.namespace,
                           "uid": p.metadata.uid},
                "cpu": {"usageNanoCores": cpu_nanos},
                "memory": {"workingSetBytes": mem},
                "containers": containers})
            node_cpu_nanos += cpu_nanos
            node_mem += mem
        return {"node": {"nodeName": self.kubelet.node_name,
                         "cpu": {"usageNanoCores": node_cpu_nanos},
                         "memory": {"workingSetBytes": node_mem}},
                "pods": pod_docs}

    def _start_relay(self, backend) -> int:
        """One-connection TCP relay to the pod backend; closes after the
        first session ends (enough for the port-forward contract: a
        fresh POST opens a fresh relay)."""
        import socket

        from ..utils.net import relay_once

        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        port = lsock.getsockname()[1]
        threading.Thread(target=relay_once, args=(lsock, backend),
                         kwargs={"accept_timeout": 30}, daemon=True,
                         name="kubelet-portforward").start()
        return port
