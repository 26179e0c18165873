"""Userspace proxy mode: the second dataplane, with packets that flow.

A copy of kubernetes_tpu/proxy/userspace.py; its relative imports
resolve in this package.

Reference: pkg/proxy/userspace/proxier.go — the original kube-proxy
mode: one real listening socket ("proxy port") per service port, an
accept loop, and per-connection forwarding to a backend chosen by the
load balancer (roundrobin.go, with ClientIP affinity). The iptables
mode's role of redirecting the VIP to the proxy port is out of scope on
loopback — clients dial the proxy port directly, resolved via
`proxy_port()` (what the reference publishes through its iptables
redirect rules).

This mode shares the rule TABLE with the chain-structured proxier
(proxier.py) — services/endpoints/affinity/locality all resolve through
the same `Proxier` — and adds enforcement: real TCP connections are
accepted and pumped byte-for-byte to real endpoint sockets
(utils/net.pump), so tests exercise forwarding, not table contents.
Endpoint backends are (ip, port) pairs that must be reachable from this
process (hollow pods register real loopback listeners).
"""

from __future__ import annotations

import socket
import threading
from typing import Dict, Optional, Tuple

from ..utils.net import relay
from .proxier import Proxier, ServicePortName


class _ProxySocket:
    """One service port's listener + accept loop (userspace/proxysocket.go
    TCP ProxySocket)."""

    def __init__(self, outer: "UserspaceProxier", spn: ServicePortName):
        self.outer = outer
        self.spn = spn
        self.sock = socket.socket()
        self.sock.bind((outer.host, 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.closed = threading.Event()
        self.thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"userspace-proxy-{spn[1]}")
        self.thread.start()

    def _accept_loop(self):
        while not self.closed.is_set():
            try:
                conn, addr = self.sock.accept()
            except OSError:
                return  # listener closed by sync
            if self.closed.is_set():
                conn.close()  # raced the close: refuse, don't serve
                return
            threading.Thread(target=self._serve, args=(conn, addr[0]),
                             daemon=True).start()

    def _serve(self, conn: socket.socket, client_ip: str):
        ns, svc, port_name = self.spn
        backend = self.outer.table.resolve(ns, svc, port_name,
                                           client_ip=client_ip)
        if backend is None:
            conn.close()  # no ready endpoints: refuse, like an RST
            return
        relay(conn, backend)

    def close(self):
        self.closed.set()
        # shutdown BEFORE close: a close alone does not wake a thread
        # blocked in accept() on Linux (the open file description stays
        # alive inside the syscall), so the dead service's port would
        # keep accepting connections
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class UserspaceProxier:
    """The --proxy-mode=userspace dataplane over the shared rule table.

    sync() reconciles listeners against the table: a new service port
    opens a proxy socket, a deleted one closes it (userspace/proxier.go
    mergeService/unmergeService). Backend choice per CONNECTION goes
    through Proxier.resolve, so round-robin, ClientIP affinity, and
    conntrack accounting behave identically across both modes."""

    def __init__(self, store, node_name: str = "",
                 host: str = "127.0.0.1"):
        self.host = host
        self.table = Proxier(store, node_name=node_name)
        self._lock = threading.Lock()
        self._sockets: Dict[ServicePortName, _ProxySocket] = {}
        self.sync()

    def sync(self):
        """Rule-table sync + listener reconciliation."""
        self.table.sync_proxy_rules()
        with self.table._lock:
            want = set(self.table.rules)
        with self._lock:
            for spn in list(self._sockets):
                if spn not in want:
                    self._sockets.pop(spn).close()
            for spn in want:
                if spn not in self._sockets:
                    self._sockets[spn] = _ProxySocket(self, spn)

    def proxy_port(self, namespace: str, service: str,
                   port_name: str = "") -> Optional[int]:
        """The local port serving this service port (what the reference's
        iptables redirect points at)."""
        with self._lock:
            ps = self._sockets.get((namespace, service, port_name))
            return ps.port if ps else None

    def stop(self):
        with self._lock:
            for ps in self._sockets.values():
                ps.close()
            self._sockets.clear()
