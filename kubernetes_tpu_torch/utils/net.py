"""TCP relay primitive shared by the port-forward data path.

A copy of kubernetes_tpu/utils/net.py; its relative imports resolve in this
package.

Both ends of `kubectl port-forward` are the same machine here — the
kubectl local listener and the kubelet's relay to the pod backend
(kubelet/server.py, cli/kubectl.py) — so the one-connection
accept → connect → bidirectional-pump structure lives once, in this
module, instead of drifting apart in two copies."""

from __future__ import annotations

import socket
import threading


def pump(src: socket.socket, dst: socket.socket) -> None:
    """Copy bytes src -> dst until EOF, then half-close dst so the far
    end observes the EOF too."""
    try:
        while True:
            data = src.recv(4096)
            if not data:
                break
            dst.sendall(data)
    except OSError:
        pass
    finally:
        try:
            dst.shutdown(socket.SHUT_WR)
        except OSError:
            pass


def relay(conn: socket.socket, backend) -> None:
    """Connect to `backend` (host, port) and pump both directions of
    `conn` until either side closes; closes both sockets."""
    try:
        up = socket.create_connection(backend, timeout=10)
    except OSError:
        conn.close()
        return
    t = threading.Thread(target=pump, args=(conn, up), daemon=True)
    t.start()
    pump(up, conn)
    t.join(timeout=10)
    conn.close()
    up.close()


def relay_once(lsock: socket.socket, backend, accept_timeout=None) -> None:
    """Accept ONE connection on `lsock` and relay it to `backend`.
    Closes the listener after (or on) the accept — a fresh relay needs a
    fresh listener, which is the port-forward contract here."""
    if accept_timeout is not None:
        lsock.settimeout(accept_timeout)
    try:
        conn, _ = lsock.accept()
    except OSError:
        lsock.close()
        return
    lsock.close()
    relay(conn, backend)


def node_daemon_endpoint(store, name):
    """(host, kubelet_port) for a Node's serving endpoint, or None if
    the node is absent or publishes no daemon endpoint — ONE resolution
    idiom shared by the apiserver's exec/log proxy and the
    metrics-server scraper (the reference reads
    node.Status.DaemonEndpoints.KubeletEndpoint)."""
    node = (store.get("nodes", "", name)
            or store.get("nodes", "default", name))
    if node is None or not node.status.kubelet_port:
        return None
    host = next((a.address for a in node.status.addresses if a.address),
                "127.0.0.1")
    return host, node.status.kubelet_port
