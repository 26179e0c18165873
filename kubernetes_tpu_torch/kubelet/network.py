"""Kubelet network plugin seam: pod IP assignment.

A copy of kubernetes_tpu/kubelet/network.py; its relative imports
resolve in this package.

Reference: pkg/kubelet/network/plugins.go (NetworkPlugin interface:
SetUpPod/TearDownPod/GetPodNetworkStatus) with the kubenet/CNI
host-local IPAM behavior (allocate each pod an address from the node's
podCIDR, release on teardown). The nodeipam controller hands every node
a spec.podCIDR; this plugin turns it into concrete pod IPs that flow
into pod.status.podIP, the endpoints controller, and the proxy's
backend tables.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Dict, Optional


class NetworkPlugin:
    """The plugin contract (network/plugins.go:58)."""

    name = "noop"

    def setup_pod(self, pod_uid: str) -> str:
        """-> the pod's IP (idempotent per uid)."""
        raise NotImplementedError

    def teardown_pod(self, pod_uid: str):
        raise NotImplementedError

    def status(self) -> Optional[str]:
        """None = healthy; a message = NetworkNotReady (the kubelet
        surfaces it as a node condition)."""
        return None


class HashIPPlugin(NetworkPlugin):
    """Deterministic uid-hash addressing in 10/8 — the no-CIDR fallback
    matching what the endpoints controller historically fabricated, so
    IPs stay stable for a pod's whole life with zero state."""

    name = "hash-ip"

    def setup_pod(self, pod_uid: str) -> str:
        h = abs(hash(pod_uid))
        return f"10.{(h >> 16) % 256}.{(h >> 8) % 256}.{h % 254 + 1}"

    def teardown_pod(self, pod_uid: str):
        pass


class HostLocalIPAM(NetworkPlugin):
    """host-local IPAM over the node's podCIDR (the kubenet shape):
    sequential allocation, free-list reuse, idempotent per pod uid.
    Raises when the CIDR is exhausted — the reference surfaces this as
    a pod setup failure, not a silent reuse."""

    name = "host-local"

    def __init__(self, pod_cidr: str):
        self.network = ipaddress.ip_network(pod_cidr)
        self._lock = threading.Lock()
        self._by_uid: Dict[str, str] = {}
        self._used: set = set()
        # skip network + gateway + broadcast like host-local does
        self._hosts = max(0, self.network.num_addresses - 3)

    def reserve(self, pod_uid: str, ip: str):
        """Adopt an EXISTING pod's address (kubelet restart: live pods'
        status.podIP is the authoritative allocation record — without
        re-reserving, a new pod could be handed a running pod's IP)."""
        with self._lock:
            self._by_uid[pod_uid] = ip
            self._used.add(ip)

    def setup_pod(self, pod_uid: str) -> str:
        with self._lock:
            got = self._by_uid.get(pod_uid)
            if got is not None:
                return got
            if len(self._used) >= self._hosts:
                raise RuntimeError(
                    f"podCIDR {self.network} exhausted "
                    f"({len(self._used)} addresses in use)")
            base = int(self.network.network_address)
            # the final offset is the broadcast address: never a pod IP
            for off in range(2, self.network.num_addresses - 1):
                ip = str(ipaddress.ip_address(base + off))
                if ip not in self._used:
                    self._used.add(ip)
                    self._by_uid[pod_uid] = ip
                    return ip
            raise RuntimeError(f"podCIDR {self.network} exhausted")

    def teardown_pod(self, pod_uid: str):
        with self._lock:
            ip = self._by_uid.pop(pod_uid, None)
            if ip is not None:
                self._used.discard(ip)

    def pod_ip(self, pod_uid: str) -> Optional[str]:
        with self._lock:
            return self._by_uid.get(pod_uid)
