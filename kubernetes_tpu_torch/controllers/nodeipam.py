"""Node IPAM controller: allocate pod CIDRs to nodes from the cluster CIDR.

A copy of kubernetes_tpu/controllers/nodeipam.py; its relative imports
resolve in this package.

Reference: pkg/controller/nodeipam/ipam/range_allocator.go — carve the
cluster CIDR into fixed-size per-node subnets, assign one to each node's
spec.podCIDR, release on node deletion, and never double-allocate (the
CidrSet bitmap, ipam/cidrset/cidr_set.go).
"""

from __future__ import annotations

import ipaddress
import threading

from .base import Controller


class CidrSet:
    """Bitmap allocator over cluster_cidr split at node_mask_size
    (cidr_set.go:35)."""

    def __init__(self, cluster_cidr: str, node_mask_size: int):
        self.net = ipaddress.ip_network(cluster_cidr)
        if node_mask_size < self.net.prefixlen:
            raise ValueError("node mask must be longer than cluster mask")
        self.node_mask_size = node_mask_size
        self.max_cidrs = 2 ** (node_mask_size - self.net.prefixlen)
        self._used = set()
        self._lock = threading.Lock()

    def _subnet(self, index: int) -> str:
        base = int(self.net.network_address) + (
            index << (self.net.max_prefixlen - self.node_mask_size))
        return f"{ipaddress.ip_address(base)}/{self.node_mask_size}"

    def allocate_next(self) -> str:
        with self._lock:
            for i in range(self.max_cidrs):
                if i not in self._used:
                    self._used.add(i)
                    return self._subnet(i)
            raise RuntimeError("cluster CIDR exhausted")

    def occupy(self, cidr: str) -> None:
        """Mark an existing allocation (controller restart repopulation)."""
        net = ipaddress.ip_network(cidr)
        index = (int(net.network_address) - int(self.net.network_address)) >> (
            self.net.max_prefixlen - self.node_mask_size)
        with self._lock:
            self._used.add(index)

    def release(self, cidr: str) -> None:
        net = ipaddress.ip_network(cidr)
        index = (int(net.network_address) - int(self.net.network_address)) >> (
            self.net.max_prefixlen - self.node_mask_size)
        with self._lock:
            self._used.discard(index)


class NodeIpamController(Controller):
    name = "nodeipam"

    def __init__(self, store, cluster_cidr: str = "10.244.0.0/16",
                 node_mask_size: int = 24):
        super().__init__(store)
        self.cidrs = CidrSet(cluster_cidr, node_mask_size)
        # repopulate from existing allocations before watching
        # (range_allocator.go:96 lists nodes and occupies their CIDRs)
        for node in store.list("nodes"):
            if node.spec.pod_cidr:
                self.cidrs.occupy(node.spec.pod_cidr)
        self.informer("nodes",
                      on_add=self.enqueue,
                      on_update=lambda o, n: self.enqueue(n),
                      on_delete=self._on_delete)

    def _on_delete(self, node):
        if node.spec.pod_cidr:
            self.cidrs.release(node.spec.pod_cidr)

    def resync(self):
        for node in self.store.list("nodes"):
            self.enqueue(node)

    def sync(self, key: str):
        _, name = key.split("/", 1)
        node = (self.store.get("nodes", "default", name)
                or self.store.get("nodes", "", name))
        if node is None or node.spec.pod_cidr:
            return
        node.spec.pod_cidr = self.cidrs.allocate_next()
        try:
            self.store.update("nodes", node)
        except Exception:
            self.cidrs.release(node.spec.pod_cidr)
            node.spec.pod_cidr = ""
            raise
