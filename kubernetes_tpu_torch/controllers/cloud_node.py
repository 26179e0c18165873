"""Cloud node controller: initialize nodes from the cloud's view of them.

A copy of kubernetes_tpu/controllers/cloud_node.py; its relative imports
resolve in this package.

Reference: pkg/controller/cloud/node_controller.go — a node registers
with the `node.cloudprovider.kubernetes.io/uninitialized` taint
(:71 AddCloudNode path); this controller fills in what only the cloud
knows — addresses (:443), providerID (:391), instance-type and
zone/region labels (:411-437) — then removes the taint so the scheduler
will use the node (:355).
"""

from __future__ import annotations

from ..api import types as api
from ..cloud.provider import LABEL_INSTANCE_TYPE, CloudProvider
from .base import Controller

CLOUD_TAINT = "node.cloudprovider.kubernetes.io/uninitialized"
LABEL_ZONE = "failure-domain.beta.kubernetes.io/zone"
LABEL_REGION = "failure-domain.beta.kubernetes.io/region"


class CloudNodeController(Controller):
    name = "cloud-node"

    def __init__(self, store, cloud: CloudProvider):
        super().__init__(store)
        self.cloud = cloud
        self.informer("nodes",
                      on_add=self.enqueue,
                      on_update=lambda o, n: self.enqueue(n),
                      on_delete=lambda o: None)

    def resync(self):
        for node in self.store.list("nodes"):
            self.enqueue(node)

    def sync(self, key: str):
        _, name = key.split("/", 1)
        node = (self.store.get("nodes", "default", name)
                or self.store.get("nodes", "", name))
        if node is None:
            return
        if not any(t.key == CLOUD_TAINT for t in node.spec.taints):
            return  # already initialized (or not a cloud node)
        instances = self.cloud.instances()
        zones = self.cloud.zones()
        if instances is None:
            return
        # gather every cloud answer BEFORE touching the node: any raise
        # (→ rate-limited retry; registration can out-run the cloud API,
        # :383) must not leave half-initialized state on the live object
        addresses = instances.node_addresses(name)
        provider_id = node.spec.provider_id or instances.instance_id(name)
        itype = instances.instance_type(name)
        zone = zones.get_zone_by_node_name(name) if zones is not None else None
        node.status.addresses = addresses
        node.spec.provider_id = provider_id
        if itype:
            node.metadata.labels[LABEL_INSTANCE_TYPE] = itype
        if zone is not None:
            if zone.failure_domain:
                node.metadata.labels[LABEL_ZONE] = zone.failure_domain
            if zone.region:
                node.metadata.labels[LABEL_REGION] = zone.region
        node.spec.taints = [t for t in node.spec.taints
                            if t.key != CLOUD_TAINT]
        self.store.update("nodes", node)
