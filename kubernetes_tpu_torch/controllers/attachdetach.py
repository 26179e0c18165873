"""Attach/detach controller: reconcile volume attachment with pod placement.

A copy of kubernetes_tpu/controllers/attachdetach.py; its relative imports
resolve in this package.

Reference: pkg/controller/volume/attachdetach/attach_detach_controller.go:95
(NewAttachDetachController). Its model, reproduced here per node:

  desired state  = for every scheduled pod on node N, the persistent
                   volumes behind its PVC volumes must be attached to N
                   (desiredStateOfWorld, cache/desired_state_of_world.go)
  actual state   = node.status.volumesAttached
  reconciler     = attach volumes that are desired but absent, detach
                   volumes that are attached but no longer desired
                   (reconciler/reconciler.go:141)

For in-tree volumes the "attach operation" is the control-plane state
transition itself — writing node.status.volumes_attached /
volumes_in_use through the store — the part the scheduler, kubelet
volume manager, and multi-attach protection consume (the reference's
cloud-provider calls live behind the cloud seam). For CSI-backed PVs
the controller additionally crosses the process boundary: the driver's
ControllerPublishVolume runs BEFORE the attachment is recorded and
ControllerUnpublishVolume before it is dropped
(attach_detach_controller.go + csi_attacher.go). A volume attached
elsewhere is not attached again until detached (multi-attach guard for
RWO volumes, reconciler.go:184).
"""

from __future__ import annotations

from typing import List, Optional, Set

from ..api import types as api
from .base import Controller


class AttachDetachController(Controller):
    name = "attachdetach"

    def __init__(self, store):
        super().__init__(store)
        self.informer("pods", enqueue_fn=self._enqueue_pod_node)
        self.informer("nodes")
        self.informer("persistentvolumeclaims",
                      enqueue_fn=lambda o=None, n=None: self._all_nodes())
        from ..volume.csi import CSIPlugin

        self._csi = CSIPlugin(store)

    def _pv(self, name: str):
        return (self.store.get("persistentvolumes", "", name)
                or self.store.get("persistentvolumes", "default", name))

    def _publish(self, pv_name: str, node_name: str) -> bool:
        """Out-of-process attach for CSI PVs; in-tree PVs attach by
        state transition alone. False = driver refused/unreachable
        (leave unattached; the queue retries with backoff)."""
        pv = self._pv(pv_name)
        if pv is None or pv.spec.source_kind != "CSI":
            return True
        from ..volume.csi import CSIError
        from ..volume.plugin import Spec

        try:
            self._csi.new_attacher().attach(Spec(pv=pv), node_name)
            return True
        except CSIError:
            return False

    def _unpublish(self, pv_name: str, node_name: str) -> bool:
        """False = the driver never received the unpublish — the
        attachment must STAY recorded so a later sync retries; dropping
        it would leak the driver's publish entry and permanently block
        the volume's next attach elsewhere."""
        pv = self._pv(pv_name)
        if pv is None or pv.spec.source_kind != "CSI":
            return True
        from ..volume.csi import CSIError

        try:
            self._csi.new_detacher().detach_pv(pv, node_name)
            return True
        except CSIError:
            return False

    def _enqueue_pod_node(self, pod, new=None):
        pod = new if new is not None else pod
        if pod.spec.node_name:
            self.enqueue(f"default/{pod.spec.node_name}")

    def _all_nodes(self):
        for node in self.store.list("nodes"):
            self.enqueue(node)

    def _desired_volumes(self, node_name: str) -> List[str]:
        """PV names required on the node by its scheduled pods."""
        want: List[str] = []
        for pod in self.store.list("pods"):
            if pod.spec.node_name != node_name or not api.is_pod_active(pod):
                continue
            for v in pod.spec.volumes:
                if not v.pvc_name:
                    continue
                pvc = self.store.get("persistentvolumeclaims", pod.namespace,
                                     v.pvc_name)
                if pvc is not None and pvc.spec.volume_name \
                        and pvc.spec.volume_name not in want:
                    want.append(pvc.spec.volume_name)
        return want

    def _attached_elsewhere(self, pv_name: str, node_name: str) -> bool:
        for node in self.store.list("nodes"):
            if node.metadata.name == node_name:
                continue
            if pv_name in node.status.volumes_attached:
                return True
        return False

    def sync(self, key: str):
        _, name = key.split("/", 1)
        node = self.store.get("nodes", "default", name)
        if node is None:
            return
        desired = self._desired_volumes(name)
        attached: List[str] = list(node.status.volumes_attached)
        changed = False
        # detach first: frees RWO volumes for their new node
        blocked = None
        for pv in list(attached):
            if pv not in desired:
                if not self._unpublish(pv, name):
                    blocked = pv  # driver unreachable: retry the detach
                    continue
                attached.remove(pv)
                changed = True
        for pv in desired:
            if pv in attached:
                continue
            if self._attached_elsewhere(pv, name):
                # multi-attach guard: wait for the other node's detach —
                # but DO persist this node's own detaches below first, or
                # two nodes each waiting on the other's stale attachment
                # would livelock (requeued with backoff by the error path)
                blocked = pv
                continue
            if not self._publish(pv, name):
                blocked = pv  # driver refused: retry with backoff
                continue
            attached.append(pv)
            changed = True
        if changed or node.status.volumes_in_use != attached:
            node.status.volumes_attached = attached
            node.status.volumes_in_use = list(attached)
            self.store.update("nodes", node)
        if blocked is not None:
            raise RuntimeError(
                f"volume {blocked} still attached to another node")
