"""Storage-object-in-use protection: PVC and PV protection controllers.

A copy of kubernetes_tpu/controllers/storageprotection.py; its relative imports
resolve in this package.

Reference: pkg/controller/volume/pvcprotection/pvc_protection_
controller.go and .../pvprotection/ (the StorageObjectInUseProtection
feature): every claim carries the kubernetes.io/pvc-protection
finalizer, so deleting a claim a running pod still mounts only MARKS it
(Terminating) — the data cannot be yanked out from under the pod. The
controller removes the finalizer once no pod uses the claim, which
completes the deletion. PVs get the same treatment while bound to a
claim.

Deletion gating itself is API machinery (metadata.finalizers +
deletion_timestamp, server/apiserver.py delete/update paths); these
controllers only add/remove the finalizers. In-process components that
call store.delete directly bypass finalizers by design (raw storage
access, like etcdctl would).
"""

from __future__ import annotations

from ..api import types as api
from .base import Controller

PVC_PROTECTION_FINALIZER = "kubernetes.io/pvc-protection"
PV_PROTECTION_FINALIZER = "kubernetes.io/pv-protection"


def release_finalizer(store, plural: str, obj, finalizer: str) -> None:
    """Remove one finalizer; when it was the LAST one on an object
    marked for deletion, complete the removal. The completion cannot
    live in ObjectStore.update generically: namespaces legitimately
    update with deletion_timestamp set and empty metadata.finalizers
    during their own spec.finalizers-driven termination flow, so a
    store-level rule would delete them mid-flight. The apiserver's
    update path applies the same rule for API writers."""
    obj.metadata.finalizers = [f for f in (obj.metadata.finalizers or [])
                               if f != finalizer]
    store.update(plural, obj)
    if obj.metadata.deletion_timestamp is not None \
            and not obj.metadata.finalizers:
        try:
            store.delete(plural, obj.metadata.namespace,
                         obj.metadata.name)
        except KeyError:
            pass  # an API-path writer already completed it


def _pods_using_pvc(store, namespace: str, claim_name: str):
    for pod in store.list("pods", namespace):
        if not api.is_pod_active(pod):
            continue
        for v in pod.spec.volumes:
            if v.pvc_name == claim_name:
                yield pod
                break


class PVCProtectionController(Controller):
    name = "pvcprotection"

    def __init__(self, store):
        super().__init__(store)
        self.informer("persistentvolumeclaims")
        # pod deletions can unblock a Terminating claim
        self.informer("pods", enqueue_fn=self._enqueue_pod_claims)

    def _enqueue_pod_claims(self, pod, new=None):
        pod = new if new is not None else pod
        for v in pod.spec.volumes:
            if v.pvc_name:
                self.enqueue(f"{pod.metadata.namespace}/{v.pvc_name}")

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        pvc = self.store.get("persistentvolumeclaims", ns, name)
        if pvc is None:
            return
        fins = list(pvc.metadata.finalizers or [])
        if pvc.metadata.deletion_timestamp is None:
            if PVC_PROTECTION_FINALIZER not in fins:
                pvc.metadata.finalizers = fins + [PVC_PROTECTION_FINALIZER]
                self.store.update("persistentvolumeclaims", pvc)
            return
        # Terminating: release once no active pod mounts it
        if PVC_PROTECTION_FINALIZER not in fins:
            return
        if any(True for _ in _pods_using_pvc(self.store, ns, name)):
            return  # still in use: stay Terminating
        release_finalizer(self.store, "persistentvolumeclaims", pvc,
                          PVC_PROTECTION_FINALIZER)

    def resync(self):
        for pvc in self.store.list("persistentvolumeclaims"):
            self.enqueue(pvc)


class PVProtectionController(Controller):
    name = "pvprotection"

    def __init__(self, store):
        super().__init__(store)
        self.informer("persistentvolumes")
        self.informer("persistentvolumeclaims",
                      enqueue_fn=self._enqueue_bound_pv)

    def _enqueue_bound_pv(self, pvc, new=None):
        pvc = new if new is not None else pvc
        if pvc.spec.volume_name:
            self.enqueue(f"/{pvc.spec.volume_name}")

    def _bound(self, pv_name: str) -> bool:
        return any(pvc.spec.volume_name == pv_name
                   for pvc in self.store.list("persistentvolumeclaims"))

    def sync(self, key: str):
        _, name = key.split("/", 1)
        pv = (self.store.get("persistentvolumes", "", name)
              or self.store.get("persistentvolumes", "default", name))
        if pv is None:
            return
        fins = list(pv.metadata.finalizers or [])
        if pv.metadata.deletion_timestamp is None:
            if PV_PROTECTION_FINALIZER not in fins:
                pv.metadata.finalizers = fins + [PV_PROTECTION_FINALIZER]
                self.store.update("persistentvolumes", pv)
            return
        if PV_PROTECTION_FINALIZER not in fins:
            return
        if self._bound(name):
            return  # a claim still references it
        release_finalizer(self.store, "persistentvolumes", pv,
                          PV_PROTECTION_FINALIZER)

    def resync(self):
        for pv in self.store.list("persistentvolumes"):
            self.enqueue(pv)
