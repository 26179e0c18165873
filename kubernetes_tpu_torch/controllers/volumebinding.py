"""PersistentVolume binder: match PVCs to PVs.

A copy of kubernetes_tpu/controllers/volumebinding.py; its relative imports
resolve in this package.

Reference: pkg/controller/volume/persistentvolume/pv_controller.go
(syncUnboundClaim:320 — find the smallest PV satisfying class +
capacity, bind by setting claim.spec.volumeName and marking the PV
bound). The scheduler's volume predicates consume the binding
(NoVolumeZoneConflict / CheckVolumeBinding, plugins/volumes.py).
"""

from __future__ import annotations

from ..api import resources as res
from ..api import types as api
from ..runtime.store import Conflict
from .base import Controller


class PersistentVolumeController(Controller):
    name = "persistentvolume"

    def __init__(self, store):
        super().__init__(store)
        self.informer("persistentvolumeclaims")
        self.informer("persistentvolumes",
                      enqueue_fn=lambda o: self._all_claims())

    def _all_claims(self):
        for pvc in self.store.list("persistentvolumeclaims"):
            self.enqueue(pvc)

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        pvc = self.store.get("persistentvolumeclaims", ns, name)
        if pvc is None or pvc.spec.volume_name:
            return
        if pvc.spec.volume_binding_mode == "WaitForFirstConsumer":
            # owned by the scheduler's VolumeBinder: bound at pod commit,
            # when the node (and thus PV topology) is known — binding here
            # would both race that writer and ignore node affinity
            return
        want = pvc.spec.requests.get(res.MEMORY, 0) or \
            pvc.spec.requests.get("storage", 0)
        bound_pvs = {c.spec.volume_name
                     for c in self.store.list("persistentvolumeclaims")
                     if c.spec.volume_name}
        best = None
        for pv in self.store.list("persistentvolumes"):
            if pv.metadata.name in bound_pvs:
                continue
            if pv.spec.storage_class_name != pvc.spec.storage_class_name:
                continue
            cap = pv.spec.capacity.get("storage",
                                       pv.spec.capacity.get(res.MEMORY, 0))
            if cap < want:
                continue
            if best is None or cap < best[0]:
                best = (cap, pv)
        if best is None:
            raise RuntimeError(f"no PV available for claim {key}")
        pvc.spec.volume_name = best[1].metadata.name
        try:
            self.store.update("persistentvolumeclaims", pvc)
        except (Conflict, KeyError):
            pvc.spec.volume_name = ""
            raise
