"""Volume expansion controller.

A copy of kubernetes_tpu/controllers/expand.py; its relative imports
resolve in this package.

Reference: pkg/controller/volume/expand/ (expand_controller.go +
sync_volume_resize.go): a bound PVC whose spec.requests.storage grew
past status.capacity gets its PV grown (the controller-side expand),
then carries FileSystemResizePending until the node-side filesystem
resize completes — done here by the kubelet's volume housekeeping for
claims mounted by its pods, and immediately by this controller for
unattached claims (the offline-resize path).
"""

from __future__ import annotations

from ..api import resources as res
from ..api import types as api
from ..runtime.store import Conflict
from .base import Controller

RESIZING = "Resizing"
FS_RESIZE_PENDING = "FileSystemResizePending"


def _cond_set(pvc, ctype: str, value: str = "True"):
    pvc.status.conditions = [c for c in pvc.status.conditions
                             if c[0] != ctype] + [(ctype, value)]


def _cond_clear(pvc, *ctypes):
    pvc.status.conditions = [c for c in pvc.status.conditions
                             if c[0] not in ctypes]


def claim_in_use(store, pvc) -> bool:
    """A pod on some node mounts the claim (expand_controller's
    in-use check deciding online vs offline finish)."""
    for p in store.list("pods", pvc.metadata.namespace):
        if not p.spec.node_name or p.status.phase not in (
                "Pending", "Running"):
            continue
        for v in p.spec.volumes:
            if getattr(v, "pvc_name", "") == pvc.metadata.name:
                return True
    return False


def finish_resize(store, pvc):
    """The node-side half (operation_executor MarkVolumeAsResized):
    grant the new size on the claim and clear the pending condition."""
    want = pvc.spec.requests.get(res.STORAGE, 0)
    pvc.status.capacity[res.STORAGE] = want
    _cond_clear(pvc, RESIZING, FS_RESIZE_PENDING)
    try:
        store.update("persistentvolumeclaims", pvc)
    except (Conflict, KeyError):
        pass


class ExpandController(Controller):
    name = "expand"

    def __init__(self, store):
        super().__init__(store)
        self.informer("persistentvolumeclaims")

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        pvc = self.store.get("persistentvolumeclaims", ns, name)
        if pvc is None or not pvc.spec.volume_name:
            return
        want = pvc.spec.requests.get(res.STORAGE, 0)
        pv = self.store.get("persistentvolumes", "",
                            pvc.spec.volume_name) or \
            self.store.get("persistentvolumes", "default",
                           pvc.spec.volume_name)
        if pv is None:
            return
        have = pvc.status.capacity.get(res.STORAGE)
        if have is None:
            # first observation of a bound claim (or a replace wiped
            # status): the granted baseline is what the PV actually
            # provides — stamping spec.requests here would silently
            # complete an expansion that never ran
            pv_cap = pv.spec.capacity.get(res.STORAGE, want)
            if pv_cap >= want and claim_in_use(self.store, pvc):
                # a wiped status can't tell GRANTED from OWED when the
                # PV already holds the new size mid-online-expand: have
                # the node confirm (finish_resize is idempotent) rather
                # than fake completion
                _cond_set(pvc, FS_RESIZE_PENDING)
                pvc.status.phase = "Bound"
                try:
                    self.store.update("persistentvolumeclaims", pvc)
                except (Conflict, KeyError):
                    pass
                return
            have = min(want, pv_cap)
            pvc.status.capacity[res.STORAGE] = have
            pvc.status.phase = "Bound"
            try:
                self.store.update("persistentvolumeclaims", pvc)
            except (Conflict, KeyError):
                return
            # fall through: a growth observed in the same sync proceeds
        if want <= have:
            return
        # controller-side phase is visible on the claim while it runs
        # (expand_controller MarkAsResizing)
        _cond_set(pvc, RESIZING)
        try:
            self.store.update("persistentvolumeclaims", pvc)
        except (Conflict, KeyError):
            return
        # controller-side expand: grow the PV capacity
        # (sync_volume_resize.go ExpandVolume -> UpdatePVSize)
        if pv.spec.capacity.get(res.STORAGE, 0) < want:
            pv.spec.capacity[res.STORAGE] = want
            try:
                self.store.update("persistentvolumes", pv)
            except (Conflict, KeyError):
                return
        if claim_in_use(self.store, pvc):
            # node-side filesystem resize still owed: the claim's
            # kubelet finishes it (MarkForFSResize)
            _cond_set(pvc, FS_RESIZE_PENDING)
            _cond_clear(pvc, RESIZING)
            try:
                self.store.update("persistentvolumeclaims", pvc)
            except (Conflict, KeyError):
                pass
        else:
            # offline expand completes immediately
            finish_resize(self.store, pvc)
