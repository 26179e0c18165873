"""Scheduler volume binder: bind PVCs as part of the scheduling commit.

Reference: pkg/scheduler/scheduler.go:268 assumeAndBindVolumes +
pkg/scheduler/volumebinder/volume_binder.go:40 (VolumeScheduling feature
gate). When the wave commits a pod to a node, the pod's UNBOUND
persistent-volume claims are matched to persistent volumes whose node
affinity admits that node and bound (claim.spec.volumeName written
through the store) before the pod's own bind posts. A bind failure later
in the commit rolls the claim bindings back (the reference's
scheduler.go:305 forgets assumed volumes on error).

The CheckVolumeBinding predicate (plugins/volumes.py new_volume_binding)
already proved a feasible matching exists on the node; this module
performs the matching for real: smallest sufficient PV (capacity >= the
claim's request), the same first-fit PersistentVolumeController uses.

Ownership split (StorageClass volumeBindingMode, flattened onto the
claim as spec.volume_binding_mode): "Immediate" claims are bound by
PersistentVolumeController the moment a PV matches — the scheduler only
waits for them; "WaitForFirstConsumer" claims are bound HERE at pod
commit, when the node is known. One writer per claim: no rv races on
volume_name.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..api import resources as res
from ..api import types as api
from ..plugins.volumes import _pv_admits_node


class VolumeBinder:
    def __init__(self, store):
        self.store = store

    def pod_has_claims(self, pod: api.Pod) -> bool:
        return any(v.pvc_name for v in pod.spec.volumes)

    def volumes_admit_node(self, pod: api.Pod,
                           node: Optional[api.Node]) -> bool:
        """True when every BOUND claim of the pod names a PV admitting
        `node`. Used by bind reconciliation: a pre-binding made for the
        node WE chose must be rolled back when the pod actually landed
        on a node those PVs cannot serve — but kept when it can (our
        rollback would clobber a still-valid, possibly re-written,
        binding)."""
        if node is None:
            return False
        for v in pod.spec.volumes:
            if not v.pvc_name:
                continue
            pvc = self.store.get("persistentvolumeclaims", pod.namespace,
                                 v.pvc_name)
            if pvc is None or not pvc.spec.volume_name:
                continue
            pv = self.store.get("persistentvolumes", "default",
                                pvc.spec.volume_name)
            if pv is None or not _pv_admits_node(pv, node):
                return False
        return True

    def bind_pod_volumes(self, pod: api.Pod, node: Optional[api.Node]
                         ) -> Tuple[bool, Optional[Callable[[], None]]]:
        """Bind the pod's unbound PVCs to PVs admitting `node`.
        Returns (ok, rollback): rollback un-binds everything this call
        bound (None when nothing was bound). ok=False means no feasible
        matching or a store write failed — nothing is left half-bound."""
        if node is None:
            return False, None
        plan: List[Tuple[api.PersistentVolumeClaim, str]] = []
        taken = None  # built lazily: pre-bound-only pods never scan
        pvs = None
        for v in pod.spec.volumes:
            if not v.pvc_name:
                continue
            pvc = self.store.get("persistentvolumeclaims", pod.namespace,
                                 v.pvc_name)
            if pvc is None:
                return False, None
            if pvc.spec.volume_name:
                pv = self.store.get("persistentvolumes", "default",
                                    pvc.spec.volume_name)
                if pv is None or not _pv_admits_node(pv, node):
                    return False, None
                continue
            if pvc.spec.volume_binding_mode != "WaitForFirstConsumer":
                # Immediate claims belong to PersistentVolumeController;
                # binding here would race its writer. Not bound yet ->
                # the pod waits (reference: unbound immediate claims fail
                # podPassesBasicChecks, generic_scheduler.go:1031)
                return False, None
            if taken is None:
                taken = {c.spec.volume_name
                         for c in self.store.list("persistentvolumeclaims")
                         if c.spec.volume_name}
                # ascending capacity: first fit = smallest sufficient PV,
                # the same selection PersistentVolumeController makes
                pvs = sorted(self.store.list("persistentvolumes"),
                             key=lambda pv: sum(pv.spec.capacity.values()))
            want = pvc.spec.requests.get("storage", 0) or \
                pvc.spec.requests.get(res.MEMORY, 0)
            match = next(
                (pv for pv in pvs
                 if pv.metadata.name not in taken
                 and pv.spec.storage_class_name == pvc.spec.storage_class_name
                 and sum(pv.spec.capacity.values()) >= want
                 and _pv_admits_node(pv, node)), None)
            if match is None:
                return False, None
            taken.add(match.metadata.name)
            plan.append((pvc, match.metadata.name))
        if not plan:
            return True, None
        bound: List[api.PersistentVolumeClaim] = []

        def rollback():
            for claim in bound:
                claim.spec.volume_name = ""
                try:
                    self.store.update("persistentvolumeclaims", claim)
                except Exception:
                    pass  # best effort; controller reconciles leftovers

        for pvc, pv_name in plan:
            pvc.spec.volume_name = pv_name
            try:
                self.store.update("persistentvolumeclaims", pvc)
            except Exception:
                pvc.spec.volume_name = ""
                rollback()
                return False, None
            bound.append(pvc)
        return True, rollback
