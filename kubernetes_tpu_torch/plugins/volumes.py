"""Volume-topology predicates (host-side plugins).

Behavioral analogs of the reference's volume predicates
(pkg/scheduler/algorithm/predicates/predicates.go):
  - MaxPDVolumeCountPredicate (:316 NewMaxPDVolumeCountPredicate) —
    per-node attachable-volume count limits for EBS / GCE PD / Azure Disk;
  - VolumeZonePredicate (:538 NewVolumeZonePredicate) — a pod using a PV
    labeled with zone/region must land on a node in that zone/region;
  - VolumeBindingPredicate (:1628 NewVolumeBindingPredicate) — bound PVCs'
    PV topology must admit the node; unbound PVCs must have a bindable PV.

These stay host-side by design: they touch a handful of pods per wave
(only pods with PVC/special volumes are relevant) and need PV/PVC lookups
— the tensorized wave kernel short-circuits them via each predicate's
`relevant(pod)` gate (see Scheduler._host_plugin_mask).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Set

from ..api import types as api
from ..sched.errors import REASONS
from ..state.node_info import NodeInfo

# Reference defaults (predicates.go:92-108 DefaultMaxEBSVolumes etc.).
DEFAULT_MAX_EBS_VOLUMES = 39
DEFAULT_MAX_GCE_PD_VOLUMES = 16
DEFAULT_MAX_AZURE_DISK_VOLUMES = 16

EBS = "AWSElasticBlockStore"
GCE_PD = "GCEPersistentDisk"
AZURE_DISK = "AzureDisk"

# Registered predicate names (reference: predicates.go:54-94).
_COUNT_NAMES = {
    EBS: "MaxEBSVolumeCount",
    GCE_PD: "MaxGCEPDVolumeCount",
    AZURE_DISK: "MaxAzureDiskVolumeCount",
}

# Zone labels a PV may carry (reference: predicates.go:594 volumeZoneLabels).
_ZONE_LABELS = (api.LABEL_ZONE, api.LABEL_REGION)


def _has_volumes(pod: api.Pod) -> bool:
    return any(v.pvc_name or v.source_kind for v in pod.spec.volumes)


def _has_pvc(pod: api.Pod) -> bool:
    return any(v.pvc_name for v in pod.spec.volumes)


class VolumeLister:
    """PV/PVC lookup facade over an ObjectStore (the reference passes
    corev1 PV/PVC informer listers into the predicate factories,
    factory.go:1048 CreateFromKeys)."""

    def __init__(self, store):
        self.store = store

    def pvc(self, namespace: str, name: str) -> Optional[api.PersistentVolumeClaim]:
        return self.store.get("persistentvolumeclaims", namespace, name)

    def pv(self, name: str) -> Optional[api.PersistentVolume]:
        # PVs are cluster-scoped; writers vary between "" and "default"
        return (self.store.get("persistentvolumes", "default", name)
                or self.store.get("persistentvolumes", "", name))

    def pvs(self) -> List[api.PersistentVolume]:
        return list(self.store.list("persistentvolumes"))


def _filter_volume_ids(pod: api.Pod, kind: str, lister: VolumeLister,
                       out: Set[str]) -> Optional[List[str]]:
    """Unique attachable volume ids of `kind` used by the pod. Returns None
    when a referenced PVC/PV is missing (the reference treats that as a
    predicate error -> pod unschedulable, predicates.go:411)."""
    for v in pod.spec.volumes:
        if v.source_kind == kind and v.source_id:
            out.add(v.source_id)
        elif v.pvc_name:
            pvc = lister.pvc(pod.namespace, v.pvc_name)
            if pvc is None:
                return None
            if not pvc.spec.volume_name:
                continue  # unbound: counted by VolumeBinding, not here
            pv = lister.pv(pvc.spec.volume_name)
            if pv is None:
                return None
            if pv.spec.source_kind == kind and pv.spec.source_id:
                out.add(pv.spec.source_id)
    return []


def new_max_pd_volume_count(kind: str, max_volumes: int, lister: VolumeLister):
    """predicates.go:316 NewMaxPDVolumeCountPredicate for one volume kind."""

    def pred(pod: api.Pod, ni: NodeInfo):
        new_ids: Set[str] = set()
        if _filter_volume_ids(pod, kind, lister, new_ids) is None:
            return False, [REASONS["MaxVolumeCount"]]
        if not new_ids:
            return True, []
        existing: Set[str] = set()
        for p in ni.pods:
            _filter_volume_ids(p, kind, lister, existing)
        if len(existing | new_ids) > max_volumes:
            return False, [REASONS["MaxVolumeCount"]]
        return True, []

    pred.relevant = _has_volumes
    pred.predicate_name = _COUNT_NAMES.get(kind, f"Max{kind}Count")
    return pred


def _pod_pvs(pod: api.Pod, lister: VolumeLister):
    """(pv, pvc) pairs for the pod's bound PVC volumes; yields (None, name)
    for dangling references."""
    for v in pod.spec.volumes:
        if not v.pvc_name:
            continue
        pvc = lister.pvc(pod.namespace, v.pvc_name)
        if pvc is None or not pvc.spec.volume_name:
            yield None, pvc
            continue
        yield lister.pv(pvc.spec.volume_name), pvc


def new_volume_zone(lister: VolumeLister):
    """predicates.go:538 NewVolumeZonePredicate: every zone/region label on
    a pod's PVs must be matched by the node (PV label values may be
    '__'-joined sets, reference volume helpers LabelZonesToSet)."""

    def pred(pod: api.Pod, ni: NodeInfo):
        node = ni.node
        if node is None:
            return False, [REASONS["NodeUnknownCondition"]]
        node_labels = node.metadata.labels or {}
        for pv, _pvc in _pod_pvs(pod, lister):
            if pv is None:
                continue  # unbound/dangling: VolumeBinding's problem
            for key in _ZONE_LABELS:
                want = pv.metadata.labels.get(key)
                if want is None:
                    continue
                have = node_labels.get(key)
                if have is None or have not in want.split("__"):
                    return False, [REASONS["NoVolumeZoneConflict"]]
        return True, []

    pred.relevant = _has_pvc
    pred.predicate_name = "NoVolumeZoneConflict"
    return pred


def _pv_admits_node(pv: api.PersistentVolume, node: api.Node) -> bool:
    na = pv.spec.node_affinity
    if na is None:
        return True
    return any(api._term_matches_node(t, node) for t in na.node_selector_terms)


def new_volume_binding(lister: VolumeLister):
    """predicates.go:1628 NewVolumeBindingPredicate (VolumeScheduling gate):
    bound PVCs' PV node-affinity must admit the node; each unbound PVC must
    have at least one unbound, class-matching PV that admits the node."""

    def pred(pod: api.Pod, ni: NodeInfo):
        node = ni.node
        if node is None:
            return False, [REASONS["NodeUnknownCondition"]]
        bound_names = None
        claimed: set = set()  # PVs provisionally matched to earlier unbound PVCs
        for v in pod.spec.volumes:
            if not v.pvc_name:
                continue
            pvc = lister.pvc(pod.namespace, v.pvc_name)
            if pvc is None:
                return False, [REASONS["VolumeBindingNoMatch"]]
            if pvc.spec.volume_name:
                pv = lister.pv(pvc.spec.volume_name)
                if pv is None or not _pv_admits_node(pv, node):
                    return False, [REASONS["VolumeNodeAffinityConflict"]]
                continue
            # unbound: provisional match against available PVs; each PV can
            # satisfy only one of the pod's claims (the reference's binding
            # computation reserves matched PVs, volumebinder/volume_binder.go)
            if bound_names is None:
                bound_names = {p.spec.volume_name
                               for p in lister.store.list("persistentvolumeclaims")
                               if p.spec.volume_name}
            match = next(
                (pv.metadata.name for pv in lister.pvs()
                 if pv.metadata.name not in bound_names
                 and pv.metadata.name not in claimed
                 and pv.spec.storage_class_name == pvc.spec.storage_class_name
                 and _pv_admits_node(pv, node)), None)
            if match is None:
                return False, [REASONS["VolumeBindingNoMatch"]]
            claimed.add(match)
        return True, []

    pred.relevant = _has_pvc
    pred.predicate_name = "CheckVolumeBinding"
    return pred


def default_volume_predicates(store) -> dict:
    """The reference default provider's volume predicate set
    (algorithmprovider/defaults/defaults.go:105: MaxEBSVolumeCount,
    MaxGCEPDVolumeCount, MaxAzureDiskVolumeCount, NoVolumeZoneConflict,
    CheckVolumeBinding)."""
    lister = VolumeLister(store)
    preds = [
        new_max_pd_volume_count(EBS, DEFAULT_MAX_EBS_VOLUMES, lister),
        new_max_pd_volume_count(GCE_PD, DEFAULT_MAX_GCE_PD_VOLUMES, lister),
        new_max_pd_volume_count(AZURE_DISK, DEFAULT_MAX_AZURE_DISK_VOLUMES, lister),
        new_volume_zone(lister),
        new_volume_binding(lister),
    ]
    return {p.predicate_name: p for p in preds}
