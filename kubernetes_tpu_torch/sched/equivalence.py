"""Equivalence-class cache for host-side predicates.

Analog of pkg/scheduler/core/equivalence_cache.go: pods created by the
same controller are scheduling-equivalent (getEquivalenceClassInfo:240
hashes the OwnerReferences), so a predicate result computed for one pod
of a ReplicaSet on node X holds for its siblings until something about X
(or the objects the predicate reads) changes. The reference guards this
behind the EnableEquivalenceClassCache feature gate, as does this
framework.

Scope difference from the reference: the device wave kernel already
evaluates the tensorized predicates for all (pod, node) pairs in one
fused pass — memoization would cost more than it saves there. What's
worth caching is the *host-side* predicate loop
(scheduler._host_plugin_mask: volume predicates, NoDiskConflict —
Python, O(pods x nodes)), which is exactly the expensive per-node work
the reference built the cache for (RunPredicate:66).

Invalidation mirrors factory.go:191-295's event handler wiring:
  node add/update/delete      -> drop that node's entries
  assigned pod add/delete     -> drop per-node entries for pod-derived
                                 predicates (NoDiskConflict, MaxPDVolumeCount)
  PV/PVC add/delete           -> drop volume predicates everywhere
  Service add/update/delete   -> drop CheckServiceAffinity everywhere
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

from ..api import types as api

# predicate name -> invalidated by assigned-pod events on the node
POD_DERIVED = frozenset({
    "NoDiskConflict", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount", "GeneralPredicates", "PodFitsHostPorts",
})
# predicate name -> invalidated cluster-wide by PV/PVC events
VOLUME_DERIVED = frozenset({
    "NoVolumeZoneConflict", "CheckVolumeBinding", "MaxEBSVolumeCount",
    "MaxGCEPDVolumeCount", "MaxAzureDiskVolumeCount",
})
SERVICE_DERIVED = frozenset({"CheckServiceAffinity"})


def equivalence_class(pod: api.Pod) -> Optional[int]:
    """Hash of the controlling owner reference PLUS the
    scheduling-relevant spec fields the cached predicates actually read
    (the reference's equivalencePod struct, equivalence_cache.go:240 —
    hashing the owner ref alone lets a pod that shares a controller but
    differs in volumes/ports/labels reuse another pod's cached fit).
    Pods without a controller get no class — their spec is not provably
    shared."""
    for ref in pod.metadata.owner_references:
        if ref.controller:
            spec = pod.spec
            vols = tuple((v.name, v.source_kind, v.source_id, v.pvc_name)
                         for v in spec.volumes)
            ports = tuple(sorted((p.host_port, p.container_port)
                                 for c in spec.containers
                                 for p in c.ports))
            labels = tuple(sorted((pod.metadata.labels or {}).items()))
            selector = tuple(sorted(spec.node_selector.items()))
            return hash((ref.kind, ref.name, ref.uid, pod.metadata.namespace,
                         vols, ports, labels, selector))
    return None


class EquivalenceCache:
    def __init__(self):
        self._lock = threading.Lock()
        # node -> predicate -> eclass -> (ok, reasons)
        self._cache: Dict[str, Dict[str, Dict[int, Tuple[bool, tuple]]]] = {}
        self.hits = 0
        self.misses = 0

    # -- lookup/update (RunPredicate:66) ---------------------------------------

    def lookup(self, eclass: Optional[int], node: str, predicate: str):
        if eclass is None:
            return None
        with self._lock:
            got = self._cache.get(node, {}).get(predicate, {}).get(eclass)
            if got is None:
                self.misses += 1
            else:
                self.hits += 1
            return got

    def update(self, eclass: Optional[int], node: str, predicate: str,
               ok: bool, reasons: Sequence[str]):
        if eclass is None:
            return
        with self._lock:
            self._cache.setdefault(node, {}).setdefault(
                predicate, {})[eclass] = (ok, tuple(reasons))

    # -- invalidation (InvalidateCachedPredicateItem:157) ----------------------

    def invalidate_node(self, node: str):
        with self._lock:
            self._cache.pop(node, None)

    def invalidate_predicates(self, predicates, node: Optional[str] = None):
        with self._lock:
            targets = ([self._cache.get(node, {})] if node is not None
                       else list(self._cache.values()))
            for per_node in targets:
                for p in predicates:
                    per_node.pop(p, None)

    def invalidate_all(self):
        with self._lock:
            self._cache.clear()

    # -- event handlers (factory.go handler sets) ------------------------------

    def on_node_event(self, node_name: str):
        self.invalidate_node(node_name)

    def on_assigned_pod_event(self, node_name: str):
        self.invalidate_predicates(POD_DERIVED, node=node_name)

    def on_volume_event(self):
        self.invalidate_predicates(VOLUME_DERIVED)

    def on_service_event(self):
        self.invalidate_predicates(SERVICE_DERIVED)
