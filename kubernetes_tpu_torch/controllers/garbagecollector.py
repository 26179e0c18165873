"""Graph-based owner-reference garbage collector.

A copy of kubernetes_tpu/controllers/garbagecollector.py; its relative imports
resolve in this package.

Reference: pkg/controller/garbagecollector/ — the GraphBuilder watches
every monitored resource and maintains a uid-keyed dependency graph
(graph_builder.go:204 syncMonitors, :560 processGraphChanges); the
collector pops dependents whose owners are gone and deletes them
(garbagecollector.go:404 attemptToDeleteItem), classifying each owner
reference as solid (owner exists with the SAME uid) or dangling
(absent, or a same-named object with a different uid — a recreated
owner must NOT readopt the old dependents).

Mechanics mirrored here:

  * monitors over every registered kind feed add/update/delete into the
    graph; owners referenced before they are observed become VIRTUAL
    nodes that an attempt pass verifies against the store
    (graph_builder.go attemptToDelete enqueue of virtual nodes).
  * deleting an owner enqueues its dependents; each dependent with no
    remaining solid owner is deleted, whose delete event enqueues ITS
    dependents — background cascading deletion through the graph.
  * a dependent with a mix of solid and dangling refs is patched to
    drop only the dangling refs (attemptToDeleteItem's
    "delete owner references" branch).
  * orphaning: this API model has no DeleteOptions, so the reference's
    propagationPolicy=Orphan / "orphan" finalizer flow
    (garbagecollector.go attemptToOrphan) is carried by the
    ORPHAN_ANNOTATION on the owner: when such an owner is deleted, its
    dependents have the owner's references stripped instead of being
    collected.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..api import scheme
from ..api import types as api
from ..runtime.store import ADDED, DELETED, MODIFIED, Event
from .base import Controller

ORPHAN_ANNOTATION = "kubernetes.io/orphan-dependents"

# kinds not worth monitoring: high-churn, never owner-linked
_SKIP_PLURALS = {"events", "podmetrics", "leases"}


@dataclass
class _Node:
    """graph_builder.go `node`: one object (or virtual owner) by uid."""

    uid: str
    plural: str
    namespace: str
    name: str
    owners: List[api.OwnerReference] = field(default_factory=list)
    dependents: Set[str] = field(default_factory=set)
    virtual: bool = False
    orphan: bool = False  # last-observed orphan intent
    # identity keys this node is filed under in _ident_deps (its own
    # uid-less owner references)
    ident_refs: Set[tuple] = field(default_factory=set)


class GarbageCollector(Controller):
    name = "garbagecollector"

    def __init__(self, store):
        super().__init__(store)
        self._glock = threading.Lock()
        self._nodes: Dict[str, _Node] = {}
        self.deleted_total = 0
        self._monitored: Set[str] = set()
        # dependents linked to an owner by (plural, namespace, name)
        # because their reference carries no uid — resolved by identity
        self._ident_deps: Dict[tuple, Set[str]] = {}
        self.sync_monitors()

    # -- monitors (graph_builder.go:204 syncMonitors) --------------------------

    def sync_monitors(self):
        """Monitor every currently-registered kind; called again from
        resync() so CRD-defined kinds gain monitors after registration."""
        for kind in scheme.all_kinds():
            plural = scheme.plural_for_kind(kind)
            if plural in self._monitored or plural in _SKIP_PLURALS:
                continue
            self._monitored.add(plural)
            # raw watch + initial list, NOT a SharedInformer: the graph
            # is the cache; an informer would duplicate every object of
            # every kind into per-kind maps the GC never reads
            self.store.watch(plural, self._on_event)
            for obj in self.store.list(plural):
                self._on_event(Event(ADDED, plural, obj))

    def resync(self):
        self.sync_monitors()

    def _on_event(self, ev: Event):
        if ev.type == DELETED:
            self._observe_delete(ev.kind, ev.obj)
        elif ev.type in (ADDED, MODIFIED):
            self._observe(ev.kind, ev.obj)

    # -- graph maintenance (processGraphChanges) -------------------------------

    def _plural_for(self, kind: str) -> Optional[str]:
        try:
            return scheme.plural_for_kind(kind)
        except KeyError:
            return None

    @staticmethod
    def _safe_namespaced(plural_or_kind: str, by_plural: bool) -> bool:
        """is_namespaced that tolerates unregistered kinds (a CRD may be
        deleted while its leftover instances still emit events)."""
        try:
            kind = (scheme.kind_for_plural(plural_or_kind)
                    if by_plural else plural_or_kind)
            if not kind:
                return True
            return scheme.is_namespaced(kind)
        except KeyError:
            return True


    def _observe(self, plural: str, obj):
        uid = obj.metadata.uid
        verify: List[str] = []
        with self._glock:
            n = self._nodes.get(uid)
            if n is None:
                n = _Node(uid=uid, plural=plural,
                          namespace=obj.metadata.namespace,
                          name=obj.metadata.name)
                self._nodes[uid] = n
            n.plural, n.namespace, n.name = (plural, obj.metadata.namespace,
                                             obj.metadata.name)
            n.virtual = False
            n.orphan = (obj.metadata.annotations or {}).get(
                ORPHAN_ANNOTATION) == "true"
            old_uids = {r.uid for r in n.owners if r.uid}
            n.owners = list(obj.metadata.owner_references or [])
            new_uids = set()
            new_idents = set()
            for ref in n.owners:
                if not ref.uid:
                    # uid-less reference: link by identity so the owner's
                    # eventual delete still enqueues this dependent;
                    # cluster-scoped owners file under "" so the delete
                    # event's lookup matches whatever namespace the
                    # dependent lives in
                    ref_ns = (obj.metadata.namespace
                              if self._safe_namespaced(ref.kind, False)
                              else "")
                    key = (self._plural_for(ref.kind) or ref.kind,
                           ref_ns, ref.name)
                    new_idents.add(key)
                    self._ident_deps.setdefault(key, set()).add(uid)
                    continue
                new_uids.add(ref.uid)
                on = self._nodes.get(ref.uid)
                if on is None:
                    # owner not yet observed: virtual node, verified
                    # against the store by the attempt pass
                    on = _Node(uid=ref.uid,
                               plural=self._plural_for(ref.kind) or "",
                               namespace=obj.metadata.namespace,
                               name=ref.name, virtual=True)
                    self._nodes[ref.uid] = on
                    verify.append(ref.uid)
                on.dependents.add(uid)
            for gone in sorted(old_uids - new_uids):
                o = self._nodes.get(gone)
                if o is not None:
                    o.dependents.discard(uid)
            for key in sorted(n.ident_refs - new_idents):
                deps = self._ident_deps.get(key)
                if deps is not None:
                    deps.discard(uid)
                    if not deps:
                        del self._ident_deps[key]
            n.ident_refs = new_idents
        for vuid in verify:
            self.queue.add(f"attempt:{vuid}")
        if obj.metadata.owner_references:
            self.queue.add(f"attempt:{uid}")

    def _observe_delete(self, plural: str, obj):
        uid = obj.metadata.uid
        with self._glock:
            n = self._nodes.pop(uid, None)
            deps = set(n.dependents) if n else set()
            orphan = n.orphan if n else False
            if n:
                for ref in n.owners:
                    if ref.uid and ref.uid in self._nodes:
                        self._nodes[ref.uid].dependents.discard(uid)
                for key in n.ident_refs:
                    d = self._ident_deps.get(key)
                    if d is not None:
                        d.discard(uid)
                        if not d:
                            del self._ident_deps[key]
            # dependents that referenced this owner by bare identity:
            # kept registered (a recreated same-name owner satisfies a
            # uid-less ref), just re-verified now. Cluster-scoped kinds
            # are filed (and looked up) under "" regardless of the
            # namespace strings either object carries.
            owner_ns = (obj.metadata.namespace
                        if self._safe_namespaced(plural, True) else "")
            deps |= self._ident_deps.get(
                (plural, owner_ns, obj.metadata.name), set())
        for dep in sorted(deps):
            self.queue.add(f"orphan:{dep}:{uid}" if orphan
                           else f"attempt:{dep}")

    # -- collection (attemptToDeleteItem) --------------------------------------

    def _lookup(self, plural: str, namespace: str, name: str):
        obj = self.store.get(plural, namespace, name)
        if obj is None:
            kind = scheme.kind_for_plural(plural)
            if kind is not None and not scheme.is_namespaced(kind):
                obj = self.store.get(plural, "", name) or \
                    self.store.get(plural, "default", name)
        return obj

    def _owner_alive(self, namespace: str, ref: api.OwnerReference) -> bool:
        """Solid owner: exists AND (when both sides carry uids) is the
        same incarnation — a recreated same-name owner is dangling."""
        plural = self._plural_for(ref.kind)
        if plural is None:
            return True  # unmonitorable kind: never collect on its account
        obj = self._lookup(plural, namespace, ref.name)
        if obj is None:
            return False
        return not ref.uid or not obj.metadata.uid or \
            ref.uid == obj.metadata.uid

    def sync(self, key: str):
        verb, _, rest = key.partition(":")
        if verb == "orphan":
            dep_uid, _, owner_uid = rest.partition(":")
            self._orphan_dependent(dep_uid, owner_uid)
            return
        uid = rest
        with self._glock:
            n = self._nodes.get(uid)
            info = (n.plural, n.namespace, n.name, n.virtual) if n else None
        if info is None:
            return
        plural, namespace, name, virtual = info
        if virtual:
            obj = self._lookup(plural, namespace, name) if plural else None
            if obj is not None and obj.metadata.uid == uid:
                # observed late through a different monitor ordering; the
                # informer's own event fills the rest
                with self._glock:
                    if uid in self._nodes:
                        self._nodes[uid].virtual = False
                return
            # the owner never existed (or is a different incarnation):
            # release the virtual node and collect its dependents
            with self._glock:
                n = self._nodes.pop(uid, None)
                deps = sorted(n.dependents) if n else []
            for dep in deps:
                self.queue.add(f"attempt:{dep}")
            return
        obj = self._lookup(plural, namespace, name)
        if obj is None or obj.metadata.uid != uid:
            return  # delete event will prune the graph
        refs = list(obj.metadata.owner_references or [])
        if not refs:
            return
        solid = [r for r in refs
                 if self._owner_alive(obj.metadata.namespace, r)]
        if solid and len(solid) < len(refs):
            # drop only the dangling references (attemptToDeleteItem's
            # patch branch); the object survives on its solid owners
            obj.metadata.owner_references = solid
            self.store.update(plural, obj)
            return
        if not solid:
            try:
                self.store.delete(plural, obj.metadata.namespace,
                                  obj.metadata.name)
                self.deleted_total += 1
            except KeyError:
                pass

    def _orphan_dependent(self, dep_uid: str, owner_uid: str):
        with self._glock:
            n = self._nodes.get(dep_uid)
            info = (n.plural, n.namespace, n.name) if n else None
        if info is None:
            return
        obj = self._lookup(*info)
        if obj is None or obj.metadata.uid != dep_uid:
            return
        kept = [r for r in obj.metadata.owner_references
                if r.uid != owner_uid]
        if len(kept) != len(obj.metadata.owner_references):
            obj.metadata.owner_references = kept
            self.store.update(info[0], obj)

    # -- drive ----------------------------------------------------------------

    def sweep(self) -> int:
        """Drain the attempt queue (cascades re-fill it mid-drain);
        returns objects deleted by this call. The ControllerManager's
        periodic sweeper and tests drive collection through here."""
        before = self.deleted_total
        while self.sync_all():
            pass
        return self.deleted_total - before
