"""ControllerRevision history management.

A copy of kubernetes_tpu/controllers/history.py; its relative imports
resolve in this package.

The shared bookkeeping DaemonSet and StatefulSet use for rollout
history: each distinct pod template gets an immutable, numbered
ControllerRevision owned by the workload; `kubectl rollout
history/undo` reads them back. Reference:
pkg/controller/history/controller_history.go (NewControllerRevision:
149, ControllerRevisionName:55, FindEqualRevisions:117,
truncateHistory in daemon/update.go:341 and
stateful_set_control.go:264).
"""

from __future__ import annotations

from typing import List, Optional

from ..api import scheme
from ..api import types as api
from ..runtime.store import Conflict

# apps DefaultDaemonSetUniqueLabelKey / StatefulSetRevisionLabel: the
# one label tying pods to the ControllerRevision they were built from
REV_LABEL = "controller-revision-hash"


def revision_data(template) -> dict:
    """Wire-form snapshot of a pod template, shaped like the reference's
    raw patch payload (history.go getPatch: {"spec":{"template":...}})
    so undo can splice it straight back into a workload spec."""
    enc = scheme.encode(template)
    enc.get("metadata", {}).pop("uid", None)
    return {"spec": {"template": enc}}


def revision_hash(data: dict) -> str:
    """Stable content hash naming the revision (HashControllerRevision
    analog — the reference hashes the serialized revision data)."""
    return scheme.stable_hash(data, 10)


def new_revision(owner, owner_kind: str, data: dict,
                 revision: int) -> api.ControllerRevision:
    """NewControllerRevision (controller_history.go:149): named
    <owner>-<hash>, labeled with the owner's selector labels plus the
    revision hash, owned by the workload."""
    h = revision_hash(data)
    labels = dict((owner.spec.selector.match_labels or {})
                  if owner.spec.selector else {})
    labels[REV_LABEL] = h
    return api.ControllerRevision(
        metadata=api.ObjectMeta(
            name=f"{owner.metadata.name}-{h}",
            namespace=owner.metadata.namespace,
            labels=labels,
            owner_references=[api.OwnerReference(
                kind=owner_kind, name=owner.metadata.name,
                uid=owner.metadata.uid, controller=True)]),
        data=data,
        revision=revision)


def list_revisions(store, owner, owner_kind: str) -> List[api.ControllerRevision]:
    """ListControllerRevisions: every revision controller-owned by this
    workload (uid-matched — a recreated same-name owner does not adopt
    its predecessor's history), sorted by revision number."""
    out = []
    for rev in store.list("controllerrevisions", owner.metadata.namespace):
        if any(r.controller and r.uid == owner.metadata.uid
               for r in rev.metadata.owner_references):
            out.append(rev)
    out.sort(key=lambda r: (r.revision, r.metadata.name))
    return out


def sync_revision(store, owner, owner_kind: str,
                  template,
                  revisions: Optional[List] = None) -> api.ControllerRevision:
    """Find-or-create the revision for the workload's CURRENT template
    (constructHistory in daemon/update.go:152 / getStatefulSetRevisions
    in stateful_set_control.go:315): an existing revision with equal
    data is bumped to the head revision number if it fell behind
    (rollback reuses the old snapshot); otherwise a fresh revision is
    created at max+1. Pass `revisions` (from list_revisions) to reuse a
    scan the caller already paid for."""
    data = revision_data(template)
    if revisions is None:
        revisions = list_revisions(store, owner, owner_kind)
    head = revisions[-1].revision if revisions else 0
    equal = [r for r in revisions if r.data == data]
    if equal:
        cur = equal[-1]
        if cur.revision != head or len(equal) > 1:
            # dedupCurHistories: collapse duplicates, advance the kept
            # one so history/undo ordering stays truthful
            for dup in equal[:-1]:
                try:
                    store.delete("controllerrevisions",
                                 dup.metadata.namespace, dup.metadata.name)
                except KeyError:
                    pass
            if cur.revision != head:
                cur.revision = head + 1
                try:
                    store.update("controllerrevisions", cur)
                except (Conflict, KeyError):
                    pass
        return cur
    rev = new_revision(owner, owner_kind, data, head + 1)
    base = rev.metadata.name
    for collision in range(8):
        try:
            store.create("controllerrevisions", rev)
            return rev
        except Conflict:
            existing = store.get("controllerrevisions",
                                 rev.metadata.namespace, rev.metadata.name)
            if existing is not None and any(
                    r.controller and r.uid == owner.metadata.uid
                    for r in existing.metadata.owner_references):
                return existing
            # name held by a FOREIGN owner (e.g. a deleted same-name
            # workload not yet GC'd): never adopt — probe with a
            # collision count like the reference's CreateControllerRevision
            rev.metadata.name = f"{base}-{collision + 1}"
    raise Conflict(f"controllerrevision name space exhausted for {base}")


def truncate_history(store, owner, owner_kind: str,
                     live_hashes: Optional[set] = None,
                     keep_names: Optional[set] = None,
                     revisions: Optional[List] = None) -> int:
    """Delete the oldest non-live revisions beyond
    spec.revisionHistoryLimit (truncateHistory). A revision is live if
    any current pod still carries its hash label, or it is one of the
    current/update revisions (`keep_names`) — live revisions are never
    reaped regardless of age, even at revisionHistoryLimit=0. Pass
    `revisions` to reuse the caller's list_revisions scan."""
    limit = getattr(owner.spec, "revision_history_limit", 10)
    if revisions is None:
        revisions = list_revisions(store, owner, owner_kind)
    live = live_hashes or set()
    keep = keep_names or set()
    candidates = [
        r for r in revisions
        if (r.metadata.labels or {}).get(REV_LABEL)
        not in live and r.metadata.name not in keep]
    excess = len(candidates) - max(0, limit)
    deleted = 0
    for r in candidates[:max(0, excess)]:
        try:
            store.delete("controllerrevisions", r.metadata.namespace,
                         r.metadata.name)
            deleted += 1
        except KeyError:
            pass
    return deleted
