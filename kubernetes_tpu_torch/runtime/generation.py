"""metadata.generation maintenance, shared by every store backend.

A copy of kubernetes_tpu/runtime/generation.py; its fingerprint goes
through this package's api/scheme.py `stable_hash`, as JAX's does.

The reference bumps ObjectMeta.Generation in each registry strategy's
PrepareForUpdate when the SPEC changes (status-only writes leave it);
controllers echo it into status.observedGeneration and rollout-status
gates on the pair. This logic originally lived inline in the in-process
ObjectStore only, so persistent (--data-dir) clusters served stale
generations and `kubectl rollout status` could never converge there —
the tracker below is the one implementation both ObjectStore and
NativeObjectStore now call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# kinds whose metadata.generation tracks spec changes: only the kinds
# whose controllers echo status.observedGeneration pay the fingerprint
# cost — pods/nodes and the frequently status-written replicasets stay
# off the hot path
GENERATION_KINDS = frozenset({
    "deployments", "daemonsets", "statefulsets",
})


def tracks_generation(kind: str) -> bool:
    return kind in GENERATION_KINDS


def spec_fingerprint(obj) -> str:
    """Stable hash of the object's wire-form spec."""
    from ..api import scheme

    spec = getattr(obj, "spec", None)
    if spec is None:
        return ""
    return scheme.stable_hash(spec)


class GenerationTracker:
    """Per-store (fingerprint, generation) cache. Callers routinely
    mutate stored objects in place before update(), so spec changes are
    detected against the last stored WIRE FORM, never object identity; a
    store that can supply an independently-decoded `old` snapshot
    (persistent backends after a restart, whose cache starts empty) gets
    seeded from it so status-only writes still leave generation alone.

    The prepare/commit split exists for stores whose write can FAIL
    after the generation is stamped (CAS conflict, duplicate create):
    prepare_* stamps obj.metadata.generation and returns a token; the
    cache mutates only at commit(token) once the write landed — a
    polluted cache would otherwise swallow the bump when the same spec
    change is retried."""

    def __init__(self):
        # kind -> key -> (spec fingerprint, generation) as last STORED
        self._state: Dict[str, Dict[str, Tuple[str, int]]] = {}

    @staticmethod
    def _key(obj) -> str:
        meta = obj.metadata
        return f"{meta.namespace}/{meta.name}"

    def knows(self, kind: str, namespace: str, name: str) -> bool:
        return f"{namespace}/{name}" in self._state.get(kind, ())

    def prepare_create(self, kind: str, obj):
        if kind not in GENERATION_KINDS:
            return None
        obj.metadata.generation = obj.metadata.generation or 1
        return (kind, self._key(obj), spec_fingerprint(obj),
                obj.metadata.generation)

    def prepare_update(self, kind: str, obj, old=None):
        """Registry PrepareForUpdate analog: generation advances only on
        spec change. `old` (optional) must be an independent snapshot of
        the stored object — it seeds fingerprint AND prior generation
        when this tracker has never seen the key (fresh process over
        durable data); an in-place-mutated alias of `obj` would defeat
        the comparison, so identical objects are ignored."""
        if kind not in GENERATION_KINDS:
            return None
        key = self._key(obj)
        fp = spec_fingerprint(obj)
        known = self._state.get(kind, {}).get(key)
        known_fp, known_gen = known if known is not None else (None, 0)
        old_gen = getattr(getattr(old, "metadata", None), "generation",
                          0) or 0
        prior = max(obj.metadata.generation, known_gen, old_gen, 1)
        if known_fp is None and old is not None and old is not obj:
            known_fp = spec_fingerprint(old)
        if known_fp != fp:
            obj.metadata.generation = prior + 1
        else:
            obj.metadata.generation = prior
        return (kind, key, fp, obj.metadata.generation)

    def commit(self, token) -> None:
        if token is None:
            return
        kind, key, fp, gen = token
        self._state.setdefault(kind, {})[key] = (fp, gen)

    # one-shot forms for stores whose failure paths all precede the
    # tracker call (the in-process ObjectStore)
    def on_create(self, kind: str, obj) -> None:
        self.commit(self.prepare_create(kind, obj))

    def on_update(self, kind: str, obj, old=None) -> None:
        self.commit(self.prepare_update(kind, obj, old))

    def on_delete(self, kind: str, namespace: str, name: str) -> None:
        self._state.get(kind, {}).pop(f"{namespace}/{name}", None)
