"""Event recording.

Analog of client-go/tools/record/event.go:56 EventRecorder: components
emit (reason, message) events about API objects; correlated duplicates
are aggregated by bumping count/lastTimestamp instead of creating new
objects (events_cache.go EventAggregator).

The involved object's kind comes from KINDS, the types the port's
controllers record on; any other object (the node-lifecycle controller's
synthetic Zone) is named by its class.
"""

from __future__ import annotations

import time
from typing import Optional

from ..api import types as api
from ..runtime.store import Conflict

# object type -> API kind (kubernetes_tpu/api/scheme.py registers these
# two under the same names)
KINDS = {api.Pod: "Pod", api.Node: "Node"}


class EventRecorder:
    def __init__(self, store, source_component: str, clock=time.time):
        self.store = store
        self.source = source_component
        self.clock = clock

    def event(self, obj, event_type: str, reason: str, message: str):
        """Record an event about obj (Normal or Warning)."""
        kind = KINDS.get(type(obj)) or type(obj).__name__
        meta = obj.metadata
        name = f"{meta.name}.{reason.lower()}.{self.source}"
        ns = meta.namespace or "default"
        now = self.clock()
        existing = self.store.get("events", ns, name)
        if existing is not None:
            # same correlation key: bump count, take the latest message
            # (events_cache.go eventObserve)
            existing.count += 1
            existing.message = message
            existing.last_timestamp = now
            try:
                self.store.update("events", existing)
            except (Conflict, KeyError):
                pass
            return
        ev = api.EventObject(
            metadata=api.ObjectMeta(name=name, namespace=ns),
            involved_kind=kind, involved_name=meta.name,
            involved_namespace=meta.namespace,
            reason=reason, message=message, type=event_type,
            source_component=self.source,
            first_timestamp=now, last_timestamp=now)
        try:
            self.store.create("events", ev)
        except Conflict:
            existing = self.store.get("events", ns, name)
            if existing is not None:
                existing.count += 1
                existing.message = message
                existing.last_timestamp = now
                try:
                    self.store.update("events", existing)
                except (Conflict, KeyError):
                    pass
