"""Event recording.

A copy of kubernetes_tpu/client/record.py: the involved object's kind
is this package's api/scheme.py `kind_of`, the class name for an
unregistered object (the node-lifecycle controller's synthetic Zone).

Analog of client-go/tools/record/event.go:56 EventRecorder: components
emit (reason, message) events about API objects; correlated duplicates
are aggregated by bumping count/lastTimestamp instead of creating new
objects (events_cache.go EventAggregator).
"""

from __future__ import annotations

import time
from typing import Optional

from ..api import scheme
from ..api import types as api
from ..runtime.store import Conflict


class EventRecorder:
    def __init__(self, store, source_component: str, clock=time.time):
        self.store = store
        self.source = source_component
        self.clock = clock

    def event(self, obj, event_type: str, reason: str, message: str):
        """Record an event about obj (Normal or Warning)."""
        kind = scheme.kind_of(obj) or type(obj).__name__
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
