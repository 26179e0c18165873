"""Shared informers over the object store.

Analog of client-go's SharedIndexInformer (tools/cache/
shared_informer.go:66): each informer keeps a local indexed cache of one
kind and fans events out to registered handlers. Delivery here is
synchronous in resourceVersion order (the store holds its lock during
fan-out), which gives the level-triggered determinism the reference gets
from DeltaFIFO ordering — and makes scheduler tests reproducible.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .store import ADDED, DELETED, MODIFIED, Event, ObjectStore

Handler = Callable[[object], None]
UpdateHandler = Callable[[object, object], None]


class SharedInformer:
    def __init__(self, store: ObjectStore, kind: str,
                 filter_fn: Optional[Callable[[object], bool]] = None):
        self.store = store
        self.kind = kind
        self.filter_fn = filter_fn
        self.cache: Dict[str, object] = {}
        self._on_add: List[Handler] = []
        self._on_update: List[UpdateHandler] = []
        self._on_delete: List[Handler] = []
        store.watch(kind, self._handle)
        # initial list (Reflector's list+watch, reflector.go:98)
        for obj in store.list(kind):
            self._handle(Event(ADDED, kind, obj))

    def add_event_handler(self, on_add: Optional[Handler] = None,
                          on_update: Optional[UpdateHandler] = None,
                          on_delete: Optional[Handler] = None):
        if on_add:
            self._on_add.append(on_add)
            for obj in list(self.cache.values()):
                on_add(obj)
        if on_update:
            self._on_update.append(on_update)
        if on_delete:
            self._on_delete.append(on_delete)

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _handle(self, ev: Event):
        obj = ev.obj
        passes = self.filter_fn is None or self.filter_fn(obj)
        key = self._key(obj)
        had = key in self.cache
        if ev.type == DELETED or (had and not passes):
            old = self.cache.pop(key, None)
            if old is not None:
                for h in self._on_delete:
                    h(old)
            return
        if not passes:
            return
        if ev.type == ADDED or not had:
            self.cache[key] = obj
            for h in self._on_add:
                h(obj)
        elif ev.type == MODIFIED:
            old = self.cache.get(key, obj)
            self.cache[key] = obj
            for h in self._on_update:
                h(old, obj)

    def list(self) -> List[object]:
        return list(self.cache.values())

    def get(self, namespace: str, name: str):
        return self.cache.get(f"{namespace}/{name}")
