"""Watch broadcaster: one event source fanned out to many watchers.

A copy of kubernetes_tpu/runtime/watch.py; its relative imports resolve in this
package.

Analog of apimachinery's watch.Broadcaster (apimachinery/pkg/watch/mux.go)
plus the apiserver watch-cache's ability to replay history from a given
resourceVersion (apiserver/pkg/storage/watch_cache.go:97): events are
kept in a bounded ring so a watcher starting at an older resourceVersion
receives the backlog before going live — the level-triggered contract
informers rely on (relist only when the requested version has fallen out
of the window).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, List, Optional

from .store import Event, ObjectStore

# Slow-watcher overflow policy: a watcher whose queue fills is
# TERMINATED — its stream ends and the client relists from current state
# (the level-triggered recovery path every informer already has). The
# alternatives are both worse: blocking the broadcaster stalls event
# delivery for EVERY other watcher behind one slow consumer
# (apimachinery's mux.go blocks, acceptable only in-process), and
# silently dropping single events breaks the watch contract — the client
# keeps consuming a stream that skipped history and never finds out.
OVERFLOW_TERMINATE = "terminate"


class TooOld(Exception):
    """Requested resourceVersion has fallen out of the event window
    (the reference returns HTTP 410 Gone; the client relists)."""


class Watcher:
    def __init__(self, broadcaster: "Broadcaster", kind: Optional[str],
                 depth: int):
        self._b = broadcaster
        self.kind = kind
        self._q: "queue.Queue[Optional[Event]]" = queue.Queue(depth)
        self.stopped = False

    def next(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event, or None on timeout / stop sentinel."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self):
        if not self.stopped:
            self.stopped = True
            self._b._remove(self)


class Broadcaster:
    # the one overflow policy that preserves both liveness (never block
    # the broadcaster) and the watch contract (never silently skip
    # events); not configurable — any future alternative must rework
    # the fan-out below, which hardcodes terminate semantics
    overflow_policy = OVERFLOW_TERMINATE

    def __init__(self, store: ObjectStore, window: int = 4096,
                 queue_depth: int = 10000):
        self._lock = threading.Lock()
        self._window = window
        self._queue_depth = queue_depth
        self.overflowed_total = 0  # watchers terminated for falling behind
        self._history: List[Event] = []
        self._watchers: List[Watcher] = []
        store.watch(None, self._on_event)

    def _on_event(self, ev: Event):
        with self._lock:
            self._history.append(ev)
            if len(self._history) > self._window:
                del self._history[: len(self._history) - self._window]
            dead = []
            for w in self._watchers:
                if w.kind is not None and w.kind != ev.kind:
                    continue
                try:
                    w._q.put_nowait(ev)
                except queue.Full:
                    dead.append(w)  # slow watcher: terminate; client relists
            for w in dead:
                self.overflowed_total += 1
                logging.getLogger(__name__).warning(
                    "terminating slow watcher (kind=%s) at queue depth %d; "
                    "its stream ends and the client must relist",
                    w.kind, self._queue_depth)
                self._drop(w)

    def _drop(self, w: Watcher):
        if w in self._watchers:
            self._watchers.remove(w)
            w.stopped = True  # lets serving loops terminate the stream
            try:
                w._q.put_nowait(None)  # sentinel unblocks next()
            except queue.Full:
                pass

    def _remove(self, w: Watcher):
        with self._lock:
            self._drop(w)

    def watch(self, kind: Optional[str] = None,
              since_rv: Optional[int] = None) -> Watcher:
        """Start a watcher. If since_rv is given, replay history newer than
        that version first; raise TooOld if the window no longer covers it."""
        with self._lock:
            w = Watcher(self, kind, self._queue_depth)
            if since_rv is not None and self._history:
                oldest = self._history[0].resource_version
                if since_rv + 1 < oldest:
                    raise TooOld(f"resourceVersion {since_rv} is too old "
                                 f"(window starts at {oldest})")
                for ev in self._history:
                    if ev.resource_version > since_rv and (
                            kind is None or ev.kind == kind):
                        w._q.put_nowait(ev)
            self._watchers.append(w)
            return w
