"""Per-pod workers — serialized sync streams.

A copy of kubernetes_tpu/kubelet/pod_workers.py; its relative imports
resolve in this package.

Reference: pkg/kubelet/pod_workers.go. Each pod gets its own work
stream: syncs for the SAME pod are strictly serialized (never two
concurrent syncPods for one UID), syncs for DIFFERENT pods can run
concurrently, and a burst of updates for one pod collapses to the
latest state (podWorkers' one-pending-update buffer).

Two modes:
  inline (default)  update_pod runs the sync on the calling thread —
                    the deterministic path the synchronous sync loop
                    and tests use.
  async             one daemon worker per active pod UID with a
                    latest-wins pending slot, matching the reference's
                    goroutine-per-pod model.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional


class PodWorkers:
    def __init__(self, sync_fn: Callable, async_mode: bool = False):
        self.sync_fn = sync_fn
        self.async_mode = async_mode
        self._lock = threading.Lock()
        # uid -> pending (args tuple) | None; presence in dict = worker live
        self._pending: Dict[str, Optional[tuple]] = {}
        self._wakeups: Dict[str, threading.Event] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._gone: set = set()  # forgotten uids: their workers exit
        self._stop = threading.Event()

    def update_pod(self, pod, *args):
        """Dispatch a sync for this pod (UpdatePod, pod_workers.go:200).
        Inline mode runs it now; async mode hands it to the pod's worker,
        replacing any not-yet-started pending update (latest wins)."""
        if not self.async_mode:
            self.sync_fn(pod, *args)
            return
        uid = pod.metadata.uid
        with self._lock:
            self._gone.discard(uid)  # re-created pod: revive its stream
            self._pending[uid] = (pod, *args)
            ev = self._wakeups.get(uid)
            if ev is None:
                ev = self._wakeups[uid] = threading.Event()
                t = threading.Thread(target=self._worker, args=(uid, ev),
                                     daemon=True, name=f"podworker-{uid}")
                self._threads[uid] = t
                t.start()
            ev.set()

    def _worker(self, uid: str, ev: threading.Event):
        while not self._stop.is_set():
            with self._lock:
                if uid in self._gone:
                    self._gone.discard(uid)
                    return
            if not ev.wait(timeout=0.2):
                continue
            ev.clear()
            while True:
                with self._lock:
                    if uid in self._gone:
                        self._gone.discard(uid)
                        return
                    work = self._pending.get(uid)
                    if work is not None:
                        self._pending[uid] = None
                if work is None:
                    break
                try:
                    self.sync_fn(*work)
                except Exception:
                    pass  # a pod sync failure must not kill its worker

    def forget(self, uid: str):
        """Drop the worker for a removed pod (removeWorker): the thread
        exits on its next wakeup/poll instead of leaking."""
        with self._lock:
            if uid not in self._wakeups:
                return
            self._gone.add(uid)
            self._pending.pop(uid, None)
            ev = self._wakeups.pop(uid, None)
            self._threads.pop(uid, None)
        if ev is not None:
            ev.set()  # wake the thread so it observes _gone promptly

    def stop(self):
        self._stop.set()
        with self._lock:
            for ev in self._wakeups.values():
                ev.set()

    def active_count(self) -> int:
        with self._lock:
            return len(self._threads)
