"""PLEG — the Pod Lifecycle Event Generator.

A copy of kubernetes_tpu/kubelet/pleg.py; its relative imports resolve in this
package.

Reference: pkg/kubelet/pleg/generic.go. The kubelet must not poll every
pod every tick: the PLEG periodically relists the container runtime,
diffs container states against the previous relist, and emits pod-level
lifecycle events (ContainerStarted/ContainerDied/...) — the sync loop
then syncs only the pods with events (syncLoopIteration's plegCh case,
kubelet.go:1787).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .runtime import EXITED, RUNNING, FakeRuntime

CONTAINER_STARTED = "ContainerStarted"
CONTAINER_DIED = "ContainerDied"
CONTAINER_REMOVED = "ContainerRemoved"


@dataclass
class PodLifecycleEvent:
    pod_uid: str
    type: str
    container: str = ""


class PLEG:
    def __init__(self, runtime: FakeRuntime):
        self.runtime = runtime
        # (pod_uid, container) -> (state, restart_count) at last relist
        self._last: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.relist_count = 0

    def relist(self) -> List[PodLifecycleEvent]:
        """One relist: diff runtime container states against the
        previous pass (generic.go:190 relist)."""
        self.relist_count += 1
        events: List[PodLifecycleEvent] = []
        seen: Dict[Tuple[str, str], Tuple[str, int]] = {}
        current = self.runtime.snapshot()
        for key, (state, restarts) in current.items():
            uid, cname = key
            old = self._last.get(key)
            if old is None:
                if state == RUNNING:
                    events.append(PodLifecycleEvent(uid, CONTAINER_STARTED,
                                                    cname))
            else:
                old_state, old_restarts = old
                if state == RUNNING and (old_state != RUNNING
                                         or restarts != old_restarts):
                    events.append(PodLifecycleEvent(uid, CONTAINER_STARTED,
                                                    cname))
                elif state == EXITED and old_state != EXITED:
                    events.append(PodLifecycleEvent(uid, CONTAINER_DIED,
                                                    cname))
            seen[key] = (state, restarts)
        for key in self._last:
            if key not in seen:
                events.append(PodLifecycleEvent(key[0], CONTAINER_REMOVED,
                                                key[1]))
        self._last = seen
        return events
