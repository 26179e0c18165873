"""Device plugin manager: extended resources with concrete device IDs.

A copy of kubernetes_tpu/kubelet/devicemanager.py; its relative imports
resolve in this package.

Reference: pkg/kubelet/cm/devicemanager/manager.go (plugin
registration + ListAndWatch device updates + Allocate at pod
admission) and pkg/kubelet/cm/devicemanager/pod_devices.go (per-pod
device assignments surfaced to containers as env). This is how
accelerators reach pods: a plugin advertises `vendor/resource` device
IDs, the node publishes the count as capacity/allocatable, the
scheduler fits against the count (extended resources are already
int64 columns in the snapshot), and the kubelet pins concrete IDs at
admission — e.g. a TPU plugin exporting google.com/tpu chips whose
assigned IDs land in TPU_VISIBLE_DEVICES.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

from ..api import types as api

def _sanitize(part: str) -> str:
    return part.upper().replace("-", "_").replace(".", "_")


def _visible_env(resource: str, ambiguous: set) -> str:
    """Env var carrying assigned IDs: the short resource name
    upper-cased (google.com/tpu -> TPU_VISIBLE_DEVICES); when two
    registered vendors share a short name (nvidia.com/gpu +
    amd.com/gpu) BOTH use the full resource name so neither silently
    overwrites the other."""
    name = resource.rsplit("/", 1)[-1]
    if name in ambiguous:
        return f"{_sanitize(resource.replace('/', '_'))}_VISIBLE_DEVICES"
    return f"{_sanitize(name)}_VISIBLE_DEVICES"


class DevicePlugin:
    """What a registered plugin contributes: a resource name and the
    health-tagged device IDs it keeps current (ListAndWatch analog —
    the plugin flips health, the manager reconciles)."""

    def __init__(self, resource: str, device_ids: List[str]):
        self.resource = resource
        self.devices: Dict[str, bool] = {d: True for d in device_ids}

    def set_health(self, device_id: str, healthy: bool):
        if device_id in self.devices:
            self.devices[device_id] = healthy


class DeviceManager:
    """manager.go: plugin registry + allocation bookkeeping. Thread-safe
    because allocation happens on the kubelet sync path while health
    updates arrive from plugin callbacks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plugins: Dict[str, DevicePlugin] = {}
        # resource -> pod uid -> container name -> assigned ids
        self._allocated: Dict[str, Dict[str, Dict[str, List[str]]]] = {}

    def register(self, plugin: DevicePlugin):
        """Register (server.go Register RPC): later registrations for
        the same resource replace the earlier plugin's device set."""
        with self._lock:
            self._plugins[plugin.resource] = plugin
            self._allocated.setdefault(plugin.resource, {})

    def unregister(self, resource: str):
        """Plugin endpoint gone (manager.go markResourceUnhealthy +
        GetCapacity's deletedResources): the resource stops being
        advertised — the kubelet heartbeat zeroes it from node status.
        In-flight allocations stay recorded so a plugin that comes back
        finds running pods still pinned to their exact device IDs."""
        with self._lock:
            self._plugins.pop(resource, None)

    def resources(self) -> List[str]:
        with self._lock:
            return sorted(self._plugins)

    # -- node status ----------------------------------------------------------

    def capacity(self) -> Dict[str, int]:
        """GetCapacity: total registered devices per resource (healthy
        or not — unhealthy devices stay in capacity, leave allocatable)."""
        with self._lock:
            return {r: len(p.devices) for r, p in self._plugins.items()}

    def allocatable(self) -> Dict[str, int]:
        with self._lock:
            return {r: sum(1 for h in p.devices.values() if h)
                    for r, p in self._plugins.items()}

    # -- allocation (allocatePodResources) ------------------------------------

    def _in_use(self, resource: str) -> Set[str]:
        used: Set[str] = set()
        for containers in self._allocated.get(resource, {}).values():
            for ids in containers.values():
                used.update(ids)
        return used

    def allocate(self, pod: api.Pod) -> Dict[str, Dict[str, List[str]]]:
        """Pin concrete healthy device IDs for every extended-resource
        request in the pod; all-or-nothing per pod (admission fails with
        UnexpectedAdmissionError when devices ran out — e.g. they went
        unhealthy after the scheduler counted them). Returns
        container -> resource -> ids. Idempotent per pod uid."""
        with self._lock:
            out: Dict[str, Dict[str, List[str]]] = {}
            staged: Dict[str, List[str]] = {}  # resource -> newly taken
            for c in pod.spec.containers:
                out[c.name] = {}
                for resource, want in c.resources.requests.items():
                    if resource not in self._plugins or want <= 0:
                        continue
                    pod_alloc = self._allocated[resource].setdefault(
                        pod.metadata.uid, {})
                    if c.name in pod_alloc:  # already pinned (restart)
                        out[c.name][resource] = list(pod_alloc[c.name])
                        continue
                    plugin = self._plugins[resource]
                    busy = self._in_use(resource) | set(
                        staged.get(resource, []))
                    free = [d for d, healthy in sorted(plugin.devices.items())
                            if healthy and d not in busy]
                    if len(free) < want:
                        # roll back this pod's staged picks
                        for r, ids in staged.items():
                            pa = self._allocated[r].get(pod.metadata.uid, {})
                            for cn in list(pa):
                                pa[cn] = [i for i in pa[cn] if i not in ids]
                                if not pa[cn]:
                                    del pa[cn]
                        raise RuntimeError(
                            f"UnexpectedAdmissionError: insufficient "
                            f"{resource}: want {want}, have {len(free)}")
                    ids = free[:want]
                    pod_alloc[c.name] = ids
                    staged.setdefault(resource, []).extend(ids)
                    out[c.name][resource] = ids
            return out

    def deallocate(self, pod_uid: str):
        """Free a terminated pod's devices (podDevices cleanup on
        removal)."""
        with self._lock:
            for per_pod in self._allocated.values():
                per_pod.pop(pod_uid, None)

    def container_env(self, pod_uid: str,
                      container: str) -> Dict[str, str]:
        """GetDeviceRunContainerOptions analog: the env the runtime
        injects so the workload sees only its assigned devices."""
        with self._lock:
            shorts = [r.rsplit("/", 1)[-1] for r in self._plugins]
            ambiguous = {s for s in shorts if shorts.count(s) > 1}
            env: Dict[str, str] = {}
            for resource, per_pod in self._allocated.items():
                ids = per_pod.get(pod_uid, {}).get(container)
                if ids:
                    env[_visible_env(resource, ambiguous)] = ",".join(ids)
            return env

    def state(self) -> dict:
        """Checkpointable allocation state (podDevices.toCheckpointData
        analog) — device health/registration is NOT persisted; plugins
        re-register on restart."""
        with self._lock:
            return {r: {uid: {c: list(ids) for c, ids in per.items()}
                        for uid, per in pods.items()}
                    for r, pods in self._allocated.items()}

    def restore(self, state: dict):
        """Adopt checkpointed allocations (manager.go readCheckpoint):
        restored entries win over the empty post-restart state, so a
        running pod keeps its exact device IDs."""
        with self._lock:
            for resource, pods in (state or {}).items():
                self._allocated[resource] = {
                    uid: {c: list(ids) for c, ids in per.items()}
                    for uid, per in pods.items()}

    def pod_devices(self, pod_uid: str) -> Dict[str, Dict[str, List[str]]]:
        with self._lock:
            out: Dict[str, Dict[str, List[str]]] = {}
            for resource, per_pod in self._allocated.items():
                for cname, ids in per_pod.get(pod_uid, {}).items():
                    out.setdefault(cname, {})[resource] = list(ids)
            return out
