"""Container manager: cgroup hierarchy, QoS tiers, node allocatable.

A copy of kubernetes_tpu/kubelet/cm.py; its relative imports resolve in this
package.

The kubelet's resource-management layer (reference: pkg/kubelet/cm/ —
cgroup_manager_linux.go CRUD over the cgroup tree,
qos_container_manager_linux.go top-level Burstable/BestEffort tiers,
pod_container_manager_linux.go per-pod cgroups,
node_container_manager.go Node Allocatable = Capacity - reserved).
The hierarchy here is table-level bookkeeping (like the proxy's rule
table): a dict tree whose limits the fake runtime and eviction logic
can read, exercised by the same lifecycle the reference drives —
EnsureExists on pod sync, Destroy on termination, orphan sweep in
housekeeping.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api import resources as res
from ..api import types as api

# cpu shares bounds (cm/helpers_linux.go MilliCPUToShares:
# shares = milli * 1024 / 1000, floor MinShares=2)
MIN_SHARES = 2
SHARES_PER_CPU = 1024
MILLI_CPU_TO_CPU = 1000

ROOT = "/kubepods"
BURSTABLE = "/kubepods/burstable"
BESTEFFORT = "/kubepods/besteffort"


def milli_cpu_to_shares(milli: int) -> int:
    if milli == 0:
        return MIN_SHARES
    return max(MIN_SHARES, milli * SHARES_PER_CPU // MILLI_CPU_TO_CPU)


@dataclass
class CgroupConfig:
    """ResourceConfig (cm/types.go): the limits applied to one cgroup."""

    cpu_shares: int = MIN_SHARES
    cpu_quota_milli: Optional[int] = None  # None = unlimited
    memory_limit: Optional[int] = None     # bytes; None = unlimited
    pids: List[str] = field(default_factory=list)  # member pod uids


class CgroupManager:
    """cgroup_manager_linux.go: CRUD over an abstract cgroup tree.
    Names are /-separated paths; creating a child requires the parent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, CgroupConfig] = {}

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._groups

    def create(self, name: str, config: Optional[CgroupConfig] = None):
        with self._lock:
            parent = name.rsplit("/", 1)[0]
            if parent and parent not in self._groups:
                raise KeyError(f"parent cgroup {parent} missing for {name}")
            self._groups.setdefault(name, config or CgroupConfig())

    def update(self, name: str, config: CgroupConfig):
        with self._lock:
            if name not in self._groups:
                raise KeyError(f"cgroup {name} missing")
            self._groups[name] = config

    def destroy(self, name: str):
        """Remove a cgroup and its whole subtree (the reference's
        Destroy removes recursively after killing members)."""
        with self._lock:
            for n in [n for n in self._groups
                      if n == name or n.startswith(name + "/")]:
                del self._groups[n]

    def get(self, name: str) -> Optional[CgroupConfig]:
        with self._lock:
            return self._groups.get(name)

    def subgroups(self, name: str) -> List[str]:
        with self._lock:
            prefix = name + "/"
            return sorted(n for n in self._groups
                          if n.startswith(prefix)
                          and "/" not in n[len(prefix):])


def pod_cgroup_parent(pod: api.Pod) -> str:
    """Guaranteed pods sit directly under /kubepods; Burstable and
    BestEffort under their QoS tier (pod_container_manager_linux.go
    GetPodContainerName)."""
    qos = api.pod_qos_class(pod)
    if qos == "Guaranteed":
        return ROOT
    return BURSTABLE if qos == "Burstable" else BESTEFFORT


def pod_cgroup_name(pod: api.Pod) -> str:
    return f"{pod_cgroup_parent(pod)}/pod{pod.metadata.uid}"


def resource_config_for_pod(pod: api.Pod) -> CgroupConfig:
    """cm/helpers_linux.go ResourceConfigForPod: the pod envelope is
    max(largest init container, sum of app containers) per resource —
    inits run alone before the apps, so the cgroup must hold whichever
    phase is bigger. Shares from requests, quota/memory limit from
    limits (any container without a limit -> unlimited for the pod)."""
    req_milli = 0
    lim_milli = 0
    mem_limit = 0
    all_cpu_limited = True
    all_mem_limited = True
    for c in pod.spec.containers:
        req_milli += c.resources.requests.get(res.CPU, 0)
        cl = c.resources.limits.get(res.CPU, 0)
        ml = c.resources.limits.get(res.MEMORY, 0)
        if cl:
            lim_milli += cl
        else:
            all_cpu_limited = False
        if ml:
            mem_limit += ml
        else:
            all_mem_limited = False
    for c in pod.spec.init_containers:
        req_milli = max(req_milli, c.resources.requests.get(res.CPU, 0))
        cl = c.resources.limits.get(res.CPU, 0)
        ml = c.resources.limits.get(res.MEMORY, 0)
        if cl:
            lim_milli = max(lim_milli, cl)
        else:
            all_cpu_limited = False
        if ml:
            mem_limit = max(mem_limit, ml)
        else:
            all_mem_limited = False
    return CgroupConfig(
        cpu_shares=milli_cpu_to_shares(req_milli),
        cpu_quota_milli=lim_milli if all_cpu_limited else None,
        memory_limit=mem_limit if all_mem_limited else None,
        pids=[pod.metadata.uid])


class PodContainerManager:
    """pod_container_manager_linux.go: one cgroup per pod under its QoS
    tier."""

    def __init__(self, cgroups: CgroupManager):
        self.cgroups = cgroups

    def ensure_exists(self, pod: api.Pod):
        name = pod_cgroup_name(pod)
        if not self.cgroups.exists(name):
            self.cgroups.create(name, resource_config_for_pod(pod))
        else:
            self.cgroups.update(name, resource_config_for_pod(pod))
        return name

    def exists(self, pod: api.Pod) -> bool:
        return self.cgroups.exists(pod_cgroup_name(pod))

    def destroy(self, pod: api.Pod):
        self.cgroups.destroy(pod_cgroup_name(pod))

    def all_pod_uids(self) -> Dict[str, str]:
        """GetAllPodsFromCgroups: uid -> cgroup name, scanned from the
        tree (the orphan-sweep source of truth, NOT the pod list)."""
        out = {}
        for parent in (ROOT, BURSTABLE, BESTEFFORT):
            for sub in self.cgroups.subgroups(parent):
                leaf = sub.rsplit("/", 1)[1]
                if leaf.startswith("pod"):
                    out[leaf[3:]] = sub
        return out


class CPUManager:
    """cpumanager static policy (cm/cpumanager/policy_static.go):
    Guaranteed containers requesting WHOLE cores get CPUs carved
    exclusively out of the shared pool; everything else floats on the
    shared pool. Reserved low-numbered cores never leave the shared
    pool (the system/kubelet slice)."""

    def __init__(self, num_cpus: int, reserved: int = 0):
        self.all_cpus = list(range(num_cpus))
        self.reserved = set(range(min(reserved, num_cpus)))
        self._shared = set(self.all_cpus)
        self._lock = threading.Lock()
        # (pod_uid, container) -> exclusively assigned cpu ids
        self._assignments: Dict[Tuple[str, str], List[int]] = {}

    @staticmethod
    def guaranteed_cpus(pod: api.Pod, container: api.Container) -> int:
        """policy_static.go guaranteedCPUs: whole-core request on a
        Guaranteed pod, else 0 (shared pool)."""
        if api.pod_qos_class(pod) != api.QOS_GUARANTEED:
            return 0
        milli = container.resources.requests.get(res.CPU, 0)
        if milli == 0 or milli % MILLI_CPU_TO_CPU != 0:
            return 0
        return milli // MILLI_CPU_TO_CPU

    def add_container(self, pod: api.Pod,
                      container: api.Container) -> Optional[List[int]]:
        """AddContainer: pin exclusive CPUs (idempotent), or None for
        the shared pool. Raises when the assignable pool ran dry."""
        want = self.guaranteed_cpus(pod, container)
        if want == 0:
            return None
        key = (pod.metadata.uid, container.name)
        with self._lock:
            if key in self._assignments:
                return list(self._assignments[key])
            assignable = sorted(self._shared - self.reserved)
            if len(assignable) < want:
                raise RuntimeError(
                    f"not enough cpus available to satisfy request: "
                    f"want {want}, assignable {len(assignable)}")
            taken = assignable[:want]
            self._shared.difference_update(taken)
            self._assignments[key] = taken
            return list(taken)

    def remove_pod(self, pod_uid: str):
        """RemoveContainer for every container of a dead pod: released
        CPUs rejoin the shared pool."""
        with self._lock:
            for key in [k for k in self._assignments if k[0] == pod_uid]:
                self._shared.update(self._assignments.pop(key))

    def container_cpuset(self, pod_uid: str,
                         container: str) -> Optional[List[int]]:
        with self._lock:
            got = self._assignments.get((pod_uid, container))
            return list(got) if got is not None else None

    def shared_pool(self) -> List[int]:
        with self._lock:
            return sorted(self._shared)

    def state(self) -> dict:
        """Checkpointable assignments (cpumanager state_checkpoint)."""
        with self._lock:
            return {f"{uid}/{c}": list(cpus)
                    for (uid, c), cpus in self._assignments.items()}

    def restore(self, state: dict):
        """Rebuild assignments + the shared pool from a checkpoint —
        a restarted kubelet must not re-pin a running pod's cores."""
        with self._lock:
            self._assignments.clear()
            self._shared = set(self.all_cpus)
            for key, cpus in (state or {}).items():
                uid, _, cname = key.partition("/")
                taken = [c for c in cpus if c in self._shared]
                self._assignments[(uid, cname)] = taken
                self._shared.difference_update(taken)


class ContainerManager:
    """container_manager_linux.go + qos_container_manager_linux.go +
    node_container_manager.go rolled into the kubelet-facing facade."""

    def __init__(self, capacity: Dict[str, int],
                 system_reserved: Optional[Dict[str, int]] = None,
                 kube_reserved: Optional[Dict[str, int]] = None,
                 eviction_hard: Optional[Dict[str, int]] = None):
        self.cgroups = CgroupManager()
        self.pod_manager = PodContainerManager(self.cgroups)
        self.capacity = dict(capacity)
        self.system_reserved = dict(system_reserved or {})
        self.kube_reserved = dict(kube_reserved or {})
        self.eviction_hard = dict(eviction_hard or {})
        self._setup_node()

    # -- node allocatable (node_container_manager.go) -------------------------

    def reservation(self) -> Dict[str, int]:
        """GetNodeAllocatableReservation: system + kube reserved +
        hard-eviction thresholds, per resource."""
        out: Dict[str, int] = {}
        for src in (self.system_reserved, self.kube_reserved,
                    self.eviction_hard):
            for k, v in src.items():
                out[k] = out.get(k, 0) + v
        return out

    def allocatable(self) -> Dict[str, int]:
        """Node Allocatable = Capacity - reservation, floored at 0."""
        rsv = self.reservation()
        return {k: max(0, v - rsv.get(k, 0))
                for k, v in self.capacity.items()}

    def _setup_node(self):
        """createNodeAllocatableCgroups + setupNode: /kubepods is capped
        at Allocatable (enforceNodeAllocatableCgroups), QoS tiers below."""
        alloc = self.allocatable()
        self.cgroups.create("", CgroupConfig())  # abstract root
        self.cgroups.create(ROOT, CgroupConfig(
            cpu_shares=milli_cpu_to_shares(alloc.get(res.CPU, 0)),
            cpu_quota_milli=None,
            memory_limit=alloc.get(res.MEMORY)))
        self.cgroups.create(BURSTABLE, CgroupConfig())
        self.cgroups.create(BESTEFFORT, CgroupConfig(
            cpu_shares=MIN_SHARES))

    # -- QoS tier maintenance (qos_container_manager_linux.go) ----------------

    def update_qos_cgroups(self, active_pods: List[api.Pod]):
        """UpdateCgroups: burstable shares track the sum of burstable
        pods' cpu requests; besteffort stays at MinShares."""
        burst_milli = 0
        for p in active_pods:
            if api.pod_qos_class(p) == "Burstable":
                for c in p.spec.containers:
                    burst_milli += c.resources.requests.get(res.CPU, 0)
        cfg = self.cgroups.get(BURSTABLE) or CgroupConfig()
        cfg.cpu_shares = milli_cpu_to_shares(burst_milli)
        self.cgroups.update(BURSTABLE, cfg)

    # -- pod lifecycle ---------------------------------------------------------

    def ensure_pod_cgroup(self, pod: api.Pod) -> str:
        return self.pod_manager.ensure_exists(pod)

    def destroy_pod_cgroup(self, pod: api.Pod):
        self.pod_manager.destroy(pod)

    def cleanup_orphans(self, live_uids) -> List[str]:
        """Housekeeping sweep: destroy pod cgroups whose pod is gone
        (kubelet.go cleanupOrphanedPodCgroups)."""
        removed = []
        live = set(live_uids)
        for uid, name in self.pod_manager.all_pod_uids().items():
            if uid not in live:
                self.cgroups.destroy(name)
                removed.append(uid)
        return removed
