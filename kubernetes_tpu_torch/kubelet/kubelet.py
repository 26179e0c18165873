"""The kubelet sync loop.

A copy of kubernetes_tpu/kubelet/kubelet.py; its relative imports
resolve in this package.

Reference call stack (SURVEY.md §3.5): Kubelet.Run (kubelet.go:1317) ->
syncLoop (:1720) -> syncLoopIteration (:1787) selecting over pod config
updates, PLEG events, the 1s sync tick, probe results, and housekeeping;
HandlePodAdditions -> podWorkers -> syncPod (:1389). Here one
``sync_once(now)`` call is one syncLoopIteration over the fake runtime;
``run()`` wraps it in a ticking thread. Node-side admission re-runs the
scheduler's GeneralPredicates (pkg/kubelet/lifecycle/predicate.go — the
reason predicates live in the scheduler package but are imported by the
kubelet). Eviction under memory pressure follows pkg/kubelet/eviction/
(rank by QoS then usage; set the pressure condition the scheduler's
CheckNodeMemoryPressure predicate reads).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..api import resources as res
from ..api import types as api
from ..controllers.nodelifecycle import HEARTBEAT_ANNOTATION
from ..plugins import golden
from ..runtime.store import Conflict
from ..state.node_info import NodeInfo
from .pleg import PLEG
from .pod_workers import PodWorkers
from .runtime import EXITED, RUNNING, FakeRuntime

# crash-loop restart backoff (kuberuntime_manager.go backOff: base 10s
# doubling to 5min; forgiven after 10min of stable running)
CRASH_BACKOFF_BASE = 10.0
CRASH_BACKOFF_MAX = 300.0
CRASH_BACKOFF_RESET = 600.0


class _ProbeState:
    __slots__ = ("failures", "successes", "last_run")

    def __init__(self):
        self.failures = 0
        self.successes = 0
        self.last_run = 0.0


MIRROR_ANNOTATION = "kubernetes.io/config.mirror"
CONFIG_SOURCE_ANNOTATION = "kubernetes.io/config.source"


def ipaddress_contains(network, ip: str) -> bool:
    import ipaddress
    try:
        return ipaddress.ip_address(ip) in network
    except ValueError:
        return False


class Kubelet:
    def __init__(self, store, node_name: str,
                 allocatable: Optional[Dict[str, int]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 taints: Optional[List[api.Taint]] = None,
                 runtime: Optional[FakeRuntime] = None,
                 clock=time.time,
                 heartbeat_period: float = 10.0,
                 memory_pressure_threshold: float = 0.9,
                 resync_interval: float = 0.0,
                 async_workers: bool = False,
                 manifest_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 network_plugin=None,
                 cert_manager=None):
        """resync_interval=0 fully resyncs every pod each iteration (the
        deterministic test mode); >0 switches to event-driven syncs —
        only pods with config changes or PLEG events sync between full
        resyncs, the reference's steady-state shape."""
        self.store = store
        self.node_name = node_name
        self.clock = clock
        self.runtime = runtime or FakeRuntime()
        self.pleg = PLEG(self.runtime)
        from ..volume.manager import VolumeManager

        self.volume_manager = VolumeManager(store, node_name)
        if async_workers and not getattr(store, "async_bind_safe", False):
            # in-process ObjectStore dispatches watch events under its
            # lock: status writes from worker threads could deadlock
            # against another component's handler lock (same reasoning
            # as the scheduler's async-bind gate) — fall back to inline
            async_workers = False
        self.pod_workers = PodWorkers(self._sync_pod,
                                      async_mode=async_workers)
        self.resync_interval = resync_interval
        self._last_full_resync = -1e18
        self._known_pod_rvs: Dict[str, int] = {}
        # pods whose sync early-returned on a precondition (node not yet
        # visible, volumes not attached): re-dispatched next iteration
        # even without an event/rv change
        self._needs_retry: set = set()
        # (pod uid, container) -> current crash-backoff delay / deadline /
        # last start time (CrashLoopBackOff machinery)
        self._crash_backoff: Dict[tuple, float] = {}
        self._crash_backoff_until: Dict[tuple, float] = {}
        self._last_container_start: Dict[tuple, float] = {}
        self.heartbeat_period = heartbeat_period
        self.memory_pressure_threshold = memory_pressure_threshold
        self.allocatable = allocatable or api.resource_list(
            cpu="8", memory="16Gi", pods=110, ephemeral_storage="100Gi")
        # resource-management layer (pkg/kubelet/cm + images): cgroup
        # tree capped at allocatable, per-pod cgroups, image cache with
        # GC thresholds, dead-container GC, device plugins
        from .cm import ContainerManager, CPUManager
        from .devicemanager import DeviceManager
        from .images import (ContainerGC, ImageGCManager, ImageManager,
                             ImageStore)
        self.container_manager = ContainerManager(
            capacity=dict(self.allocatable))
        self.cpu_manager = CPUManager(
            num_cpus=self.allocatable.get(res.CPU, 0) // 1000)
        self.image_store = ImageStore()
        self.image_manager = ImageManager(self.image_store)
        self.image_gc = ImageGCManager(self.image_store, self.runtime)
        self.container_gc = ContainerGC(self.runtime)
        self.device_manager = DeviceManager()
        # every device-plugin resource this kubelet has EVER published
        # into node status: a plugin that unregisters must have its
        # resource zeroed on the next heartbeat, not merged-in forever
        self._published_device_resources: set = set()
        # checkpointing (pkg/kubelet/checkpointmanager): device/cpu
        # assignments survive a kubelet restart so running pods keep
        # their exact accelerator IDs and core pins
        # network plugin (kubelet/network.py): explicit, or resolved on
        # first use from the node's podCIDR (host-local IPAM once the
        # nodeipam controller assigned one, uid-hash addressing before)
        self.network_plugin = network_plugin
        # rotating client identity (client/certmanager.py): checked on
        # the heartbeat cadence like pkg/kubelet/certificate
        self.cert_manager = cert_manager
        self.checkpoints = None
        self._last_checkpoint: Dict[str, dict] = {}
        if checkpoint_dir:
            from .checkpoint import CheckpointManager, CorruptCheckpoint
            self.checkpoints = CheckpointManager(checkpoint_dir)
            for name, mgr in (("device_manager_state",
                               self.device_manager),
                              ("cpu_manager_state", self.cpu_manager)):
                try:
                    state = self.checkpoints.load(name)
                except CorruptCheckpoint:
                    # bad state is worse than none: start fresh, like
                    # the reference's corrupt-checkpoint recovery
                    self.checkpoints.remove(name)
                    state = None
                if state:
                    mgr.restore(state)
        self.labels = {api.LABEL_HOSTNAME: node_name, **(labels or {})}
        self.taints = list(taints or [])
        # network-partition switch (kubemark partition helper): a severed
        # kubelet freezes — no heartbeats, no status writes — exactly
        # what the nodelifecycle controller's zone disruption machinery
        # must detect and NOT storm over
        self.partitioned = False
        self._probe_state: Dict[tuple, _ProbeState] = {}
        self._pod_start: Dict[str, float] = {}
        self._pod_specs: Dict[str, api.Pod] = {}  # teardown (preStop) view
        # postStart hooks waiting for their container to reach RUNNING
        self._pending_poststart: Dict[tuple, List[str]] = {}
        self._iter_node: Optional[api.Node] = None
        self._last_heartbeat = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.server = None  # KubeletServer once serve() is called
        # static pods (pkg/kubelet/config/file.go): --pod-manifest-path
        # directory of pod manifests run independently of the apiserver,
        # surfaced there as MIRROR pods (pkg/kubelet/pod/mirror_client.go)
        self.manifest_dir = manifest_dir
        self._static_by_uid: Dict[str, api.Pod] = {}
        self.register_node()

    # -- node registration + heartbeat (kubelet_node_status.go) ----------------

    def serve(self, host: str = "127.0.0.1", port: int = 0, tls=None):
        """Start the kubelet HTTP(S) server (pkg/kubelet/server/
        server.go) and publish its port on the Node's status
        (NodeDaemonEndpoints.KubeletEndpoint) so the apiserver's
        pods/<name>/log and /exec proxies can reach it. tls: the
        cluster's pki.ClusterCA — serves mTLS and gates exec/logs to
        apiserver/admin identities (kubelet/server.py)."""
        from .server import KubeletServer

        self.server = KubeletServer(self, host=host, port=port,
                                    tls=tls).start()
        self.register_node()
        self._publish_kubelet_port()
        return self.server

    def _publish_kubelet_port(self):
        """Idempotent port publication; heartbeat() re-asserts it so a
        lost update race can't leave the endpoint unpublished."""
        if self.server is None:
            return
        for _ in range(3):
            node = self._get_node()
            if node is None or node.status.kubelet_port == self.server.port:
                return
            node.status.kubelet_port = self.server.port
            try:
                self.store.update("nodes", node)
                return
            except Conflict:
                continue  # re-read and retry against the fresh version

    def register_node(self):
        node = self._get_node()
        if node is None:
            node = api.Node(
                metadata=api.ObjectMeta(
                    name=self.node_name, labels=dict(self.labels),
                    annotations={HEARTBEAT_ANNOTATION: str(self.clock())}),
                spec=api.NodeSpec(taints=list(self.taints)),
                status=api.NodeStatus(
                    capacity=dict(self.allocatable),
                    allocatable=dict(self.allocatable),
                    conditions=[api.NodeCondition(api.NODE_READY,
                                                  api.COND_TRUE)]))
            try:
                self.store.create("nodes", node)
            except Conflict:
                pass

    def _get_node(self) -> Optional[api.Node]:
        return (self.store.get("nodes", "default", self.node_name)
                or self.store.get("nodes", "", self.node_name))

    def heartbeat(self, now: Optional[float] = None,
                  memory_pressure: Optional[bool] = None):
        """Update node status: heartbeat annotation + Ready (+ pressure)
        conditions (tryUpdateNodeStatus)."""
        from ..utils import faultpoints

        if self.partitioned or faultpoints.fire("heartbeat.deliver",
                                                payload=self.node_name):
            # severed from the control plane (partition helper) or the
            # status update was dropped on the wire (fault point): the
            # node goes stale from the controller's point of view;
            # _last_heartbeat stays put so every sync retries
            return
        now = now if now is not None else self.clock()
        if self.cert_manager is not None:
            # background: a slow signer must never stall the heartbeat
            # into NotReady
            self.cert_manager.rotate_in_background(now)
        node = self._get_node()
        if node is None:
            self.register_node()
            return
        node.metadata.annotations = dict(node.metadata.annotations or {})
        node.metadata.annotations[HEARTBEAT_ANNOTATION] = str(now)
        # device-plugin resources ride the heartbeat into node status
        # (devicemanager GetCapacity merged in kubelet_node_status.go):
        # unhealthy devices stay in capacity but leave allocatable, so
        # the scheduler stops fitting against them. Resources whose
        # plugin UNREGISTERED are zeroed — the reference's
        # GetCapacity returns them in deletedResources and
        # kubelet_node_status.go zeroes capacity/allocatable; merging
        # additively forever would let the scheduler fit pods against
        # devices that no longer exist (shrunk sets overwrite via the
        # merge itself)
        dev_cap = self.device_manager.capacity()
        # restart seeding: a fresh kubelet process starts with an empty
        # published set, but the STORED node may still advertise device
        # resources a dead plugin merged in before the restart — adopt
        # every slash-qualified resource the node carries beyond this
        # kubelet's static allocatable as previously-published, so an
        # unregistered plugin's capacity is zeroed instead of resurrected
        self._published_device_resources |= {
            r for r in (node.status.capacity or {})
            if "/" in r and r not in self.allocatable}
        gone = self._published_device_resources - set(dev_cap)
        self._published_device_resources |= set(dev_cap)
        if dev_cap or gone:
            cap = dict(node.status.capacity or {}, **dev_cap)
            alloc = dict(node.status.allocatable or {},
                         **self.device_manager.allocatable())
            for r in gone:
                cap[r] = 0
                alloc[r] = 0
            node.status.capacity = cap
            node.status.allocatable = alloc
        conds = {c.type: c for c in node.status.conditions}
        conds[api.NODE_READY] = api.NodeCondition(api.NODE_READY, api.COND_TRUE)
        if memory_pressure is not None:
            conds[api.NODE_MEMORY_PRESSURE] = api.NodeCondition(
                api.NODE_MEMORY_PRESSURE,
                api.COND_TRUE if memory_pressure else api.COND_FALSE)
        node.status.conditions = list(conds.values())
        if self.server is not None:
            # re-assert the serving port: a raced-away serve()-time
            # update would otherwise leave logs/exec unreachable forever
            node.status.kubelet_port = self.server.port
        try:
            self.store.update("nodes", node)
        except (Conflict, KeyError):
            pass
        self._last_heartbeat = now

    # -- pod views -------------------------------------------------------------

    def _my_pods(self) -> List[api.Pod]:
        # mirror pods are the apiserver's VIEW of static pods, never a
        # sync source (pod_manager.go: mirror pods map back to their
        # static pod; syncing one directly would double-run it)
        return [p for p in self.store.list("pods")
                if p.spec.node_name == self.node_name
                and MIRROR_ANNOTATION not in (p.metadata.annotations or {})]

    # -- static pods + mirror pods (config/file.go, pod/mirror_client.go) ------

    def _read_static_pods(self) -> Dict[str, api.Pod]:
        """Manifest dir -> {uid: static pod}. Name gets the -<node>
        suffix, uid derives from the file content hash — a changed file
        IS a different static pod (the reference restarts it the same
        way)."""
        import hashlib
        import os

        from ..api import scheme

        out: Dict[str, api.Pod] = {}
        if not self.manifest_dir or not os.path.isdir(self.manifest_dir):
            return out
        for fname in sorted(os.listdir(self.manifest_dir)):
            if not fname.endswith((".json", ".yaml", ".yml")):
                continue
            path = os.path.join(self.manifest_dir, fname)
            try:
                text = open(path).read()
                if text.lstrip().startswith("{"):
                    import json as _json

                    doc = _json.loads(text)
                else:
                    import yaml

                    doc = yaml.safe_load(text)
                if not doc or doc.get("kind") != "Pod":
                    continue
                pod = scheme.decode_object(doc)
            except Exception:
                continue  # a broken manifest must not kill the kubelet
            uid = "static-" + hashlib.sha1(
                (fname + text).encode()).hexdigest()[:12]
            pod.metadata.name = f"{pod.metadata.name}-{self.node_name}"
            pod.metadata.uid = uid
            pod.metadata.annotations = dict(pod.metadata.annotations or {})
            pod.metadata.annotations[CONFIG_SOURCE_ANNOTATION] = \
                f"file:{path}"
            pod.spec.node_name = self.node_name
            out[uid] = pod
        return out

    def _is_static(self, pod: api.Pod) -> bool:
        return (pod.metadata.annotations or {}).get(
            CONFIG_SOURCE_ANNOTATION, "").startswith("file:")

    def _sync_static_pods(self) -> List[api.Pod]:
        """Reconcile the manifest dir: kill containers of removed/changed
        static pods, delete their mirrors, and (re)create a mirror pod
        for each live static pod. Returns the static pods to sync."""
        current = self._read_static_pods()
        for uid, old in list(self._static_by_uid.items()):
            if uid not in current:
                self._kill_pod_with_hooks(uid, old)
                try:
                    self.store.delete("pods", old.metadata.namespace,
                                      old.metadata.name)
                except KeyError:
                    pass
                # per-uid map cleanup is housekeeping's job: it keys off
                # _pod_start entries whose uid is no longer live, so the
                # entry must SURVIVE until that sweep or the other maps
                # (_known_pod_rvs, _crash_backoff, ...) leak forever
            elif old.status.phase:
                # re-decoded manifests start with an empty status; carry
                # the accumulated one over or every full resync sees a
                # phase "change" and rewrites the mirror (spurious
                # MODIFIED events for watchers)
                current[uid].status = old.status
        self._static_by_uid = current
        for uid, pod in current.items():
            mirror = self.store.get("pods", pod.metadata.namespace,
                                    pod.metadata.name)
            want_ann = uid
            if mirror is not None and (mirror.metadata.annotations or {})\
                    .get(MIRROR_ANNOTATION) != want_ann:
                # stale mirror for an older file version (or an impostor
                # object squatting the name): replace it
                try:
                    self.store.delete("pods", mirror.metadata.namespace,
                                      mirror.metadata.name)
                except KeyError:
                    pass
                mirror = None
            if mirror is None:
                import copy

                m = copy.deepcopy(pod)
                m.metadata.uid = ""  # store assigns its own
                m.metadata.resource_version = 0
                m.metadata.annotations[MIRROR_ANNOTATION] = want_ann
                try:
                    self.store.create("pods", m)
                except Exception:
                    pass  # racing another component: next sync retries
        return list(current.values())

    # -- admission (lifecycle/predicate.go canAdmitPod) ------------------------

    # critical pods: the annotation (pre-priority marker) or a priority
    # at/above system-cluster-critical (kubelet/types/pod_update.go
    # IsCriticalPod)
    CRITICAL_ANNOTATION = "scheduler.alpha.kubernetes.io/critical-pod"
    CRITICAL_PRIORITY = 2_000_000_000

    def _is_critical(self, pod: api.Pod) -> bool:
        return (self.CRITICAL_ANNOTATION in (pod.metadata.annotations or {})
                or api.pod_priority(pod) >= self.CRITICAL_PRIORITY)

    def _admit(self, pod: api.Pod, active: List[api.Pod]) -> (bool, str):
        node = self._iter_node or self._get_node()
        if node is None:
            # node object not visible yet (informer lag right after
            # registration): admit later, keep the pod Pending
            return False, "NodeNotVisible"
        ni = NodeInfo(node)
        for other in active:
            if other.metadata.uid != pod.metadata.uid:
                ni.add_pod(other)
        ok, reasons = golden.general_predicates(pod, ni)
        if not ok and self._is_critical(pod):
            # CriticalPodAdmissionHandler (kubelet/preemption/
            # preemption.go HandleAdmissionFailure): evict enough
            # lower-priority pods for the critical pod to fit, lowest
            # priority + cheapest QoS first; retry admission next sync
            if self._evict_for_critical(pod, active):
                return False, "WaitingForPreemption"
        return ok, (reasons[0] if reasons else "")

    def _evict_for_critical(self, pod: api.Pod,
                            active: List[api.Pod]) -> bool:
        """Evict the minimal prefix of non-critical victims (sorted by
        priority, then QoS) that lets the critical pod pass admission.
        Returns True when evictions were made (caller retries)."""
        node = self._iter_node or self._get_node()
        qos_rank = {api.QOS_BEST_EFFORT: 0, api.QOS_BURSTABLE: 1,
                    api.QOS_GUARANTEED: 2}
        victims = sorted(
            (p for p in active
             if p.metadata.uid != pod.metadata.uid
             and not self._is_critical(p)),
            key=lambda p: (api.pod_priority(p),
                           qos_rank[api.pod_qos_class(p)]))
        def fits_without(excluded_uids) -> bool:
            ni = NodeInfo(node)
            for other in active:
                if other.metadata.uid != pod.metadata.uid and \
                        other.metadata.uid not in excluded_uids:
                    ni.add_pod(other)
            ok, _ = golden.general_predicates(pod, ni)
            return ok

        evicted = []
        for victim in victims:
            evicted.append(victim)
            if fits_without({v.metadata.uid for v in evicted}):
                break
        else:
            return False  # even evicting everything would not fit
        # minimal-victim pruning (getPodsToPreempt): drop any victim
        # whose eviction is not actually needed — e.g. low-priority
        # pods swept up before the one holding the conflicting hostPort
        for v in sorted(evicted, key=lambda p: -api.pod_priority(p)):
            rest = {x.metadata.uid for x in evicted
                    if x.metadata.uid != v.metadata.uid}
            if fits_without(rest):
                evicted = [x for x in evicted
                           if x.metadata.uid != v.metadata.uid]
        for v in evicted:
            v.status.phase = "Failed"
            v.status.conditions = [("Ready", "False:Preempted")]
            self._update_status(v)
            self._kill_pod_with_hooks(v.metadata.uid, v)
        return True

    # -- the sync loop ---------------------------------------------------------

    def sync_once(self, now: Optional[float] = None) -> None:
        """One syncLoopIteration (kubelet.go:1787): select over config
        updates (pod spec changes seen via resourceVersion), PLEG events
        (runtime state transitions), and the periodic full resync; then
        probes, eviction housekeeping, heartbeat. Pod syncs dispatch
        through the per-pod workers."""
        if self.partitioned:
            # fully severed: no API traffic of any kind until healed
            return
        now = now if now is not None else self.clock()
        self.runtime.tick(now)
        self._iter_node = self._get_node()  # one node fetch per iteration
        pods = self._my_pods()
        if self.manifest_dir:
            pods = self._sync_static_pods() + pods
        active = [p for p in pods
                  if p.status.phase in ("", "Pending", "Running")]
        pleg_events = self.pleg.relist()
        full = (self.resync_interval <= 0
                or now - self._last_full_resync >= self.resync_interval)
        if full:
            to_sync = pods
            self._last_full_resync = now
        else:
            dirty = {e.pod_uid for e in pleg_events} | set(self._needs_retry)
            to_sync = []
            for p in pods:
                rv = p.metadata.resource_version
                if (p.metadata.uid in dirty
                        or self._known_pod_rvs.get(p.metadata.uid) != rv
                        or self._has_probes(p)):
                    # probed pods sync every iteration: health bits flip
                    # without a state transition or rv change (the
                    # reference runs probes in their own worker loop)
                    to_sync.append(p)
        for pod in to_sync:
            self._known_pod_rvs[pod.metadata.uid] = \
                pod.metadata.resource_version
            self.pod_workers.update_pod(pod, now, active)
        self._housekeeping(now)
        if now - self._last_heartbeat >= self.heartbeat_period:
            self.heartbeat(now, memory_pressure=self._memory_pressure())
        self._iter_node = None

    @staticmethod
    def _has_probes(pod: api.Pod) -> bool:
        return any(c.liveness_probe is not None
                   or c.readiness_probe is not None
                   for c in pod.spec.containers)

    def _sync_pod(self, pod: api.Pod, now: float, active: List[api.Pod]):
        """syncPod (kubelet.go:1389): admit, start containers, compute
        phase/readiness from runtime state, apply restart policy."""
        uid = pod.metadata.uid
        # the terminating branch runs BEFORE the terminal-phase return:
        # a marked pod that turned Failed (eviction, deadline) must
        # still be reaped or the delete never completes
        if pod.metadata.deletion_timestamp is not None and \
                not self._is_static(pod):
            # graceful termination (kubelet.go syncPod's terminating
            # branch): preStop hooks run, containers stop, then the
            # kubelet confirms by removing the API object (the
            # status-manager force-delete). Finalizer-bearing pods are
            # left to the finalizer machinery.
            self._kill_pod_with_hooks(uid, pod)
            if not pod.metadata.finalizers:
                try:
                    self.store.delete("pods", pod.metadata.namespace,
                                      pod.metadata.name)
                except KeyError:
                    pass
            return
        if pod.status.phase in ("Succeeded", "Failed"):
            return
        self._needs_retry.discard(uid)
        if uid not in self._pod_start:
            ok, reason = self._admit(pod, active)
            if not ok and reason in ("NodeNotVisible",
                                     "WaitingForPreemption"):
                # transient: retry next sync without failing the pod
                # (WaitingForPreemption: victims were just evicted for
                # this critical pod; next sync admits it)
                self._needs_retry.add(uid)
                return
            if not ok:
                pod.status.phase = "Failed"
                pod.status.conditions = [("PodScheduled", "True"),
                                         ("Ready", f"False:{reason}")]
                self._update_status(pod)
                return
            # device admission (cm/devicemanager): pin concrete device
            # IDs for extended-resource requests; devices gone unhealthy
            # since the scheduler counted them fail the pod here, like
            # the reference's UnexpectedAdmissionError
            try:
                self.device_manager.allocate(pod)
            except RuntimeError:
                pod.status.phase = "Failed"
                pod.status.conditions = [
                    ("PodScheduled", "True"),
                    ("Ready", "False:UnexpectedAdmissionError")]
                self._update_status(pod)
                return
            self._pod_start[uid] = now
        if not self._volumes_ready(pod):
            # volume manager (pkg/kubelet/volumemanager/):
            # WaitForAttachAndMount — containers must not start until the
            # attach/detach controller reports the pod's PVs attached to
            # this node; retried on later syncs
            self._needs_retry.add(uid)
            return
        if (pod.spec.active_deadline_seconds is not None
                and uid in self._pod_start
                and now - self._pod_start[uid]
                >= pod.spec.active_deadline_seconds):
            # kubelet/active_deadline.go: the pod's wall-clock budget is
            # spent — kill it (preStop runs first) and mark
            # Failed/DeadlineExceeded
            self._kill_pod_with_hooks(uid, pod)
            pod.status.phase = "Failed"
            pod.status.conditions = [("PodScheduled", "True"),
                                     ("Ready", "False:DeadlineExceeded")]
            self._update_status(pod)
            return
        if not self._init_containers_done(pod, now):
            return
        # remembered for teardown: preStop hooks need the spec after the
        # pod object left the apiserver
        self._pod_specs[uid] = pod
        # pod networking (network/plugins.go SetUpPod): the CNI-style
        # plugin hands the pod its address, surfaced as status.podIP
        if not pod.status.pod_ip:
            try:
                pod.status.pod_ip = self._net_plugin().setup_pod(uid)
            except RuntimeError:
                # CIDR exhausted: pod stays Pending without an address,
                # retried as addresses free up
                self._needs_retry.add(uid)
                return
        # per-pod cgroup under the QoS tier (pod_container_manager
        # EnsureExists) — created before any container starts
        self.container_manager.ensure_pod_cgroup(pod)
        for c in pod.spec.containers:
            st = self.runtime.get(uid, c.name)
            if st is None or st.state not in (RUNNING,):
                if st is not None and st.state == EXITED:
                    # restart policy (kuberuntime computePodActions)
                    if pod.spec.restart_policy == "Never" or (
                            pod.spec.restart_policy == "OnFailure"
                            and st.exit_code == 0):
                        continue
                    # crash-loop backoff (kuberuntime_manager.go
                    # doBackOff over the shared image/crash backoff:
                    # 10s doubling to 5min): a crashing container waits
                    # out its window instead of hot-looping restarts;
                    # the window resets after a stable run
                    key = (uid, c.name)
                    until = self._crash_backoff_until.get(key, 0.0)
                    if now < until:
                        self._needs_retry.add(uid)
                        continue
                    delay = self._crash_backoff.get(key, 0.0)
                    started = self._last_container_start.get(key)
                    # forgiveness keys off the RUN duration (start ->
                    # exit), not wall time since start: minutes spent
                    # sitting exited in a backoff window are not
                    # stability
                    ended = (st.finished_at if st.finished_at is not None
                             else now)
                    if started is not None and \
                            ended - started > CRASH_BACKOFF_RESET:
                        delay = 0.0  # ran stably: forgive history
                    delay = min(max(delay * 2, CRASH_BACKOFF_BASE),
                                CRASH_BACKOFF_MAX)
                    self._crash_backoff[key] = delay
                    self._crash_backoff_until[key] = now + delay
                    st.restart_count += 1
                # image pull policy (images/image_manager.go
                # EnsureImageExists): Never + absent keeps the
                # container waiting (ErrImageNeverPull), retried in
                # case the image appears (side-loaded) later
                pulled, _msg = self.image_manager.ensure_image_exists(
                    c, now)
                if not pulled:
                    self._needs_retry.add(uid)
                    continue
                self._last_container_start[(uid, c.name)] = now
                env = dict(c.env or {})
                # assigned device IDs reach the workload as env
                # (devicemanager GetDeviceRunContainerOptions)
                env.update(self.device_manager.container_env(uid, c.name))
                # cpumanager static policy: whole-core Guaranteed
                # containers get exclusive CPUs "written to the cpuset
                # cgroup" (the container state here)
                try:
                    cpus = self.cpu_manager.add_container(pod, c)
                except RuntimeError:
                    self._needs_retry.add(uid)
                    continue
                self.runtime.start_container(uid, c.name, now,
                                             env=env, image=c.image)
                st2 = self.runtime.get(uid, c.name)
                if st2 is not None and cpus is not None:
                    st2.cpuset = cpus
                rp = c.readiness_probe
                if st2 is not None and rp is not None and \
                        (rp.exec_command or rp.tcp_port):
                    # a probed container starts NOT ready until its
                    # handler passes (prober: initial result failure)
                    st2.ready = False
                # postStart hook (kuberuntime_container.go:165): fires
                # once the container is actually RUNNING — with start
                # latency that transition lands on a LATER sync, so the
                # hook is queued and run by _fire_post_start
                if c.lifecycle and c.lifecycle.post_start:
                    self._pending_poststart[(uid, c.name)] = \
                        c.lifecycle.post_start.command
                self._fire_post_start(uid, c.name, now)
            else:
                self._fire_post_start(uid, c.name, now)
        self._run_probes(pod, now)
        self._update_pod_status(pod, now)

    def _fire_post_start(self, uid: str, cname: str, now: float):
        """Run a queued postStart hook once its container reached
        RUNNING; failure kills the container (FailedPostStartHook) and
        the restart policy takes it from there."""
        key = (uid, cname)
        cmd = self._pending_poststart.get(key)
        if cmd is None:
            return
        st = self.runtime.get(uid, cname)
        if st is None or st.state != RUNNING:
            return  # still starting: retry on a later sync
        del self._pending_poststart[key]
        rc, _out = self.runtime.exec_in_container(uid, cname, cmd)
        if rc != 0:
            self.runtime.crash_container(uid, cname, exit_code=rc, now=now)
            self.runtime.append_log(uid, cname, "FailedPostStartHook")

    def _volumes_ready(self, pod: api.Pod) -> bool:
        """All of the pod's volumes mounted (volume manager gate:
        volumemanager/volume_manager.go:371 WaitForAttachAndMount)?
        Attachable volumes additionally wait for the attach/detach
        controller's node.status.volumesAttached write. Unbound PVCs
        keep the pod gated exactly like the pre-plugin-layer check."""
        if not pod.spec.volumes:
            return True
        claims = [v.pvc_name for v in pod.spec.volumes if v.pvc_name]
        for cname in claims:
            pvc = self.store.get("persistentvolumeclaims", pod.namespace,
                                 cname)
            if pvc is None or not pvc.spec.volume_name:
                return False
        node = self._iter_node or self._get_node()
        return self.volume_manager.volumes_ready(pod, node)

    def _probe_result(self, uid: str, c: api.Container, st,
                      probe: api.Probe) -> bool:
        """One probe execution (pkg/probe handler precedence): exec
        command through the runtime's interpreter, tcpSocket against
        the pod's listeners, else the runtime's injectable health bit."""
        if probe.exec_command:
            rc, _out = self.runtime.exec_in_container(
                uid, c.name, probe.exec_command)
            return rc == 0
        if probe.tcp_port:
            return self.runtime.pod_server(uid, probe.tcp_port) is not None
        return st.healthy

    def _run_probes(self, pod: api.Pod, now: float):
        """prober/worker.go probe loop: liveness kills on sustained
        failure; readiness flips the runtime ready bit that feeds the
        Ready condition and endpoints."""
        uid = pod.metadata.uid
        started = self._pod_start.get(uid, now)
        for c in pod.spec.containers:
            st = self.runtime.get(uid, c.name)
            if st is None or st.state != RUNNING:
                continue
            rprobe = c.readiness_probe
            if rprobe is not None and (rprobe.exec_command
                                       or rprobe.tcp_port):
                # readiness honors the same cadence/threshold contract
                # as liveness (prober/worker.go): period-gated, and
                # only failureThreshold consecutive failures (resp.
                # successThreshold successes) flip the bit
                rs = self._probe_state.setdefault(
                    (uid, c.name, "readiness"), _ProbeState())
                if now - started >= rprobe.initial_delay_seconds and \
                        now - rs.last_run >= rprobe.period_seconds:
                    rs.last_run = now
                    if self._probe_result(uid, c, st, rprobe):
                        rs.failures = 0
                        rs.successes += 1
                        if rs.successes >= rprobe.success_threshold:
                            st.ready = True
                    else:
                        rs.successes = 0
                        rs.failures += 1
                        if rs.failures >= rprobe.failure_threshold:
                            st.ready = False
            probe = c.liveness_probe
            if probe is None:
                continue
            ps = self._probe_state.setdefault((uid, c.name), _ProbeState())
            if now - started < probe.initial_delay_seconds:
                continue
            if now - ps.last_run < probe.period_seconds:
                continue
            ps.last_run = now
            if self._probe_result(uid, c, st, probe):
                ps.failures = 0
            else:
                ps.failures += 1
                if ps.failures >= probe.failure_threshold:
                    # liveness failure: kill + restart per policy
                    self.runtime.crash_container(uid, c.name, exit_code=137)
                    ps.failures = 0

    def _init_containers_done(self, pod: api.Pod, now: float) -> bool:
        """Run init containers SEQUENTIALLY to completion before any app
        container starts (kuberuntime computePodActions: the next init
        starts only after the previous exited 0; a failure restarts per
        policy with the shared crash backoff, or fails the pod under
        restartPolicy Never). Returns True when all inits have
        succeeded."""
        inits = pod.spec.init_containers
        if not inits:
            return True
        uid = pod.metadata.uid
        done = 0
        for c in inits:
            st = self.runtime.get(uid, c.name)
            if st is not None and st.state == EXITED and st.exit_code == 0:
                done += 1
                continue
            if st is None or st.state == EXITED:
                if st is not None and st.state == EXITED:
                    # failed init: restartPolicy Never fails the pod
                    # outright (kuberuntime: init failure is terminal
                    # under Never); otherwise crash-backoff then rerun
                    if pod.spec.restart_policy == "Never":
                        pod.status.phase = "Failed"
                        pod.status.conditions = [
                            ("PodScheduled", "True"),
                            ("Initialized",
                             f"False:Init:Error:{c.name}"),
                            ("Ready", "False")]
                        self._update_status(pod)
                        return False
                    key = (uid, c.name)
                    until = self._crash_backoff_until.get(key, 0.0)
                    if now < until:
                        self._needs_retry.add(uid)
                        break
                    delay = min(max(
                        self._crash_backoff.get(key, 0.0) * 2,
                        CRASH_BACKOFF_BASE), CRASH_BACKOFF_MAX)
                    self._crash_backoff[key] = delay
                    self._crash_backoff_until[key] = now + delay
                    st.restart_count += 1
                self._last_container_start[(uid, c.name)] = now
                self.runtime.start_container(
                    uid, c.name, now, env=dict(c.env or {}),
                    run_to_completion=True,
                    command=list(c.command or []))
            # running (or just started): wait for it — next tick exits it
            self._needs_retry.add(uid)
            break
        if done == len(inits):
            return True
        pod.status.phase = "Pending"
        conds = [("PodScheduled", "True"),
                 ("Initialized", f"False:Init:{done}/{len(inits)}"),
                 ("Ready", "False")]
        if conds != pod.status.conditions:
            pod.status.conditions = conds
            self._update_status(pod)
        return False

    def _update_pod_status(self, pod: api.Pod, now: float):
        uid = pod.metadata.uid
        states = [self.runtime.get(uid, c.name) for c in pod.spec.containers]
        if not states:
            return
        all_running = all(s is not None and s.state == RUNNING for s in states)
        all_exited = all(s is not None and s.state == EXITED for s in states)
        phase = pod.status.phase
        if all_exited and pod.spec.restart_policy in ("Never", "OnFailure"):
            ok = all(s.exit_code == 0 for s in states)
            if pod.spec.restart_policy == "OnFailure" and not ok:
                phase = "Running"  # will restart
            else:
                phase = "Succeeded" if ok else "Failed"
        elif all_running:
            phase = "Running"
        ready = all_running and all(
            s.ready for s in states) and phase == "Running"
        readiness_gate = all(
            self.runtime.get(uid, c.name).ready
            for c in pod.spec.containers
            if c.readiness_probe is not None
            and self.runtime.get(uid, c.name) is not None)
        ready = ready and readiness_gate
        new_conds = [("PodScheduled", "True"),
                     ("Initialized", "True"),  # app syncs run post-init
                     ("Ready", "True" if ready else "False")]
        qos = api.pod_qos_class(pod)
        if (phase != pod.status.phase or new_conds != pod.status.conditions
                or qos != pod.status.qos_class):
            pod.status.phase = phase
            pod.status.conditions = new_conds
            pod.status.qos_class = qos
            if pod.status.start_time is None:
                pod.status.start_time = self._pod_start.get(uid, now)
            self._update_status(pod)

    def _update_status(self, pod: api.Pod):
        """status/status_manager.go syncPod: PATCH status to the
        apiserver. A static pod's status lands on its MIRROR pod — the
        apiserver-visible stand-in (status_manager.go syncPod resolves
        the mirror uid the same way)."""
        if self._is_static(pod):
            mirror = self.store.get("pods", pod.metadata.namespace,
                                    pod.metadata.name)
            if mirror is not None and (mirror.metadata.annotations or {})\
                    .get(MIRROR_ANNOTATION) == pod.metadata.uid:
                mirror.status = pod.status
                try:
                    self.store.update("pods", mirror)
                except (Conflict, KeyError):
                    pass
            return
        try:
            self.store.update("pods", pod)
        except (Conflict, KeyError):
            pass

    # -- eviction manager (pkg/kubelet/eviction/) ------------------------------

    def _memory_requested(self) -> int:
        # static pods count too (they're absent from the store and their
        # mirrors are filtered): admission and pressure accounting must
        # see the same pod set
        total = 0
        for p in list(self._my_pods()) + list(self._static_by_uid.values()):
            if p.status.phase in ("", "Pending", "Running"):
                total += api.get_resource_request(p).get(res.MEMORY, 0)
        return total

    def _memory_pressure(self) -> bool:
        alloc = self.allocatable.get(res.MEMORY, 0)
        return alloc > 0 and \
            self._memory_requested() > self.memory_pressure_threshold * alloc

    def _net_plugin(self):
        """Resolve the network plugin: host-local IPAM over the node's
        podCIDR when the nodeipam controller assigned one, uid-hash
        addressing before it arrives (the hash fallback UPGRADES to
        host-local once the CIDR lands — a startup race must not pin the
        node to unmanaged addressing forever). On construction the IPAM
        re-reserves every live pod's status.podIP, so a kubelet restart
        never double-assigns a running pod's address."""
        from .network import HashIPPlugin, HostLocalIPAM

        if self.network_plugin is None or \
                isinstance(self.network_plugin, HashIPPlugin):
            node = self._iter_node or self._get_node()
            cidr = node.spec.pod_cidr if node is not None else ""
            if cidr:
                ipam = HostLocalIPAM(cidr)
                for p in self._my_pods():
                    ip = p.status.pod_ip
                    if ip and ipaddress_contains(ipam.network, ip):
                        ipam.reserve(p.metadata.uid, ip)
                self.network_plugin = ipam
            elif self.network_plugin is None:
                self.network_plugin = HashIPPlugin()
        return self.network_plugin

    def _kill_pod_with_hooks(self, uid: str,
                             pod: Optional[api.Pod] = None):
        """Every kubelet-initiated kill path (teardown, eviction,
        activeDeadline) runs preStop hooks against the still-running
        containers first (kuberuntime killContainersWithSyncResult ->
        executePreStopHook), then kills the pod."""
        spec_pod = pod or self._pod_specs.get(uid)
        self._pod_specs.pop(uid, None)
        if spec_pod is not None:
            for c in spec_pod.spec.containers:
                if c.lifecycle and c.lifecycle.pre_stop:
                    self.runtime.exec_in_container(
                        uid, c.name, c.lifecycle.pre_stop.command)
                self._pending_poststart.pop((uid, c.name), None)
        self.runtime.kill_pod(uid)
        self._net_plugin().teardown_pod(uid)

    def _housekeeping(self, now: float):
        # clean up runtime state for pods that vanished from the
        # apiserver — static pods live under their FILE-derived uid,
        # which never appears in the store (only their mirror does), so
        # they must be counted as live here or housekeeping would kill
        # every static pod one iteration after it starts
        live_uids = ({p.metadata.uid for p in self._my_pods()}
                     | set(self._static_by_uid))
        # snapshot first: async pod workers may insert into _pod_start
        # concurrently (plain membership iteration would RuntimeError)
        for uid in [u for u in list(self._pod_start) if u not in live_uids]:
            self._kill_pod_with_hooks(uid)
            self.cpu_manager.remove_pod(uid)
            self._pod_start.pop(uid, None)
            self._known_pod_rvs.pop(uid, None)
            self._needs_retry.discard(uid)
            self.pod_workers.forget(uid)
            # crash-backoff + probe state dies with the pod (fresh uids
            # from churn would otherwise grow these maps without bound)
            for d in (self._crash_backoff, self._crash_backoff_until,
                      self._last_container_start, self._probe_state):
                for key in [k for k in d if k[0] == uid]:
                    d.pop(key, None)
            # volume manager: drop desired state; the next reconcile
            # unmounts the orphaned mounts (reconciler.go:166)
            self.volume_manager.forget_pod(uid)
            # devices return to the pool with the pod
            self.device_manager.deallocate(uid)
        self.volume_manager.reconcile(self._iter_node or self._get_node())
        # node-side filesystem resize (operation_executor
        # MarkVolumeAsResized): claims mounted by this node's pods that
        # carry FileSystemResizePending get their new size granted here
        from ..controllers.expand import FS_RESIZE_PENDING, finish_resize
        for p in self._my_pods():
            if p.status.phase not in ("Pending", "Running"):
                continue
            for v in p.spec.volumes:
                pvc_name = getattr(v, "pvc_name", "")
                if not pvc_name:
                    continue
                pvc = self.store.get("persistentvolumeclaims",
                                     p.metadata.namespace, pvc_name)
                if pvc is not None and any(
                        c[0] == FS_RESIZE_PENDING and
                        c[1].startswith("True")
                        for c in pvc.status.conditions):
                    finish_resize(self.store, pvc)
        # resource-management housekeeping: reap dead containers beyond
        # the GC policy, reclaim image disk past the high threshold,
        # sweep pod cgroups whose pod is gone, retune the Burstable tier
        self.container_gc.garbage_collect(now)
        self.image_gc.garbage_collect()
        for uid in self.container_manager.cleanup_orphans(live_uids):
            self.device_manager.deallocate(uid)
        # stale-state reconcile (devicemanager RemoveStaleState): a pod
        # deleted while the kubelet was down leaves checkpoint-restored
        # device/CPU allocations with no live pod — release them, or the
        # accelerators leak forever
        for uid in {u for r in self.device_manager.state().values()
                    for u in r} - live_uids:
            self.device_manager.deallocate(uid)
        for uid in {k.split("/", 1)[0]
                    for k in self.cpu_manager.state()} - live_uids:
            self.cpu_manager.remove_pod(uid)
        self.container_manager.update_qos_cgroups(
            [p for p in (list(self._my_pods())
                         + list(self._static_by_uid.values()))
             if p.status.phase in ("Pending", "Running")])
        if self.checkpoints is not None:
            # write only on change — steady-state housekeeping must not
            # rewrite identical checkpoint files every iteration
            dev_state = self.device_manager.state()
            cpu_state = self.cpu_manager.state()
            if dev_state != self._last_checkpoint.get("device"):
                self.checkpoints.save("device_manager_state", dev_state)
                self._last_checkpoint["device"] = dev_state
            if cpu_state != self._last_checkpoint.get("cpu"):
                self.checkpoints.save("cpu_manager_state", cpu_state)
                self._last_checkpoint["cpu"] = cpu_state
        # eviction: under memory pressure, rank by QoS class (BestEffort
        # -> Burstable -> Guaranteed), then priority, then memory
        # footprint (eviction/helpers.go rankMemoryPressure)
        if not self._memory_pressure():
            return
        qos_rank = {api.QOS_BEST_EFFORT: 0, api.QOS_BURSTABLE: 1,
                    api.QOS_GUARANTEED: 2}
        candidates = sorted(
            (p for p in (list(self._my_pods())
                         + list(self._static_by_uid.values()))
             if p.status.phase in ("Pending", "Running")),
            key=lambda p: (qos_rank[api.pod_qos_class(p)],
                           api.pod_priority(p),
                           -api.get_resource_request(p).get(res.MEMORY, 0)))
        for victim in candidates:
            if not self._memory_pressure():
                break
            victim.status.phase = "Failed"
            victim.status.conditions = [("Ready", "False:Evicted")]
            self._update_status(victim)
            self._kill_pod_with_hooks(victim.metadata.uid, victim)
        self.heartbeat(now, memory_pressure=self._memory_pressure())

    # -- background mode -------------------------------------------------------

    def run(self, period: float = 1.0):
        def loop():
            while not self._stop.is_set():
                try:
                    self.sync_once()
                except Exception:
                    # a sync failure must not kill the node agent; the next
                    # iteration retries (syncLoop's crash-only resilience)
                    pass
                self._stop.wait(period)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"kubelet-{self.node_name}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self.server is not None:
            self.server.stop()
        self.pod_workers.stop()
