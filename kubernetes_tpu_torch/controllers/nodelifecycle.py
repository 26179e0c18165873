"""Node lifecycle: the cluster's zone-aware failure detector.

Reference: pkg/controller/nodelifecycle/node_lifecycle_controller.go —
monitorNodeStatus (:544) watches kubelet heartbeats (NodeStatus
conditions + lastHeartbeatTime); after grace period the node's Ready
condition is set to Unknown, NoExecute taints are applied
(not-ready/unreachable, :473 via the taint manager), and pods are
evicted once their tolerationSeconds expire (scheduler/taint-manager
NoExecuteTaintManager). Recovery removes the taints when heartbeats
resume.

Correlated failure is where a naive detector destroys a cluster: a rack
switch flap or a control-plane partition makes EVERY node in a failure
domain miss heartbeats at once, and hard-deleting every resident pod in
one monitor pass is the eviction storm the reference's zone machinery
(ComputeZoneState + per-zone RateLimitedTimedQueue) exists to prevent.
This controller implements that machinery:

  * Nodes bucket into failure domains by zone label (GetZoneKey; ids
    interned through the same zone interner the scheduling snapshot
    uses, so the two views agree on domain identity).
  * Each monitor pass computes a per-zone health state — Normal /
    PartialDisruption / FullDisruption — with the ready/not-ready tally
    done as ONE batched reduction over dense condition columns
    (ops/zonehealth.py), on the device path when it is healthy and on
    the host when the circuit breaker (sched/breaker.py) says it isn't.
  * Evictions drain through per-zone token buckets
    (utils/ratelimit.py) instead of firing immediately:
      Normal             -> primary rate (eviction_rate_qps)
      PartialDisruption  -> secondary rate in large zones
                            (> large_cluster_threshold nodes),
                            HALTED (qps 0) in small ones — losing most
                            of a small zone is indistinguishable from
                            losing our link to it
      FullDisruption     -> eviction SUSPENDED entirely: when 100% of a
                            zone stops heartbeating the failure is
                            presumed to be ours (partition), not the
                            nodes'; queued evictions wait until
                            heartbeats resume, at which point recovery
                            clears the taints and cancels them.
    Divergence from the reference, by design: 1.11 only suspends when
    ALL zones are fully disrupted (master-disruption mode) and evicts a
    single dead zone at the primary rate; here suspension is per-zone —
    stricter storm control for the multi-pod TPU workloads this
    scheduler carries (a re-placed 256-chip gang is far more expensive
    than a delayed eviction).

Transitions, evictions, and suspensions are emitted as events
(client/record.py) and exported as node_lifecycle_zone_health
{zone,state} gauges plus eviction / queue-depth series.

Heartbeats arrive as node status updates: kubelet sets annotation
'heartbeat' = str(epoch seconds) and Ready=True (the analog of
LastHeartbeatTime on NodeCondition).

A copy of kubernetes_tpu/controllers/nodelifecycle.py whose zone tally
runs on `device` (the CUDA card unless the caller passes another; a
Scheduler's device when the controller shares its store). Its fault
points are the reference's: `nodelifecycle.tally` (ops/zonehealth.py)
and `nodelifecycle.evict`, after the zone rate limiter admitted an
eviction and before the pod delete.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..api import types as api
from ..client.record import EventRecorder
from ..ops import encoding as enc
from ..ops import zonehealth
from ..runtime.store import Conflict
from ..state.vocab import Interner, VocabSet, bucket_size
from ..utils import faultpoints
from ..utils.metrics import Metrics
from ..utils.ratelimit import TokenBucket
from .base import Controller, is_pod_active

TAINT_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"
HEARTBEAT_ANNOTATION = "heartbeat"

# per-zone health states (node_lifecycle_controller.go ZoneState)
ZONE_NORMAL = "Normal"
ZONE_PARTIAL = "PartialDisruption"
ZONE_FULL = "FullDisruption"
ZONE_STATES = (ZONE_NORMAL, ZONE_PARTIAL, ZONE_FULL)


def _heartbeat(node: api.Node) -> Optional[float]:
    v = (node.metadata.annotations or {}).get(HEARTBEAT_ANNOTATION)
    try:
        return float(v) if v is not None else None
    except ValueError:
        return None


def _ready_status(node: api.Node) -> str:
    for c in node.status.conditions:
        if c.type == api.NODE_READY:
            return c.status
    return api.COND_UNKNOWN


def zone_display(zone_key: str) -> str:
    """GetZoneKey strings join region/zone with a NUL separator; events
    and metric labels need a printable form."""
    return zone_key.replace(":\x00:", "/").strip("/") or "unzoned"


class _Zone:
    """Synthetic involvedObject for zone-scoped events (a failure domain
    has no API object of its own)."""

    def __init__(self, name: str):
        self.metadata = api.ObjectMeta(name=name, namespace="default")


_Zone.__name__ = "Zone"


class NodeLifecycleController(Controller):
    name = "nodelifecycle"

    def __init__(self, store, clock=time.time,
                 grace_period: float = 40.0,
                 eviction_wait: float = 300.0,
                 eviction_rate_qps: float = 0.1,
                 secondary_eviction_rate_qps: float = 0.01,
                 eviction_burst: float = 10.0,
                 large_cluster_threshold: int = 50,
                 unhealthy_zone_threshold: float = 0.55,
                 vocabs: Optional[VocabSet] = None,
                 breaker=None,
                 metrics: Optional[Metrics] = None,
                 device=None):
        super().__init__(store)
        # the zone tally's device: None means the CUDA card, and raises
        # where there is none (enc.resolve_device)
        self.device = enc.resolve_device(device)
        self.clock = clock
        self.grace_period = grace_period
        self.default_eviction_wait = eviction_wait
        # storm-control knobs (kube-controller-manager --node-eviction-rate,
        # --secondary-node-eviction-rate, --large-cluster-size-threshold,
        # --unhealthy-zone-threshold)
        self.eviction_rate_qps = eviction_rate_qps
        self.secondary_eviction_rate_qps = secondary_eviction_rate_qps
        self.eviction_burst = eviction_burst
        self.large_cluster_threshold = large_cluster_threshold
        self.unhealthy_zone_threshold = unhealthy_zone_threshold
        # the zone interner: shared with the scheduling snapshot when a
        # VocabSet is passed, so domain ids agree across components
        self.zones: Interner = vocabs.zones if vocabs is not None \
            else Interner()
        self.breaker = breaker  # device-path circuit breaker (optional)
        self.metrics = metrics if metrics is not None else Metrics()
        self.recorder = EventRecorder(store, "node-controller", clock=clock)
        self.informer("nodes")
        # taint-expiry bookkeeping: pod key -> (eviction deadline, node)
        self._evict_at: Dict[str, tuple] = {}
        # zone key -> state / token bucket / node count, refreshed per pass
        self.zone_states: Dict[str, str] = {}
        self._zone_buckets: Dict[str, TokenBucket] = {}
        self._zone_size: Dict[str, int] = {}
        self._node_zone: Dict[str, str] = {}
        self.evictions = 0  # total pods evicted (cumulative)
        self._timer: Optional[threading.Thread] = None

    def configure(self, *, eviction_rate_qps: Optional[float] = None,
                  secondary_eviction_rate_qps: Optional[float] = None,
                  eviction_burst: Optional[float] = None,
                  large_cluster_threshold: Optional[int] = None,
                  unhealthy_zone_threshold: Optional[float] = None) -> None:
        """Apply controller-manager flag overrides; live buckets re-rate
        on the next state evaluation."""
        if eviction_rate_qps is not None:
            self.eviction_rate_qps = eviction_rate_qps
        if secondary_eviction_rate_qps is not None:
            self.secondary_eviction_rate_qps = secondary_eviction_rate_qps
        if eviction_burst is not None:
            self.eviction_burst = eviction_burst
        if large_cluster_threshold is not None:
            self.large_cluster_threshold = large_cluster_threshold
        if unhealthy_zone_threshold is not None:
            self.unhealthy_zone_threshold = unhealthy_zone_threshold
        for zk, bucket in self._zone_buckets.items():
            bucket.swap_rate(self._zone_qps(
                self.zone_states.get(zk, ZONE_NORMAL),
                self._zone_size.get(zk, 0)))

    # -- monitorNodeStatus -----------------------------------------------------

    def monitor(self, now: Optional[float] = None) -> None:
        """One monitorNodeStatus pass over all nodes: per-node condition
        and taint reconciliation, then the zone disruption computation,
        then the rate-limited taint-manager sweep."""
        now = now if now is not None else self.clock()
        nodes = self.store.list("nodes")
        # one pods-by-node index per pass: a partition keeps whole zones
        # tainted for its entire duration, and per-tainted-node scans of
        # the full pod list would be O(tainted x pods) every 5s
        by_node: Dict[str, list] = {}
        for pod in self.store.list("pods"):
            if pod.spec.node_name and is_pod_active(pod):
                by_node.setdefault(pod.spec.node_name, []).append(pod)
        for node in nodes:
            self._monitor_node(node, now, by_node)
        self._update_zone_states(nodes, now)
        self._process_evictions(now)

    def sync(self, key: str):
        name = key.split("/", 1)[1]
        node = (self.store.get("nodes", "default", name)
                or self.store.get("nodes", "", name))
        if node is not None:
            self._monitor_node(node, self.clock())

    def _monitor_node(self, node: api.Node, now: float,
                      pods_by_node: Optional[Dict[str, list]] = None):
        """One pass over one node. All mutations (Ready condition + taint
        swap) land in a single update so a CAS conflict never leaves the
        condition and taint out of sync — the next pass simply retries."""
        hb = _heartbeat(node)
        stale = hb is None or (now - hb) > self.grace_period
        ready = _ready_status(node)
        changed = False
        if stale:
            # kubelet stopped reporting: Ready -> Unknown + unreachable
            # taint (tryUpdateNodeStatus + markNodeForTainting :473)
            if ready != api.COND_UNKNOWN:
                self._set_ready_cond(node, api.COND_UNKNOWN)
                changed = True
            changed |= self._swap_taints(node, add=TAINT_UNREACHABLE,
                                         drop=TAINT_NOT_READY)
        elif ready == api.COND_FALSE:
            changed = self._swap_taints(node, add=TAINT_NOT_READY,
                                        drop=TAINT_UNREACHABLE)
        elif ready == api.COND_TRUE:
            changed = self._swap_taints(node, add=None,
                                        drop=(TAINT_NOT_READY,
                                              TAINT_UNREACHABLE))
        if changed:
            try:
                self.store.update("nodes", node)
            except (Conflict, KeyError):
                return  # stale view; retried on the next pass
        if any(t.effect == api.NO_EXECUTE for t in node.spec.taints):
            self._schedule_evictions(node, now, pods_by_node)
        else:
            # cancel pending evictions for this node (scan only the small
            # _evict_at map, not the cluster pod list)
            for key, (_, nname) in list(self._evict_at.items()):
                if nname == node.metadata.name:
                    self._evict_at.pop(key, None)

    @staticmethod
    def _set_ready_cond(node: api.Node, status: str):
        node.status.conditions = [c for c in node.status.conditions
                                  if c.type != api.NODE_READY]
        node.status.conditions.append(api.NodeCondition(api.NODE_READY, status))

    @staticmethod
    def _swap_taints(node: api.Node, add: Optional[str], drop) -> bool:
        """Mutate node.spec.taints in place; True if anything changed
        (taint manager swapUnreachableTaint analog). Taints are matched
        by (key, effect): the controller owns only the NoExecute pair —
        a user taint sharing a key under a different effect is never
        clobbered, and an effect-only difference counts as a change."""
        drops = (drop,) if isinstance(drop, str) else tuple(drop or ())
        gone = {(k, api.NO_EXECUTE) for k in drops}
        if add is not None:
            gone.add((add, api.NO_EXECUTE))  # re-added canonically below
        before = [(t.key, t.effect) for t in node.spec.taints]
        taints = [t for t in node.spec.taints
                  if (t.key, t.effect) not in gone]
        if add is not None:
            taints.append(api.Taint(key=add, effect=api.NO_EXECUTE))
        # order-insensitive compare: re-appending an already-present
        # taint must not register as a change every pass
        if sorted((t.key, t.effect) for t in taints) == sorted(before):
            return False
        node.spec.taints = taints
        return True

    # -- zone disruption computation (ComputeZoneState / handleDisruption) ----

    def _zone_qps(self, state: str, size: int) -> float:
        if state == ZONE_NORMAL:
            return self.eviction_rate_qps
        if state == ZONE_PARTIAL:
            # ReducedQPSFunc: secondary rate in large zones, full stop in
            # small ones
            return (self.secondary_eviction_rate_qps
                    if size > self.large_cluster_threshold else 0.0)
        return 0.0  # ZONE_FULL: suspended (enforced again in the sweep)

    def _bucket(self, zone_key: str) -> TokenBucket:
        b = self._zone_buckets.get(zone_key)
        if b is None:
            b = TokenBucket(self.eviction_rate_qps,
                            burst=self.eviction_burst, clock=self.clock)
            self._zone_buckets[zone_key] = b
        return b

    def _update_zone_states(self, nodes: List[api.Node], now: float):
        """Bucket nodes into failure domains and classify each: the
        ready/not-ready tally is one batched reduction over condition
        columns (ops/zonehealth), breaker-gated device path with an
        exact host fallback."""
        n = len(nodes)
        self._node_zone = {}
        if n == 0:
            return
        # dense columns, padded to a power-of-two bucket, as the
        # reference pads them (kubernetes_tpu/controllers/
        # nodelifecycle.py:300-339)
        cap = bucket_size(n)
        zone_id = np.zeros((cap,), np.int32)
        bad = np.zeros((cap,), bool)
        valid = np.zeros((cap,), bool)
        seen: Dict[str, int] = {}
        for i, node in enumerate(nodes):
            zk = api.get_zone_key(node)
            zid = self.zones.intern(zk)
            seen[zk] = zid
            self._node_zone[node.metadata.name] = zk
            zone_id[i] = zid
            bad[i] = _ready_status(node) != api.COND_TRUE
            valid[i] = True
        num_zones = bucket_size(self.zones.size)
        totals, badc = zonehealth.zone_tally(zone_id, bad, valid, num_zones,
                                             breaker=self.breaker,
                                             device=self.device)
        for zk, zid in seen.items():
            total = int(totals[zid])
            nbad = int(badc[zid])
            if total == 0:
                continue
            if nbad == total:
                state = ZONE_FULL
            elif nbad / total >= self.unhealthy_zone_threshold:
                state = ZONE_PARTIAL
            else:
                state = ZONE_NORMAL
            self._zone_size[zk] = total
            self._set_zone_state(zk, state, total, nbad, now)

    def _set_zone_state(self, zone_key: str, state: str, total: int,
                        nbad: int, now: float):
        old = self.zone_states.get(zone_key)
        # re-rate even without a state transition: a PARTIAL zone whose
        # node count crosses large_cluster_threshold changes qps (halt
        # <-> secondary) while staying PARTIAL
        bucket = self._bucket(zone_key)
        qps = self._zone_qps(state, total)
        if bucket.qps != qps:
            bucket.swap_rate(qps, now)
        if old == state:
            return
        self.zone_states[zone_key] = state
        disp = zone_display(zone_key)
        for s in ZONE_STATES:
            self.metrics.zone_health.labels(zone=disp, state=s).set(
                1.0 if s == state else 0.0)
        zref = _Zone(disp)
        if state == ZONE_FULL:
            # the suspension event the storm-control contract
            # hinges on: 100% failure is presumed OUR failure
            self.metrics.eviction_suspensions.inc()
            self.recorder.event(
                zref, "Warning", "EvictionsSuspended",
                f"zone {disp}: all {total} nodes stopped reporting — "
                f"entering {ZONE_FULL}; pod eviction suspended until "
                f"heartbeats resume")
        elif state == ZONE_PARTIAL:
            qps = self._zone_qps(state, total)
            self.recorder.event(
                zref, "Warning", "ZoneDisruptionEntered",
                f"zone {disp}: {nbad}/{total} nodes unhealthy — entering "
                f"{ZONE_PARTIAL}; eviction rate limited to {qps:g}/s")
        elif old is not None:
            self.recorder.event(
                zref, "Normal", "ZoneDisruptionLeft",
                f"zone {disp}: {total - nbad}/{total} nodes healthy — "
                f"back to {ZONE_NORMAL}")

    # -- NoExecute taint manager (eviction with tolerationSeconds) -------------

    def _schedule_evictions(self, node: api.Node, now: Optional[float] = None,
                            pods_by_node: Optional[Dict[str, list]] = None):
        now = now if now is not None else self.clock()
        keys = {t.key for t in node.spec.taints
                if t.effect == api.NO_EXECUTE}
        if not keys:
            return
        if pods_by_node is not None:  # monitor() pre-indexed the pass
            residents = pods_by_node.get(node.metadata.name, ())
        else:  # single-node sync(): one scan is fine
            residents = [p for p in self.store.list("pods")
                         if p.spec.node_name == node.metadata.name
                         and is_pod_active(p)]
        for pod in residents:
            k = pod.full_name()
            wait = self._toleration_wait(pod, keys)
            if wait is None:
                # tolerates forever: never evict
                self._evict_at.pop(k, None)
            else:
                deadline = now + wait
                if k not in self._evict_at or self._evict_at[k][0] > deadline:
                    self._evict_at[k] = (deadline, node.metadata.name)

    def _toleration_wait(self, pod: api.Pod, taint_keys) -> Optional[float]:
        """Min tolerationSeconds across NoExecute taints; None = tolerates
        forever; 0 = evict now (taint manager getMinTolerationTime)."""
        waits = []
        for key in taint_keys:
            taint = api.Taint(key=key, effect=api.NO_EXECUTE)
            matching = [t for t in pod.spec.tolerations if t.tolerates(taint)]
            if not matching:
                waits.append(0.0)
            else:
                secs = [t.toleration_seconds for t in matching]
                if any(s is None for s in secs):
                    continue  # tolerates this taint forever
                waits.append(float(max(0, min(secs))))
        if not waits:
            return None
        return min(waits)

    def _process_evictions(self, now: float):
        """Drain due evictions through the per-zone rate limiters
        (RateLimitedTimedQueue worker analog): oldest deadline first so
        a token goes to the longest-waiting pod, suspended/empty-bucket
        zones leave entries queued for the next pass."""
        due = sorted((deadline, key, nname)
                     for key, (deadline, nname) in self._evict_at.items()
                     if deadline <= now)
        depth: Dict[str, int] = {}
        for deadline, key, nname in due:
            zone = self._node_zone.get(nname, "")
            state = self.zone_states.get(zone, ZONE_NORMAL)
            disp = zone_display(zone)
            if state == ZONE_FULL:
                # suspended: presumed control-plane-side failure; entry
                # stays queued and is cancelled when heartbeats resume
                depth[disp] = depth.get(disp, 0) + 1
                continue
            ns, name = key.split("/", 1)
            pod = self.store.get("pods", ns, name)
            if pod is None or not pod.spec.node_name:
                self._evict_at.pop(key, None)
                continue
            node = (self.store.get("nodes", "default", pod.spec.node_name)
                    or self.store.get("nodes", "", pod.spec.node_name))
            if node is None or not any(t.effect == api.NO_EXECUTE
                                       for t in node.spec.taints):
                self._evict_at.pop(key, None)
                continue
            if not self._bucket(zone).try_take(now):
                depth[disp] = depth.get(disp, 0) + 1
                continue
            if faultpoints.fire("nodelifecycle.evict",
                                payload=(key, nname)):
                # drop-mode fault: the eviction API call was lost on the
                # wire; the entry stays queued and retries next pass
                depth[disp] = depth.get(disp, 0) + 1
                continue
            self._evict_at.pop(key, None)
            try:
                self.store.delete("pods", ns, name)
            except KeyError:
                continue
            self.evictions += 1
            self.metrics.zone_evictions.labels(zone=disp).inc()
            self.recorder.event(
                pod, "Normal", "NodeControllerEviction",
                f"Marking for deletion Pod {key} from Node {nname}")
        for disp, bucket in list(self._zone_buckets.items()):
            d = zone_display(disp)
            self.metrics.eviction_queue_depth.labels(zone=d).set(
                float(depth.get(d, 0)))

    def queue_depth(self) -> int:
        """Evictions due but held by suspension/rate limits (observability
        + test hook)."""
        now = self.clock()
        return sum(1 for deadline, _ in self._evict_at.values()
                   if deadline <= now)

    # -- background loop -------------------------------------------------------

    def run(self, workers: int = 1, period: float = 5.0):
        super().run(workers)

        def loop():
            while not self._stop.is_set():
                self.monitor()
                self._stop.wait(period)

        self._timer = threading.Thread(target=loop, daemon=True,
                                       name="nodelifecycle-monitor")
        self._timer.start()
