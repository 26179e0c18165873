"""Scheduling queue.

A copy of the JAX package's SchedulingQueue
(kubernetes_tpu/sched/queue.py), itself a behavioral port of the
reference's SchedulingQueue (pkg/scheduler/core/scheduling_queue.go):
an active priority heap (pod priority desc, then FIFO), an
unschedulable map flushed to active on cluster events
(MoveAllToActiveQueue, :408) and nominated-pod tracking for preemption.

Two refinements over the 1.11 queue, both from its successors:

* **Backoff gating.** A failed pod carries a backoff deadline
  (util/backoff_utils.go:97-112 computes it). The queue holds moved
  pods in a backoff area until the deadline passes — a pod that just
  failed cannot be re-popped by the very next wave, even when cluster
  events flush the unschedulable map.
* **Targeted moves on assigned pods.** `assigned_pod_added` moves ONLY
  unschedulable pods with a required pod-affinity term matching the
  newly-bound pod (reference scheduling_queue.go:363).

`pop_wave(max_n)` drains up to a wavefront of pods in one call, in
priority order.

Gang admission (coscheduling, sched/gang.py): pods carrying a pod-group
annotation park in a gang waiting area — NOT the active heap — until
minMember members exist; the whole gang then releases at once, and
pop_wave never splits a gang across waves. The `gang_lookup` hook is
wired by the scheduler; when it is None none of this code runs.

The JAX queue's load shedding and poison quarantine areas, and its
FIFO order for clusters with pod priority off, are not carried: the
port's scheduler has neither overload control nor input fault
isolation, and always orders by priority.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from ..api import types as api


def _matches_affinity_term(unsched: api.Pod, assigned: api.Pod) -> bool:
    """Does `unsched` carry a required pod-affinity term selecting
    `assigned`? (reference scheduling_queue.go:377 — only such pods can
    become schedulable when a pod gets bound)."""
    aff = unsched.spec.affinity
    if aff is None or aff.pod_affinity is None:
        return False
    for term in aff.pod_affinity.required or []:
        ns = set(term.namespaces) if term.namespaces else {unsched.namespace}
        if assigned.namespace not in ns:
            continue
        if term.label_selector is not None:
            sel = term.label_selector.to_selector()
            if sel.matches(assigned.metadata.labels or {}):
                return True
    return False


class SchedulingQueue:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self._heap: List = []  # (-priority, seq, uid)
        self._items: Dict[str, api.Pod] = {}  # uid -> pod (active)
        self._unschedulable: Dict[str, api.Pod] = {}
        # pods moved by an event while still inside their backoff window:
        # eligible for active only once the deadline passes
        self._backoff: Dict[str, api.Pod] = {}
        self._backoff_until: Dict[str, float] = {}
        self._seq = itertools.count()
        # uid -> scheduling cycle when it was deemed unschedulable
        self._cycle: Dict[str, int] = {}
        self._move_request_cycle = -1
        self._current_cycle = 0
        # nominated pods: node name -> {uid: pod} (reference :464
        # WaitingPodsForNode; used by preemption)
        self._nominated: Dict[str, Dict[str, api.Pod]] = {}
        # uid -> first time the pod entered the active queue (consumed by
        # the scheduler's per-pod e2e latency metric at bind)
        self.added_at: Dict[str, float] = {}
        # gang admission: pods of an incomplete gang wait here instead of
        # the active heap. gang_lookup(pod) -> (key, minMember) | None;
        # on_gang_released(key, waited_s) feeds the gang_wait metric.
        self.gang_lookup: Optional[Callable] = None
        self.on_gang_released: Optional[Callable[[str, float], None]] = None
        self._gang_waiting: Dict[str, Dict[str, api.Pod]] = {}
        # pending+placed uids per gang. Dict-as-ordered-set, NOT a set:
        # _pop_gangmates_locked iterates it to assemble the member batch,
        # and set order follows the (random) uid hashes — scheduling
        # would stop being a pure function of arrival order
        self._gang_members: Dict[str, Dict[str, None]] = {}
        self._gang_of: Dict[str, str] = {}  # uid -> gang key
        self._gang_wait_start: Dict[str, float] = {}

    def gang_pending_pods(self, key: str) -> List[api.Pod]:
        """Every member of gang `key` currently held in a pending area
        (active/backoff/unschedulable/gang-waiting)."""
        out: List[api.Pod] = []
        with self._lock:
            waiting = self._gang_waiting.get(key, {})
            for uid in self._gang_members.get(key, ()):
                for area in (self._items, self._backoff,
                             self._unschedulable, waiting):
                    p = area.get(uid)
                    if p is not None:
                        out.append(p)
                        break
        return out

    # -- add / pop -----------------------------------------------------------

    def _key(self, pod: api.Pod):
        return (-api.pod_priority(pod), next(self._seq), pod.uid)

    def add(self, pod: api.Pod):
        released = None
        with self._lock:
            if pod.uid in self._items:
                return
            self._unschedulable.pop(pod.uid, None)
            self._backoff.pop(pod.uid, None)
            info = (self.gang_lookup(pod) if self.gang_lookup is not None
                    else None)
            if info is not None:
                key, min_member = info
                self._gang_of[pod.uid] = key
                members = self._gang_members.setdefault(key, {})
                members[pod.uid] = None
                if len(members) < min_member:
                    # incomplete gang: park — a half-formed gang entering
                    # the wave would either deadlock capacity against
                    # another half-formed gang or fail every round
                    self._gang_waiting.setdefault(key, {})[pod.uid] = pod
                    self._gang_wait_start.setdefault(key, self.clock())
                    return
                # minMember reached: this pod AND every parked member
                # enter the active heap together
                released = self._release_gang_locked(key)
            self._items[pod.uid] = pod
            # first enqueue time survives requeues: per-pod e2e scheduling
            # latency measures from when the pod first became schedulable
            self.added_at.setdefault(pod.uid, self.clock())
            heapq.heappush(self._heap, self._key(pod))
            if pod.status.nominated_node_name:
                self._nominated.setdefault(
                    pod.status.nominated_node_name, {})[pod.uid] = pod
        if released is not None and self.on_gang_released is not None:
            self.on_gang_released(*released)

    def _gang_waiting_has_locked(self, uid: str) -> bool:
        key = self._gang_of.get(uid)
        return key is not None and uid in self._gang_waiting.get(key, ())

    def _release_gang_locked(self, key: str):
        """Move every parked member of `key` to the active heap. Returns
        (key, waited_seconds) when a wait window closes, else None."""
        waiting = self._gang_waiting.pop(key, None)
        started = self._gang_wait_start.pop(key, None)
        if waiting:
            for uid, p in waiting.items():
                self._items[uid] = p
                self.added_at.setdefault(uid, self.clock())
                heapq.heappush(self._heap, self._key(p))
        if started is None:
            return None
        return key, self.clock() - started

    def gang_reevaluate(self):
        """Re-check waiting gangs against current minMember — called when
        a PodGroup object appears or changes (a PodGroup created AFTER
        its pods may lower the bar below the member count)."""
        released = []
        with self._lock:
            if self.gang_lookup is None:
                return
            for key in list(self._gang_waiting):
                waiting = self._gang_waiting.get(key)
                if not waiting:
                    continue
                sample = next(iter(waiting.values()))
                info = self.gang_lookup(sample)
                min_member = info[1] if info is not None else 1
                if len(self._gang_members.get(key, ())) >= min_member:
                    r = self._release_gang_locked(key)
                    if r is not None:
                        released.append(r)
        if self.on_gang_released is not None:
            for r in released:
                self.on_gang_released(*r)

    def gang_forget(self, pod: api.Pod):
        """Drop a pod from gang accounting without touching the queues —
        for members that left the cluster while BOUND (the queue never
        saw their deletion through delete())."""
        with self._lock:
            self._gang_cleanup_locked(pod.uid)

    def _gang_cleanup_locked(self, uid: str):
        key = self._gang_of.pop(uid, None)
        if key is None:
            return
        members = self._gang_members.get(key)
        if members is not None:
            members.pop(uid, None)
            if not members:
                del self._gang_members[key]
        waiting = self._gang_waiting.get(key)
        if waiting is not None:
            waiting.pop(uid, None)
            if not waiting:
                del self._gang_waiting[key]
                self._gang_wait_start.pop(key, None)

    def add_if_not_present(self, pod: api.Pod):
        with self._lock:
            if (pod.uid in self._items or pod.uid in self._unschedulable
                    or pod.uid in self._backoff
                    or self._gang_waiting_has_locked(pod.uid)):
                return
        self.add(pod)

    def set_backoff(self, uid: str, until: float):
        """Record a backoff deadline; the pod stays ineligible for the
        active heap until then (enforced at move/flush time)."""
        with self._lock:
            self._backoff_until[uid] = until

    def clear_backoff(self, uid: str):
        with self._lock:
            self._backoff_until.pop(uid, None)
            pod = self._backoff.pop(uid, None)
        if pod is not None:
            self.add(pod)

    def add_unschedulable_if_not_present(self, pod: api.Pod):
        """Reference :286 — goes back to active if a move request arrived
        since this pod's scheduling cycle began (an event may have made it
        schedulable again); the backoff gate still applies."""
        with self._lock:
            if (pod.uid in self._items or pod.uid in self._unschedulable
                    or pod.uid in self._backoff
                    or self._gang_waiting_has_locked(pod.uid)):
                return
            cycle = self._cycle.pop(pod.uid, self._current_cycle)
            if self._move_request_cycle >= cycle:
                self._to_active_or_backoff_locked(pod)
            else:
                self._unschedulable[pod.uid] = pod
            if pod.status.nominated_node_name:
                self._nominated.setdefault(
                    pod.status.nominated_node_name, {})[pod.uid] = pod

    def _to_active_or_backoff_locked(self, pod: api.Pod):
        until = self._backoff_until.get(pod.uid, 0.0)
        if until > self.clock():
            self._backoff[pod.uid] = pod
        else:
            self._items[pod.uid] = pod
            heapq.heappush(self._heap, self._key(pod))

    def _flush_backoff_locked(self):
        now = self.clock()
        expired = [uid for uid in self._backoff
                   if self._backoff_until.get(uid, 0.0) <= now]
        for uid in expired:
            pod = self._backoff.pop(uid)
            self._items[uid] = pod
            heapq.heappush(self._heap, self._key(pod))

    def _pop_locked(self) -> Optional[api.Pod]:
        while self._heap:
            _, _, uid = heapq.heappop(self._heap)
            pod = self._items.pop(uid, None)
            if pod is not None:
                self._current_cycle += 1
                self._cycle[uid] = self._current_cycle
                return pod
        return None

    def _pop_gangmates_locked(self, pod: api.Pod) -> List[api.Pod]:
        """Pop every ACTIVE gangmate of `pod` (their heap entries go
        stale and are skipped by _pop_locked later). The gang travels as
        one unit into the wave; mates parked in backoff/unschedulable are
        not touched — gang failure parks them together anyway."""
        key = self._gang_of.get(pod.uid)
        if key is None:
            return []
        out = []
        for uid in list(self._gang_members.get(key, ())):
            mate = self._items.pop(uid, None)
            if mate is not None:
                self._current_cycle += 1
                self._cycle[uid] = self._current_cycle
                out.append(mate)
        return out

    def pop_wave(self, max_n: int) -> List[api.Pod]:
        """Drain up to max_n pods in priority order, without waiting.
        Gangs are never split across the max_n boundary: a gang that
        doesn't fit in the remaining budget is pushed back whole for the
        next wave; a gang leading the wave may exceed max_n (it MUST be
        evaluated in one batch to fail or place atomically)."""
        out: List[api.Pod] = []
        with self._lock:
            self._flush_backoff_locked()
            first = self._pop_locked()
            if first is None:
                return out
            out.append(first)
            out.extend(self._pop_gangmates_locked(first))
            while len(out) < max_n:
                pod = self._pop_locked()
                if pod is None:
                    break
                mates = self._pop_gangmates_locked(pod)
                if len(out) + 1 + len(mates) > max_n:
                    # would split the gang across waves: requeue it whole
                    # (priority preserved; FIFO position resets)
                    for p in [pod] + mates:
                        self._items[p.uid] = p
                        heapq.heappush(self._heap, self._key(p))
                    break
                out.append(pod)
                out.extend(mates)
        return out

    # -- event-driven moves ---------------------------------------------------

    def move_all_to_active(self):
        """Reference :408 MoveAllToActiveQueue — cluster events (node add,
        pod delete, ...) flush the unschedulable map. Pods still inside
        their backoff window go to the backoff area instead."""
        with self._lock:
            for pod in self._unschedulable.values():
                self._to_active_or_backoff_locked(pod)
            self._unschedulable.clear()
            self._move_request_cycle = self._current_cycle

    def assigned_pod_added(self, pod: api.Pod):
        """Reference :363 — a bound pod moves only the unschedulable pods
        whose required pod-affinity terms select it; everything else stays
        parked (no thundering-herd flush on every bind)."""
        with self._lock:
            matching = [u for u, p in self._unschedulable.items()
                        if _matches_affinity_term(p, pod)]
            for uid in matching:
                self._to_active_or_backoff_locked(self._unschedulable.pop(uid))
            if matching:
                self._move_request_cycle = self._current_cycle

    # -- update / delete ------------------------------------------------------

    @staticmethod
    def _is_pod_updated(old: api.Pod, new: api.Pod) -> bool:
        """Reference :328 isPodUpdated — strip status/resourceVersion and
        compare; only such updates can make an unschedulable pod
        schedulable."""

        def strip(p: api.Pod):
            meta = dataclasses.replace(p.metadata, resource_version=0)
            return (meta, p.spec)

        return strip(old) != strip(new)

    def update(self, old: Optional[api.Pod], new: api.Pod):
        with self._lock:
            if new.uid in self._items:
                self._items[new.uid] = new
                return
            if new.uid in self._backoff:
                self._backoff[new.uid] = new
                return
            if self._gang_waiting_has_locked(new.uid):
                self._gang_waiting[self._gang_of[new.uid]][new.uid] = new
                return
            if new.uid in self._unschedulable:
                if old is not None and not self._is_pod_updated(old, new):
                    self._unschedulable[new.uid] = new  # status-only change
                    return
                self._unschedulable.pop(new.uid)
                self._items[new.uid] = new
                heapq.heappush(self._heap, self._key(new))
                return
        self.add(new)

    def delete(self, pod: api.Pod):
        with self._lock:
            self._items.pop(pod.uid, None)
            self._unschedulable.pop(pod.uid, None)
            self._backoff.pop(pod.uid, None)
            self._backoff_until.pop(pod.uid, None)
            self.added_at.pop(pod.uid, None)
            # gang accounting must shrink with the member, or a stale uid
            # would open the gate early and place a sub-minMember gang
            self._gang_cleanup_locked(pod.uid)
            nom = self._nominated.get(pod.status.nominated_node_name)
            if nom:
                nom.pop(pod.uid, None)

    # -- nominated pods --------------------------------------------------------

    def update_nominated_pod(self, pod: api.Pod, node_name: str):
        with self._lock:
            for nodes in self._nominated.values():
                nodes.pop(pod.uid, None)
            if node_name:
                self._nominated.setdefault(node_name, {})[pod.uid] = pod

    def waiting_pods_for_node(self, node_name: str) -> List[api.Pod]:
        with self._lock:
            return list(self._nominated.get(node_name, {}).values())

    # -- introspection ---------------------------------------------------------

    def pending_count(self) -> int:
        with self._lock:
            return (len(self._items) + len(self._unschedulable)
                    + len(self._backoff)
                    + sum(len(w) for w in self._gang_waiting.values()))

    def unschedulable_pods(self) -> List[api.Pod]:
        """Snapshot of the unschedulable map: the pods that failed on
        EVERY node and are waiting for the cluster to change."""
        with self._lock:
            return list(self._unschedulable.values())

    def gang_waiting_count(self) -> int:
        with self._lock:
            return sum(len(w) for w in self._gang_waiting.values())

    def active_count(self) -> int:
        with self._lock:
            self._flush_backoff_locked()
            return len(self._items)

    def active_pods(self) -> List[api.Pod]:
        with self._lock:
            return list(self._items.values())
