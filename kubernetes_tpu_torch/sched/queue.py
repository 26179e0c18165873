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

`pop_wave(max_n, timeout)` drains up to a wavefront of pods in one
call, in priority order, after waiting up to `timeout` seconds for the
first on the queue's condition variable (every add and every move into
the active heap notifies it; `close()` wakes every waiter).

Gang admission (coscheduling, sched/gang.py): pods carrying a pod-group
annotation park in a gang waiting area — NOT the active heap — until
minMember members exist; the whole gang then releases at once, and
pop_wave never splits a gang across waves. The `gang_lookup` hook is
wired by the scheduler; when it is None none of this code runs.

Overload control (priority-aware load shedding,
kubernetes_tpu/sched/queue.py:39-62): every pending pod is accounted to
a priority CLASS (QUEUE_CLASSES: system / high / normal / low, banded
from pod priority), and a configurable high watermark (`shed_watermark`,
0 = disabled) bounds the non-shed pending depth. Past the watermark,
newly arriving (and event-flushed) pods whose priority sits below
`shed_priority_threshold` are PARKED in a shed area instead of the
active heap — the queue stops growing the working set a 5x burst would
otherwise balloon without bound, while system/high-priority pods are
never shed. Shedding is starvation-proof: a shed pod ages back into the
active heap after `shed_age_s` seconds with a one-wave exemption from
re-shedding, and the whole shed area drains (oldest first) as soon as
the non-shed depth falls back under the watermark. Within a wave,
above-threshold pods always drain before any sub-threshold pod (the
heap is strict priority-first), and during a storm sub-threshold pods
are not in the heap at all — so a storm of low-priority pods can never
starve a system/high-priority wave. Gang members are never shed (their
admission gate is the gang waiting area; shedding a member would
deadlock the gang against its own queue). `hold_admissions`, a
predicate the scheduler's store plane wires (`_admissions_held`: the
store DISCONNECTED with the bind spool at its watermark), parks every
sheddable arrival in the shed area regardless of the watermark.

The `queue.shed` fault point (drop mode) forces the shed decision for
every sheddable pod regardless of watermark — the chaos rig for
storm-survival tests that want shedding without a real 5x backlog.

Poison-work quarantine (sched/scheduler.py input-fault isolation): pods
CONVICTED of poisoning the batched scheduling pass — a spec that
crashes the featurizer, non-finite planes the kernel sentinel flagged,
or a wave-bisection verdict — park in a QUARANTINE area, separate from
every other area and deliberately immune to event-driven flushes
(move_all_to_active must never feed a known-poison pod back into the
shared wave). Each entry carries a re-probe deadline (the scheduler's
capped poison backoff): past it the pod re-enters the active heap for
one fresh attempt — still poisoned, it re-convicts with a doubled
deadline; fixed, it places and the ladder clears. A genuine SPEC EDIT
releases the pod immediately (the operator fixed it; waiting out the
old deadline would punish the fix). Gang members are quarantined and
released as a unit. The area exports as
scheduler_pending_pods{queue=quarantine}.

The `queue.quarantine` fault point (drop mode) refuses quarantine
admissions — a lost conviction; the scheduler then falls back to a
plain backoff park.

With the PodPriority gate off every pod sorts at priority 0 (FIFO), as
in the JAX queue.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..api import types as api
from ..utils import faultpoints

# Priority-class bands for queue depth accounting and shed decisions.
# `system` matches the reference's system-critical band (priorities at
# or above 2e9: system-cluster-critical / system-node-critical);
# `high` is anything at or above HIGH_PRIORITY_BAND; `normal` is any
# remaining positive priority; `low` is zero (the unprioritized
# default) and below — exactly the class a burst of bulk pods lands in.
QUEUE_CLASSES = ("system", "high", "normal", "low")
SYSTEM_PRIORITY_BAND = 2_000_000_000
HIGH_PRIORITY_BAND = 1000


def pod_class(priority: int) -> str:
    """Priority-class band of a pod priority value."""
    if priority >= SYSTEM_PRIORITY_BAND:
        return "system"
    if priority >= HIGH_PRIORITY_BAND:
        return "high"
    if priority > 0:
        return "normal"
    return "low"


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
    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 pod_priority_enabled: bool = True,
                 shed_watermark: int = 0,
                 shed_priority_threshold: int = HIGH_PRIORITY_BAND,
                 shed_age_s: float = 30.0):
        self.clock = clock
        # the PodPriority gate: off, every pod sorts at priority 0
        self.pod_priority = pod_priority_enabled
        # overload control (module docstring "Overload control"):
        # watermark 0 disables shedding entirely — the default, so
        # deployments that never configure it see the pre-shed queue
        self.shed_watermark = int(shed_watermark)
        self.shed_priority_threshold = int(shed_priority_threshold)
        self.shed_age_s = float(shed_age_s)
        # uid -> pod parked by load shedding; _shed_at drives aging,
        # _shed_exempt (dict-as-ordered-set) marks aged-back pods that
        # get one un-sheddable pass through the active heap
        self._shed: Dict[str, api.Pod] = {}
        self._shed_at: Dict[str, float] = {}
        self._shed_exempt: Dict[str, None] = {}
        # fired (class_name) on every shed decision — feeds
        # scheduler_shed_total{class}
        self.on_shed: Optional[Callable[[str], None]] = None
        # admission hold: when this predicate returns True, every
        # sheddable arrival parks in the shed area regardless of the
        # watermark (the scheduler wires its store-outage hold here).
        # Same exemptions and aging as overload shedding
        self.hold_admissions: Optional[Callable[[], bool]] = None
        # a condition variable: a pop that waits is woken by every add
        # and every move into the active heap
        self._lock = threading.Condition()
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
        # poison-work quarantine (module docstring): uid -> pod convicted
        # by the scheduler's input-fault isolation, uid -> re-probe
        # deadline
        self._quarantine: Dict[str, api.Pod] = {}
        self._quarantine_until: Dict[str, float] = {}
        self._closed = False

    # -- overload control (priority-aware shedding) ---------------------------

    def _depth_locked(self) -> int:
        """Total pending depth across every area incl. shed and
        quarantine — the number an operator's backlog dashboard sums."""
        return (len(self._items) + len(self._unschedulable)
                + len(self._backoff) + len(self._shed)
                + len(self._quarantine)
                + sum(len(w) for w in self._gang_waiting.values()))

    def _working_depth_locked(self) -> int:
        """Depth the scheduler actually works: everything pending MINUS
        the shed and quarantine areas. This is what the watermark
        bounds."""
        return (self._depth_locked() - len(self._shed)
                - len(self._quarantine))

    def _should_shed_locked(self, pod: api.Pod) -> bool:
        """Shed decision for one arriving/flushed pod: only
        sub-threshold-priority pods, only past the high watermark, never
        an aged-back exempt pod. The queue.shed fault point (drop mode)
        forces the decision for any sheddable pod."""
        # the admission hold works even where shedding proper is
        # disabled (watermark 0): it parks pods in the shed area on the
        # hold predicate alone, priority/exemption rules unchanged
        hold = self.hold_admissions is not None and self.hold_admissions()
        if self.shed_watermark <= 0 and not hold:
            return False
        if api.pod_priority(pod) >= self.shed_priority_threshold:
            return False
        if pod.uid in self._shed_exempt:
            return False
        if hold:
            return True
        if faultpoints.fire("queue.shed", payload=pod):
            return True
        return self._working_depth_locked() >= self.shed_watermark

    def _shed_locked(self, pod: api.Pod) -> None:
        self._shed[pod.uid] = pod
        self._shed_at[pod.uid] = self.clock()
        # first-enqueue time survives the shed: per-pod e2e latency
        # counts the time load shedding cost this pod
        self.added_at.setdefault(pod.uid, self.clock())
        if self.on_shed is not None:
            self.on_shed(pod_class(api.pod_priority(pod)))
        # wake any blocked popper: it computed its wait bound before
        # this pod's aging deadline existed
        self._lock.notify()

    def _flush_shed_locked(self):
        """Aging + watermark release. Aged pods (shed longer than
        shed_age_s) re-enter the active heap UNCONDITIONALLY with a
        one-wave re-shed exemption — no pod sheds forever, however long
        the storm. Separately, once the working depth is back under the
        watermark the shed area drains oldest first until the watermark
        is reached again."""
        if not self._shed:
            return
        now = self.clock()
        aged = [uid for uid, t in self._shed_at.items()
                if now - t >= self.shed_age_s]
        for uid in aged:
            pod = self._shed.pop(uid)
            self._shed_at.pop(uid, None)
            self._shed_exempt[uid] = None
            self._items[uid] = pod
            heapq.heappush(self._heap, self._key(pod))
        if aged:
            self._lock.notify_all()
        # oldest-first release under the watermark: dict order IS shed
        # order. An armed queue.shed fault suppresses the release (aging
        # above still ran), and so does an active admission hold;
        # is_armed, not fire(): the probe must not consume a
        # times-bounded fault's per-pod shed budget
        if not faultpoints.is_armed("queue.shed", "drop") and not (
                self.hold_admissions is not None and self.hold_admissions()):
            while (self._shed
                   and self._working_depth_locked() < self.shed_watermark):
                uid = next(iter(self._shed))
                pod = self._shed.pop(uid)
                self._shed_at.pop(uid, None)
                self._items[uid] = pod
                heapq.heappush(self._heap, self._key(pod))

    def shed_count(self) -> int:
        with self._lock:
            return len(self._shed)

    def shed_pods(self) -> List[api.Pod]:
        """The shed area's pods, oldest shed first."""
        with self._lock:
            return list(self._shed.values())

    def class_counts(self) -> Dict[str, int]:
        """Pending depth per priority class across every area (active,
        backoff, unschedulable, shed, quarantine, gang-waiting) —
        scheduler_queue_class_pods{class=...}."""
        counts = {c: 0 for c in QUEUE_CLASSES}
        with self._lock:
            for area in (self._items, self._unschedulable, self._backoff,
                         self._shed, self._quarantine):
                for pod in area.values():
                    counts[pod_class(api.pod_priority(pod))] += 1
            for waiting in self._gang_waiting.values():
                for pod in waiting.values():
                    counts[pod_class(api.pod_priority(pod))] += 1
        return counts

    def area_uids(self) -> Dict[str, Tuple[str, ...]]:
        """One atomic snapshot of every queue area's pod uids under a
        single lock hold — the invariant checker's view (a per-area
        accessor sequence could see one pod in two areas mid-move and
        report a phantom conservation violation). Keys: active, backoff,
        unschedulable, shed, quarantine, gang_waiting
        (kubernetes_tpu/sched/queue.py:326)."""
        with self._lock:
            return {
                "active": tuple(self._items),
                "backoff": tuple(self._backoff),
                "unschedulable": tuple(self._unschedulable),
                "shed": tuple(self._shed),
                "quarantine": tuple(self._quarantine),
                "gang_waiting": tuple(
                    uid for waiting in self._gang_waiting.values()
                    for uid in waiting),
            }

    # -- poison-work quarantine ------------------------------------------------

    def quarantine(self, pod: api.Pod, until: float) -> bool:
        """Park one CONVICTED pod in the quarantine area until its
        re-probe deadline. Removes it from every other pending area;
        gang membership is kept (a quarantined gang re-probes and
        re-forms as a unit). False when the `queue.quarantine` fault
        point dropped the admission (a lost conviction — the caller
        falls back to a plain backoff park)."""
        if faultpoints.fire("queue.quarantine", payload=pod):
            return False
        with self._lock:
            self._items.pop(pod.uid, None)
            self._unschedulable.pop(pod.uid, None)
            self._backoff.pop(pod.uid, None)
            self._shed.pop(pod.uid, None)
            self._shed_at.pop(pod.uid, None)
            self._shed_exempt.pop(pod.uid, None)
            key = self._gang_of.get(pod.uid)
            if key is not None:
                waiting = self._gang_waiting.get(key)
                if waiting is not None:
                    waiting.pop(pod.uid, None)
                    if not waiting:
                        del self._gang_waiting[key]
                        self._gang_wait_start.pop(key, None)
            self._quarantine[pod.uid] = pod
            self._quarantine_until[pod.uid] = until
            # first-enqueue time survives conviction: e2e latency counts
            # quarantine time for a pod that eventually recovers
            self.added_at.setdefault(pod.uid, self.clock())
            # a blocked popper computed its wait bound before this
            # deadline existed — wake it so the bound is recomputed
            self._lock.notify()
        return True

    def _flush_quarantine_locked(self):
        """Re-probe release: quarantined pods past their deadline get
        one fresh pass through the active heap. Gang-ATOMIC: a due
        member brings its quarantined mates with it."""
        if not self._quarantine:
            return
        now = self.clock()
        due = [uid for uid, t in self._quarantine_until.items()
               if t <= now]
        released = False
        for uid in due:
            pod = self._quarantine.pop(uid, None)
            if pod is None:
                continue  # already released as a due mate's gangmate
            released = True
            self._quarantine_until.pop(uid, None)
            self._items[uid] = pod
            heapq.heappush(self._heap, self._key(pod))
            key = self._gang_of.get(uid)
            if key is None:
                continue
            for muid in self._gang_members.get(key, ()):
                mate = self._quarantine.pop(muid, None)
                if mate is not None:
                    self._quarantine_until.pop(muid, None)
                    self._items[muid] = mate
                    heapq.heappush(self._heap, self._key(mate))
        if released:
            self._lock.notify_all()

    def quarantine_count(self) -> int:
        with self._lock:
            return len(self._quarantine)

    def quarantined_pods(self) -> List[api.Pod]:
        with self._lock:
            return list(self._quarantine.values())

    def gang_pending_pods(self, key: str) -> List[api.Pod]:
        """Every member of gang `key` currently held in a pending area
        (active/backoff/unschedulable/shed/gang-waiting) — the
        conviction plane quarantines them ATOMICALLY with a poisoned
        member."""
        out: List[api.Pod] = []
        with self._lock:
            waiting = self._gang_waiting.get(key, {})
            for uid in self._gang_members.get(key, ()):
                for area in (self._items, self._backoff,
                             self._unschedulable, self._shed, waiting):
                    p = area.get(uid)
                    if p is not None:
                        out.append(p)
                        break
        return out

    # -- add / pop -----------------------------------------------------------

    def _key(self, pod: api.Pod):
        prio = -api.pod_priority(pod) if self.pod_priority else 0
        return (prio, next(self._seq), pod.uid)

    def add(self, pod: api.Pod):
        released = None
        with self._lock:
            if (pod.uid in self._items or pod.uid in self._shed
                    or pod.uid in self._quarantine):
                return
            self._unschedulable.pop(pod.uid, None)
            self._backoff.pop(pod.uid, None)
            info = (self.gang_lookup(pod) if self.gang_lookup is not None
                    else None)
            # load shedding gates ONLY non-gang pods (a shed gang member
            # would deadlock its gang's admission against the queue)
            if info is None and self._should_shed_locked(pod):
                self._shed_locked(pod)
                return
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
            self._lock.notify()
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
            self._lock.notify_all()
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
                    or pod.uid in self._backoff or pod.uid in self._shed
                    or pod.uid in self._quarantine
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
                    or pod.uid in self._backoff or pod.uid in self._shed
                    or pod.uid in self._quarantine
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
        elif (pod.uid not in self._gang_of
                and self._should_shed_locked(pod)):
            # event-driven flushes respect the watermark too: a storm's
            # move_all_to_active must not balloon the active heap with
            # the very pods admission just shed
            self._shed_locked(pod)
        else:
            self._items[pod.uid] = pod
            heapq.heappush(self._heap, self._key(pod))
            self._lock.notify()

    def _flush_backoff_locked(self):
        now = self.clock()
        expired = [uid for uid in self._backoff
                   if self._backoff_until.get(uid, 0.0) <= now]
        for uid in expired:
            pod = self._backoff.pop(uid)
            self._items[uid] = pod
            heapq.heappush(self._heap, self._key(pod))
        if expired:
            self._lock.notify_all()

    def pop(self, timeout: Optional[float] = None) -> Optional[api.Pod]:
        """Blocking pop of the highest-priority pod (reference :311;
        kubernetes_tpu/sched/queue.py:623). The condvar wait is bounded
        by the earliest backoff, shed-aging and quarantine deadline, so a
        pod becoming eligible wakes a blocked popper — nothing notifies
        when a deadline merely passes. None after `timeout` seconds of
        the queue's clock with nothing to pop, or once closed."""
        deadline = None if timeout is None else self.clock() + timeout
        with self._lock:
            while True:
                self._flush_backoff_locked()
                self._flush_shed_locked()
                self._flush_quarantine_locked()
                if self._heap or self._closed:
                    break
                wait = None
                if deadline is not None:
                    wait = deadline - self.clock()
                    if wait <= 0:
                        return None
                if self._backoff:
                    nxt = min(self._backoff_until.get(u, 0.0)
                              for u in self._backoff)
                    until_next = nxt - self.clock()
                    if until_next <= 0:
                        continue  # expired while computing: reflush
                    wait = until_next if wait is None else min(wait, until_next)
                if self._shed:
                    # shed aging must wake a blocked popper like backoff
                    # deadlines do
                    nxt = (min(self._shed_at.values()) + self.shed_age_s
                           - self.clock())
                    if nxt <= 0:
                        continue  # aged while computing: reflush
                    wait = nxt if wait is None else min(wait, nxt)
                if self._quarantine:
                    # quarantine re-probe deadlines bound the wait too
                    nxt = (min(self._quarantine_until.values())
                           - self.clock())
                    if nxt <= 0:
                        continue  # due while computing: reflush
                    wait = nxt if wait is None else min(wait, nxt)
                self._lock.wait(wait)
            if self._closed and not self._heap:
                return None
            return self._pop_locked()

    def _pop_locked(self) -> Optional[api.Pod]:
        while self._heap:
            _, _, uid = heapq.heappop(self._heap)
            pod = self._items.pop(uid, None)
            if pod is not None:
                self._current_cycle += 1
                self._cycle[uid] = self._current_cycle
                # an aged-back pod's re-shed exemption is consumed by
                # reaching a wave
                self._shed_exempt.pop(uid, None)
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

    def pop_wave(self, max_n: int,
                 timeout: Optional[float] = None) -> List[api.Pod]:
        """Drain up to max_n pods in priority order (blocks for the
        first, up to `timeout` seconds; None waits until a pod arrives or
        the queue closes). Gangs are never split across the max_n
        boundary: a gang that doesn't fit in the remaining budget is
        pushed back whole for the next wave; a gang leading the wave may
        exceed max_n (it MUST be evaluated in one batch to fail or place
        atomically)."""
        out: List[api.Pod] = []
        first = self.pop(timeout)
        if first is None:
            return out
        out.append(first)
        with self._lock:
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
            self._lock.notify_all()

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
                self._lock.notify_all()

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

    @staticmethod
    def _spec_edited(old: api.Pod, new: api.Pod) -> bool:
        """NaN-tolerant flavor of _is_pod_updated for the quarantine
        release test: a NaN resource quantity is the usual poison, and
        NaN != NaN after the store's deepcopy, so plain equality would
        read every STATUS-ONLY write (the conviction's own condition
        update) as a spec edit. Falls back to a repr comparison, under
        which NaN is stable."""

        def strip(p: api.Pod):
            meta = dataclasses.replace(p.metadata, resource_version=0)
            return (meta, p.spec)

        a, b = strip(old), strip(new)
        if a == b:
            return False
        return repr(a) != repr(b)

    def update(self, old: Optional[api.Pod], new: api.Pod):
        with self._lock:
            if new.uid in self._quarantine:
                if old is not None and self._spec_edited(old, new):
                    # a genuine SPEC edit releases a convicted pod (and
                    # its quarantined gangmates) immediately
                    self._quarantine.pop(new.uid)
                    self._quarantine_until.pop(new.uid, None)
                    self._items[new.uid] = new
                    heapq.heappush(self._heap, self._key(new))
                    key = self._gang_of.get(new.uid)
                    if key is not None:
                        for uid in self._gang_members.get(key, ()):
                            mate = self._quarantine.pop(uid, None)
                            if mate is not None:
                                self._quarantine_until.pop(uid, None)
                                self._items[uid] = mate
                                heapq.heappush(self._heap,
                                               self._key(mate))
                    self._lock.notify()
                else:
                    self._quarantine[new.uid] = new  # status-only change
                return
            if new.uid in self._items:
                self._items[new.uid] = new
                return
            if new.uid in self._backoff:
                self._backoff[new.uid] = new
                return
            if new.uid in self._shed:
                self._shed[new.uid] = new
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
                self._lock.notify()
                return
        self.add(new)

    def remove_if_pending(self, uid: str):
        """Drop a pod from the pending structures WITHOUT touching gang
        membership or nomination state (kubernetes_tpu/sched/queue.py:
        844) — the lost-bind-confirmation recovery path: the pod turned
        out to be BOUND (API truth), so it must not be scheduled again,
        but as a live member it still counts toward its gang. Stale heap
        keys are lazily skipped by the pop path, as with delete()."""
        with self._lock:
            self._items.pop(uid, None)
            self._unschedulable.pop(uid, None)
            self._backoff.pop(uid, None)
            self._backoff_until.pop(uid, None)
            self._shed.pop(uid, None)
            self._shed_at.pop(uid, None)
            self._shed_exempt.pop(uid, None)
            self._quarantine.pop(uid, None)
            self._quarantine_until.pop(uid, None)

    def delete(self, pod: api.Pod):
        with self._lock:
            self._items.pop(pod.uid, None)
            self._unschedulable.pop(pod.uid, None)
            self._backoff.pop(pod.uid, None)
            self._backoff_until.pop(pod.uid, None)
            self._shed.pop(pod.uid, None)
            self._shed_at.pop(pod.uid, None)
            self._shed_exempt.pop(pod.uid, None)
            self._quarantine.pop(pod.uid, None)
            self._quarantine_until.pop(pod.uid, None)
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
            return self._depth_locked()

    def unschedulable_pods(self) -> List[api.Pod]:
        """Snapshot of the unschedulable map: the pods that failed on
        EVERY node and are waiting for the cluster to change."""
        with self._lock:
            return list(self._unschedulable.values())

    def unschedulable_count(self) -> int:
        with self._lock:
            return len(self._unschedulable)

    def backoff_count(self) -> int:
        with self._lock:
            return len(self._backoff)

    def gang_waiting_count(self) -> int:
        with self._lock:
            return sum(len(w) for w in self._gang_waiting.values())

    def active_count(self) -> int:
        with self._lock:
            self._flush_backoff_locked()
            self._flush_shed_locked()
            self._flush_quarantine_locked()
            return len(self._items)

    def active_pods(self) -> List[api.Pod]:
        with self._lock:
            return list(self._items.values())

    def close(self):
        """Wake every blocked popper; pops return None from then on
        once the active heap is empty."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
