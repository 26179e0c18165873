"""Continuously-checked cluster invariants.

A copy of kubernetes_tpu/chaos/invariants.py: INVARIANTS,
InvariantViolation and InvariantChecker with its six checks and digest,
over the port's sched/storehealth.py and sched/breaker.py. Every check
reads host state only (the store, the scheduler cache, the queue's
areas, the snapshot's numpy planes `requested`, `pod_count`, `ep_node`,
`ep_req`, `ep_valid`), never a tensor on the card, so a checked round
syncs the card no more than an unchecked one. The port's Scheduler has
no mesh (`meshfaults` is None, the JAX value without one), so the mesh
clause of state_machine never runs there.

Sixteen fault-tolerance planes (breaker, watchdog, mesh reform, poison
isolation, zone eviction, bind reconciler, autopilot rollback) each
protect the same handful of global properties, but until now those
properties were only asserted at the END of individual chaos tests.
The `InvariantChecker` turns them into a post-round observer: armed
(opt-in, `--invariants` / `Scheduler(invariants=True)`), the scheduler
calls `check()` after every scheduling round, and any violated
invariant raises a typed `InvariantViolation` carrying a full state
digest — at the round that broke it, not at drain time with the
evidence long gone. Off, the cost is one attribute None-check per
round (the tracing pattern).

Checked invariants (the `scheduler_invariant_violations_total`
{invariant=...} label set):

  conservation    every live pod this scheduler is responsible for is
                  in EXACTLY one place: bound/assumed, or one queue
                  area (active/backoff/unschedulable/shed/gang-waiting
                  /quarantine). Zero places = a lost pod; two = a
                  double-booked pod (e.g. a gang rollback that forgot
                  to un-assume before parking)
  double_bind     no pod holds capacity on two nodes in the scheduler
                  cache, and a store-bound pod's cache placement
                  agrees with API truth
  capacity        per node, the sum of resident pod requests (from the
                  API store, the truth) never exceeds allocatable
  snapshot_usage  the HBM mirror's per-node requested row equals the
                  sum of its resident pod-matrix rows (the scrubber's
                  cross-check, run continuously), and the usage plane
                  is NaN-free
  gang_atomic     every gang is 0-or-all: placed members (bound or
                  assumed) number 0 or >= minMember
  state_machine   breaker state is a legal DevicePathBreaker state
                  with sane counters, mesh quarantine partitions the
                  device set, watchdog accounting is consistent

The checker runs with the scheduler's `_mu` held (the caller's job —
Scheduler._check_invariants) and takes one atomic queue-area snapshot
(SchedulingQueue.area_uids), so it can never see a pod mid-move
between areas. It must only be called at round boundaries: mid-wave,
popped pods are legitimately in no area.

Eventual consistency: the binder runs on its own thread, so a pod can
legitimately be mid-flight between subsystems at a round boundary (a
failed async bind un-assumes and re-queues in two steps; a gang member
whose bind POST failed is re-placed next round). The cross-subsystem
invariants — conservation and gang_atomic — therefore fire only when
the SAME pod/gang is in violation at two CONSECUTIVE checks: a
transient self-clears within one round, a real leak (the class of bug
these invariants exist for) persists forever.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import types as api
from ..sched.storehealth import CONNECTED as STORE_CONNECTED

# capped list lengths inside digests: a 30k-pod run's violation must
# not serialize 30k uids to name three offenders
_DIGEST_CAP = 20

INVARIANTS = ("conservation", "double_bind", "capacity",
              "snapshot_usage", "gang_atomic", "state_machine")


class InvariantViolation(AssertionError):
    """A cluster invariant failed. `invariant` names which (one of
    INVARIANTS), `digest` carries the state evidence captured at the
    violating round."""

    def __init__(self, invariant: str, detail: str, digest: dict):
        super().__init__(f"invariant {invariant!r} violated: {detail}")
        self.invariant = invariant
        self.detail = detail
        self.digest = digest


def _cap(items) -> List[str]:
    out = [str(x) for x in items]
    out.sort()
    return out[:_DIGEST_CAP]


class InvariantChecker:
    """Post-round cluster-invariant observer. `strict=True` (the chaos
    campaign) raises the first violation; `strict=False` (benches,
    long e2e runs) records violations in `self.violations` and keeps
    going so a gate at the end can report all of them. Either way each
    violation increments
    scheduler_invariant_violations_total{invariant=...}."""

    def __init__(self, metrics=None, strict: bool = True):
        self.metrics = metrics
        self.strict = strict
        self.checks = 0
        self.violations: List[InvariantViolation] = []
        # two-consecutive-checks hysteresis for the eventually-
        # consistent invariants: class -> ids suspect at the last check
        self._suspects: Dict[str, frozenset] = {}

    def _persistent(self, cls: str, ids) -> List[str]:
        """Hysteresis filter: of `ids` suspect now, return those that
        were ALSO suspect at the previous check. Async bind transients
        clear within one round; real leaks persist."""
        cur = frozenset(ids)
        prev = self._suspects.get(cls, frozenset())
        self._suspects[cls] = cur
        return sorted(cur & prev)

    # -- entry ----------------------------------------------------------------

    def check(self, sched) -> List[InvariantViolation]:
        """Run every invariant against `sched`. The caller must hold
        sched._mu and be at a round boundary (no popped wave in
        flight)."""
        self.checks += 1
        found: List[Tuple[str, str, dict]] = []
        areas = sched.queue.area_uids()
        pods = [p for p in sched.store.list("pods")
                if p.status.phase not in ("Succeeded", "Failed")]
        assumed = {p.uid for p in sched.cache.assumed_pods()}

        found += self._check_conservation(sched, pods, areas, assumed)
        found += self._check_double_bind(sched, pods)
        found += self._check_capacity(sched, pods)
        found += self._check_snapshot_usage(sched)
        found += self._check_gang_atomic(sched, pods, assumed)
        found += self._check_state_machine(sched)

        out: List[InvariantViolation] = []
        for invariant, detail, evidence in found:
            digest = self._digest(sched, areas, assumed)
            digest.update(evidence)
            v = InvariantViolation(invariant, detail, digest)
            out.append(v)
            self.violations.append(v)
            if self.metrics is not None:
                self.metrics.invariant_violations.labels(
                    invariant=invariant).inc()
        if out and self.strict:
            raise out[0]
        return out

    # -- the invariants -------------------------------------------------------

    def _check_conservation(self, sched, pods, areas, assumed):
        membership: Dict[str, List[str]] = {}
        for area, uids in areas.items():
            for uid in uids:
                membership.setdefault(uid, []).append(area)
        found = []
        lost: List[str] = []
        double: Dict[str, str] = {}
        for p in pods:
            if not sched._responsible(p):
                continue
            placed = bool(p.spec.node_name) or p.uid in assumed
            queued = membership.get(p.uid, [])
            if placed and queued:
                double[p.uid] = f"{p.uid}(placed+{'+'.join(queued)})"
            elif not placed and len(queued) > 1:
                double[p.uid] = f"{p.uid}({'+'.join(queued)})"
            elif not placed and not queued:
                lost.append(p.uid)
        # disconnected-mode spool (control-plane outage survival): a
        # spooled bind intent is the LEGAL assumed-but-unbound state —
        # but only paired with a live assumption (or the bind already
        # landed), and only while the outage lasts. An intent still
        # spooled with the store path CONNECTED at two consecutive
        # checks means the drain/replay machinery is broken: the next
        # housekeeping pass after a reconnect must drain it.
        spool_fn = getattr(sched, "spool_uids", None)
        spool = spool_fn() if callable(spool_fn) else frozenset()
        bound_uids = {p.uid for p in pods if p.spec.node_name}
        unpaired = [uid for uid in spool
                    if uid not in assumed and uid not in bound_uids]
        health = getattr(sched, "storehealth", None)
        stale = self._persistent(
            "spool_stale",
            spool if (health is not None
                      and health.state == STORE_CONNECTED) else ())
        lost = self._persistent("lost", lost)
        double_ids = self._persistent("double", double)
        unpaired = self._persistent("spool_unpaired", unpaired)
        if unpaired:
            found.append((
                "conservation",
                f"{len(unpaired)} spooled bind intent(s) hold no "
                f"assumption and no binding (capacity not reserved), "
                f"e.g. {_cap(unpaired)[:3]}",
                {"spool_unpaired": _cap(unpaired)}))
        if stale:
            found.append((
                "conservation",
                f"{len(stale)} spooled bind intent(s) outlived the "
                f"outage (store CONNECTED across consecutive checks), "
                f"e.g. {_cap(stale)[:3]}",
                {"spool_stale": _cap(stale)}))
        if lost:
            found.append((
                "conservation",
                f"{len(lost)} pod(s) in no queue area and not "
                f"bound/assumed (lost), e.g. {_cap(lost)[:3]}",
                {"lost": _cap(lost)}))
        if double_ids:
            booked = [double[uid] for uid in double_ids]
            found.append((
                "conservation",
                f"{len(booked)} pod(s) in more than one place, "
                f"e.g. {_cap(booked)[:3]}",
                {"double_booked": _cap(booked)}))
        return found

    def _check_double_bind(self, sched, pods):
        cache_node: Dict[str, str] = {}
        dupes = []
        for name, ni in sched.cache.node_infos.items():
            for p in ni.pods:
                prev = cache_node.get(p.uid)
                if prev is not None and prev != name:
                    dupes.append(f"{p.uid}({prev},{name})")
                else:
                    cache_node[p.uid] = name
        disagree = []
        for p in pods:
            if not p.spec.node_name:
                continue
            cached = cache_node.get(p.uid)
            if cached is not None and cached != p.spec.node_name:
                disagree.append(
                    f"{p.uid}(store={p.spec.node_name},cache={cached})")
        found = []
        if dupes:
            found.append((
                "double_bind",
                f"{len(dupes)} pod(s) hold capacity on two nodes, "
                f"e.g. {_cap(dupes)[:3]}",
                {"cache_dupes": _cap(dupes)}))
        if disagree:
            found.append((
                "double_bind",
                f"{len(disagree)} pod(s) cached on a different node "
                f"than API truth, e.g. {_cap(disagree)[:3]}",
                {"cache_divergence": _cap(disagree)}))
        return found

    def _check_capacity(self, sched, pods):
        used: Dict[str, Dict[str, int]] = {}
        count: Dict[str, int] = {}
        for p in pods:
            node = p.spec.node_name
            if not node:
                continue
            count[node] = count.get(node, 0) + 1
            acc = used.setdefault(node, {})
            for r, q in api.get_resource_request(p).items():
                acc[r] = acc.get(r, 0) + q
        over = []
        for node in sched.store.list("nodes"):
            alloc = node.status.allocatable or {}
            acc = used.get(node.name, {})
            for r in ("cpu", "memory"):
                if r in alloc and acc.get(r, 0) > alloc[r]:
                    over.append(f"{node.name}:{r}={acc[r]}>{alloc[r]}")
            if "pods" in alloc and count.get(node.name, 0) > alloc["pods"]:
                over.append(f"{node.name}:pods="
                            f"{count.get(node.name, 0)}>{alloc['pods']}")
        if over:
            return [(
                "capacity",
                f"{len(over)} node resource(s) over allocatable, "
                f"e.g. {_cap(over)[:3]}",
                {"over_allocatable": _cap(over)})]
        return []

    def _check_snapshot_usage(self, sched):
        snap = sched.snapshot
        idxs = sorted(snap.node_index.values())
        if not idxs:
            return []
        mask = snap.ep_valid.astype(bool)
        sums = np.zeros_like(snap.requested)
        counts = np.zeros_like(snap.pod_count)
        if mask.any():
            np.add.at(sums, snap.ep_node[mask], snap.ep_req[mask])
            np.add.at(counts, snap.ep_node[mask], 1)
        found = []
        idx_arr = np.asarray(idxs)
        req = snap.requested[idx_arr]
        if not np.isfinite(req).all():
            bad = [i for i in idxs
                   if not np.isfinite(snap.requested[i]).all()]
            found.append((
                "snapshot_usage",
                f"non-finite values in the snapshot usage plane on "
                f"node row(s) {bad[:3]}",
                {"nonfinite_rows": _cap(bad)}))
            return found  # comparisons below are meaningless on NaN
        # f32 rounding: memory is bytes (above f32's 24-bit exact
        # range), and summation order differs between the aggregate row
        # and the per-pod rows — compare with a relative tolerance
        close = np.isclose(req, sums[idx_arr], rtol=1e-5, atol=1.0)
        if not close.all():
            bad = [idxs[i] for i in np.nonzero(~close.all(axis=1))[0]]
            ex = bad[0]
            found.append((
                "snapshot_usage",
                f"{len(bad)} node row(s) where snapshot requested != "
                f"sum of resident pod rows, e.g. row {ex}: "
                f"{snap.requested[ex].tolist()} vs "
                f"{sums[ex].tolist()}",
                {"diverged_rows": _cap(bad)}))
        pc = snap.pod_count[idx_arr]
        if not (pc == counts[idx_arr]).all():
            bad = [idxs[i]
                   for i in np.nonzero(pc != counts[idx_arr])[0]]
            found.append((
                "snapshot_usage",
                f"{len(bad)} node row(s) where snapshot pod_count != "
                f"resident row count, e.g. row {bad[0]}: "
                f"{int(snap.pod_count[bad[0]])} vs "
                f"{int(counts[bad[0]])}",
                {"count_rows": _cap(bad)}))
        return found

    def _check_gang_atomic(self, sched, pods, assumed):
        members: Dict[str, List] = {}
        for p in pods:
            key = sched.gangs.key(p)
            if key is not None:
                members.setdefault(key, []).append(p)
        partial: Dict[str, str] = {}
        for key, mem in sorted(members.items()):
            placed = sum(1 for p in mem
                         if p.spec.node_name or p.uid in assumed)
            min_member = sched.gangs.min_member(mem[0])
            if 0 < placed < min(min_member, len(mem)):
                partial[key] = f"{key}({placed}/{min_member})"
        split = [partial[k] for k in self._persistent("gang", partial)]
        if split:
            return [(
                "gang_atomic",
                f"{len(split)} gang(s) partially placed "
                f"(0-or-all violated), e.g. {split[:3]}",
                {"partial_gangs": _cap(split)})]
        return []

    def _check_state_machine(self, sched):
        from ..sched.breaker import OPEN, STATE_CODES

        found = []
        br = sched.breaker
        if br.state not in STATE_CODES:
            found.append(("state_machine",
                          f"breaker in unknown state {br.state!r}", {}))
        if br.failures < 0 or br.trips < 0:
            found.append((
                "state_machine",
                f"breaker counters negative (failures={br.failures}, "
                f"trips={br.trips})", {}))
        if br.state == OPEN and br.trips < 1:
            found.append(("state_machine",
                          "breaker OPEN with zero recorded trips", {}))
        mf = sched.meshfaults
        if mf is not None:
            healthy = set(mf.healthy_names())
            quarantined = set(mf.quarantined_names())
            devices = set(mf.devices)
            if healthy & quarantined:
                found.append((
                    "state_machine",
                    f"device(s) both healthy and quarantined: "
                    f"{_cap(healthy & quarantined)[:3]}", {}))
            if (healthy | quarantined) != devices:
                found.append((
                    "state_machine",
                    "mesh healthy+quarantined does not partition the "
                    "device set", {}))
        wd = sched.watchdog
        if wd is not None and wd.outstanding() > wd.abandoned_total:
            found.append((
                "state_machine",
                f"watchdog outstanding ({wd.outstanding()}) exceeds "
                f"abandoned_total ({wd.abandoned_total})", {}))
        sh = getattr(sched, "storehealth", None)
        if sh is not None:
            from ..sched.storehealth import (DISCONNECTED,
                                             STATE_CODES as SH_CODES)
            if sh.state not in SH_CODES:
                found.append((
                    "state_machine",
                    f"store breaker in unknown state {sh.state!r}", {}))
            if sh.failures < 0 or sh.trips < 0:
                found.append((
                    "state_machine",
                    f"store breaker counters negative "
                    f"(failures={sh.failures}, trips={sh.trips})", {}))
            if sh.state == DISCONNECTED and sh.trips < 1:
                found.append((
                    "state_machine",
                    "store breaker DISCONNECTED with zero recorded "
                    "trips", {}))
        return found

    # -- evidence -------------------------------------------------------------

    def _digest(self, sched, areas, assumed) -> dict:
        pods = sched.store.list("pods")
        bound = [p.uid for p in pods if p.spec.node_name]
        d = {
            "check": self.checks,
            "areas": {k: len(v) for k, v in areas.items()},
            "area_uids": {k: _cap(v) for k, v in areas.items() if v},
            "store_pods": len(pods),
            "bound": len(bound),
            "assumed": _cap(assumed),
            "breaker": {"state": sched.breaker.state,
                        "failures": sched.breaker.failures,
                        "trips": sched.breaker.trips},
        }
        sh = getattr(sched, "storehealth", None)
        if sh is not None:
            spool_fn = getattr(sched, "spool_uids", None)
            d["storehealth"] = {"state": sh.state,
                                "failures": sh.failures,
                                "trips": sh.trips,
                                "spool": _cap(spool_fn())
                                if callable(spool_fn) else []}
        if sched.meshfaults is not None:
            d["mesh"] = {
                "devices": len(sched.meshfaults.devices),
                "quarantined": _cap(
                    sched.meshfaults.quarantined_names())}
        if sched.watchdog is not None:
            d["watchdog"] = {
                "abandoned": sched.watchdog.abandoned_total,
                "outstanding": sched.watchdog.outstanding()}
        return d

    def assert_clean(self) -> None:
        """End-of-run gate for strict=False users (benches, e2e): raise
        the first recorded violation if any round ever failed."""
        if self.violations:
            raise self.violations[0]
