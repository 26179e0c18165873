"""Promotion CI: storm trace-replay under a candidate weight vector.

The bench's storm harness (bench.py --trace) proves the overload plane
against synthetic arrival traces and per-class p99 SLO gates; the
autopilot reuses the same discipline as its promotion CI: before a
candidate may go live, a bounded arrival trace is replayed through an
ISOLATED store + scheduler with the candidate as the live vector, and
the per-class `STORM_SLO_P99` gates must pass — plus a scalar replay
objective (packedness, decisiveness, full placement) that must not
regress against the same replay under the current production weights.

This module is a library, not a bench: it returns a ReplayReport and
never exits the process. The gate constants are the JAX module's, value
for value (tests/test_torch_autopilot.py holds them equal).

A copy of kubernetes_tpu/autopilot/replay.py over the port's
ObjectStore, Scheduler and flight recorder (utils/tracing.py). The one
change: `run_replay` takes `device=` and builds its scheduler there;
None means the CUDA card and raises without one (ops/encoding.py
resolve_device), so promotion CI never quietly runs on the CPU. The
AutopilotController passes the live scheduler's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..api import types as api
from ..utils import tracing

# class -> pod priority (sched/queue.py bands: system >= 2e9,
# high >= 1000, normal > 0, low <= 0)
STORM_PRIORITY = {"system": 2_000_000_000, "high": 10_000,
                  "normal": 10, "low": 0}
# p99 SLO gates in seconds for the PROTECTED classes — the ones above
# the shed threshold, which the overload plane exists to defend (see
# bench.py's storm harness for the full rationale and headroom notes)
STORM_SLO_P99 = {"system": 5.0, "high": 5.0}


def default_trace(wave: int) -> List[Dict[str, int]]:
    """The promotion-CI mini-trace: three ticks at one wave of low
    arrivals with the high/system trickle riding along — enough to
    exercise the priority bands and the score path without turning
    every promotion into a minutes-long storm."""
    return [{"low": wave, "high": 4, "system": 2}] * 3


def _p99(samples: List[float]) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(int(len(s) * 0.99), len(s) - 1)]


def _node(name: str, cpu: str) -> api.Node:
    alloc = api.resource_list(cpu=cpu, memory="32Gi", pods=110)
    return api.Node(
        metadata=api.ObjectMeta(name=name),
        spec=api.NodeSpec(),
        status=api.NodeStatus(capacity=dict(alloc), allocatable=alloc,
                              conditions=[api.NodeCondition(
                                  api.NODE_READY, api.COND_TRUE)]))


def _pod(name: str, cls: str, cpu: str, node_name: str = "") -> api.Pod:
    reqs = api.resource_list(cpu=cpu)
    p = api.Pod(
        metadata=api.ObjectMeta(name=name),
        spec=api.PodSpec(containers=[api.Container(
            name="c",
            resources=api.ResourceRequirements(requests=reqs))]))
    p.spec.priority = STORM_PRIORITY[cls]
    if node_name:
        p.spec.node_name = node_name
    return p


@dataclass
class ReplayReport:
    """One replay's gate verdict + the scalar objective candidates are
    ranked by. objective = placed_frac - 0.5*frag + 0.5*margin_rel:
    place everything, leave free capacity unfragmented, and decide by
    clear margins (margin relative to the score scale, so differently
    scaled weight tables compare fairly)."""

    name: str
    version: str
    placed: int = 0
    total: int = 0
    p99: Dict[str, float] = field(default_factory=dict)
    util: float = 0.0
    frag: float = 0.0
    margin_rel: float = 0.0
    objective: float = 0.0
    passed: bool = True
    failures: List[str] = field(default_factory=list)
    wall_s: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "version": self.version,
            "placed": self.placed, "total": self.total,
            "p99": {c: round(v, 4) for c, v in self.p99.items()},
            "util": round(self.util, 4), "frag": round(self.frag, 4),
            "margin_rel": round(self.margin_rel, 4),
            "objective": round(self.objective, 4),
            "passed": self.passed, "failures": list(self.failures),
            "wall_s": round(self.wall_s, 3)}


def run_replay(weights: Optional[Dict[str, float]] = None, *,
               name: str = "candidate", nodes: int = 4,
               node_cpu: str = "8", pod_cpu: str = "100m",
               wave: int = 16,
               trace: Optional[List[Dict[str, int]]] = None,
               prefill: Optional[Dict[int, int]] = None,
               slo: Optional[Dict[str, float]] = None,
               slo_scale: float = 1.0,
               max_drain: int = 500, device=None) -> ReplayReport:
    """Replay one arrival trace through an isolated store + scheduler.

    weights: the candidate table loaded as the LIVE vector for the
    whole replay (None = the scheduler's static defaults — the
    baseline the controller compares candidates against). prefill
    pre-binds `cores` one-core pods onto node index `i` per {i: cores}
    entry, so tests can shape the cluster the score planes must
    discriminate over. Gates: per-class p99 <= slo[cls] * slo_scale
    and full eventual placement for EVERY class.

    Uses the process-global flight recorder when one is active (the
    replay's rounds ride the live ledger, visible promotion CI); brings
    up and tears down its own otherwise. Margin extraction filters on
    the replay's own weights_version and round ids, so a concurrently
    traced production scheduler only adds noise-free records. The
    replay's scheduler runs on `device` (None: the CUDA card).
    """
    from ..runtime.store import ObjectStore
    from ..sched.scheduler import Scheduler

    rec = tracing.active()
    owned = rec is None
    if owned:
        rec = tracing.enable()
    trace = list(trace) if trace is not None else default_trace(wave)
    slo = dict(STORM_SLO_P99 if slo is None else slo)
    store = ObjectStore()
    for i in range(nodes):
        store.create("nodes", _node(f"rp-n{i}", node_cpu))
    for i, cores in (prefill or {}).items():
        for k in range(int(cores)):
            store.create("pods", _pod(f"rp-pre{i}-{k}", "normal", "1",
                                      node_name=f"rp-n{i}"))
    try:
        sched = Scheduler(store, wave_size=wave, device=device)
    except BaseException:
        # no card for device=None: the recorder this call brought up
        # must not outlive it
        if owned:
            tracing.disable()
        raise
    report = ReplayReport(name=name if weights else "baseline",
                          version="static")
    try:
        if weights:
            sched.weightbook.load_entries(
                [{"name": name, "weights": dict(weights),
                  "role": api.WEIGHT_PROFILE_ROLE_LIVE}])
        report.version = sched.weightbook.live_version()
        # warm the dispatch OUTSIDE the latency clock: the first wave at
        # a shape pays the first upload of the snapshot and, on the
        # card, the first launch at that shape, and a p99 gate must
        # judge scheduling, not warm-up — one throwaway pod takes the
        # hit here, after the candidate is live so its planes are the
        # ones dispatched
        store.create("pods", _pod("rp-warm", "normal", pod_cpu))
        sched.run_once(timeout=60.0)
        t_start = time.monotonic()
        rid_start = rec._next_rid
        created: Dict[str, tuple] = {}  # uid -> (cls, t_enqueue)
        latency: Dict[str, List[float]] = {c: [] for c in STORM_PRIORITY}
        bound: set = set()

        def _scan():
            now = time.monotonic()
            for p in store.list("pods"):
                if p.uid in created and p.uid not in bound \
                        and p.spec.node_name:
                    bound.add(p.uid)
                    cls, t0 = created[p.uid]
                    latency[cls].append(now - t0)

        seq = 0
        for tick in trace:
            for cls, count in tick.items():
                for _ in range(int(count)):
                    p = _pod(f"rp-{cls}-{seq}", cls, pod_cpu)
                    seq += 1
                    obj = store.create("pods", p)
                    created[obj.uid] = (cls, time.monotonic())
            sched.run_once(timeout=5.0)
            _scan()
        # drain: every pod must eventually place (feasibility permitting
        # is the caller's job — the default trace always fits)
        spins = 0
        while len(bound) < len(created) and spins < max_drain:
            n = sched.run_once(timeout=5.0)
            _scan()
            spins = spins + 1 if n == 0 else 0
            if n == 0:
                time.sleep(0.002)
        _scan()
        report.total = len(created)
        report.placed = len(bound)
        report.p99 = {c: _p99(v) for c, v in latency.items() if v}
        # cluster shape after the replay, straight from store truth:
        # cpu utilization and the fragmentation index over free cpu
        free: List[float] = []
        total_alloc = total_req = 0.0
        by_node: Dict[str, float] = {}
        for p in store.list("pods"):
            if p.spec.node_name:
                req = 0.0
                for c in p.spec.containers:
                    # canonical resource maps carry milli-cpu ints
                    # (api.resource_list); units cancel in the ratios
                    req += float((c.resources.requests or {})
                                 .get("cpu", 0))
                by_node[p.spec.node_name] = \
                    by_node.get(p.spec.node_name, 0.0) + req
        for nd in store.list("nodes"):
            alloc = float(nd.status.allocatable.get("cpu", 0))
            used = by_node.get(nd.metadata.name, 0.0)
            total_alloc += alloc
            total_req += used
            free.append(max(alloc - used, 0.0))
        report.util = total_req / total_alloc if total_alloc else 0.0
        total_free = sum(free)
        report.frag = (1.0 - max(free) / total_free) if total_free else 0.0
        # decisiveness: margin-over-runner-up relative to the score
        # scale, from THIS replay's traced rounds only
        margins: List[float] = []
        for row in rec.ledger_rows():
            if row.get("round", 0) < rid_start:
                continue
            if row.get("weights_version") != report.version:
                continue
            sc = row.get("scores")
            if not sc or "margin" not in sc:
                continue
            mean_total = abs(float(sc.get("mean", 0.0)))
            if mean_total > 0:
                margins.append(
                    float(sc["margin"]["mean"]) / mean_total)
        report.margin_rel = (sum(margins) / len(margins)
                             if margins else 0.0)
        placed_frac = report.placed / report.total if report.total else 1.0
        report.objective = (placed_frac - 0.5 * report.frag
                            + 0.5 * min(report.margin_rel, 1.0))
        for cls, bound_s in slo.items():
            p99c = report.p99.get(cls)
            if p99c is not None and p99c > bound_s * slo_scale:
                report.failures.append(
                    f"{cls}-class p99 {p99c*1e3:.0f}ms over its "
                    f"{bound_s*slo_scale*1e3:.0f}ms SLO gate")
        if report.placed < report.total:
            report.failures.append(
                f"{report.total - report.placed} pods never placed")
        report.passed = not report.failures
        report.wall_s = time.monotonic() - t_start
        return report
    finally:
        sched.close()
        if owned:
            tracing.disable()
