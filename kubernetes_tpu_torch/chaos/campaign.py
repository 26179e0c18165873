"""Seeded chaos-campaign runner with failing-schedule shrinking.

A copy of kubernetes_tpu/chaos/campaign.py on the port's scheduler: the
same schedule space, sampler, scenario, shrinker and outcomes, over the
port's fault registry (KTPU_TORCH_FAULTPOINTS). The JAX copy pins jax
to the CPU; this one runs where `device` says — None is the CUDA card
(ops/encoding.py resolve_device), and without a card it raises rather
than running on the CPU. Tests pass device="cpu".

The reference's chaos suite (test/e2e/chaosmonkey) kills whole
components and asserts the cluster recovers. This framework's failure
surface is finer-grained — ~25 named fault points (utils/faultpoints)
across the kernel, bind, watch, snapshot, mesh, and poison planes — so
its chaosmonkey analog composes those points into randomized fault
*schedules*:

  FaultSpec(point, mode, arg, times, tick)

A schedule is 2-4 specs (sometimes seeded from NASTY_PAIRS, the
combinations most likely to interact) fired at virtual-clock ticks of
a fixed kubemark scenario: a small HollowCluster, a steady pod
arrival stream, two gangs (one that fits, one that never does), a
node-status heartbeat per tick, and the invariant checker
(chaos/invariants.py) armed after every scheduling round. A correct
scheduler tolerates EVERY such schedule with zero invariant
violations — the faults are all recoverable by construction (breaker,
watchdog, bind reconciler, poison isolation...).

When a schedule DOES violate an invariant, the campaign shrinks it:
greedy removal of whole specs, then tick normalization (fire at t=0),
then times reduction — each step re-replayed, kept only while the
violation still reproduces. The minimal schedule is emitted as a
ready-to-paste `KTPU_TORCH_FAULTPOINTS` string plus the campaign seed, so
the reproducer re-triggers with zero campaign machinery:

  KTPU_TORCH_FAULTPOINTS='snapshot.write=corrupt::4' \
      python -m kubernetes_tpu_torch.chaos --repro --seed 7

Determinism: the workload is derived from the seed alone (never from
the schedule), so shrinking never perturbs the scenario; the virtual
clock advances one second per tick; latency args are small and
bounded so wall time stays bounded.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import faultpoints
from .invariants import InvariantChecker, InvariantViolation

# -- the fault-schedule space -----------------------------------------------
#
# point -> modes a correct scheduler must tolerate without invariant
# violations in the campaign scenario. Deliberately narrower than the
# full registry: modes that model UPSTREAM data loss the scheduler
# cannot observe (watch.deliver=drop swallows the pod-add event itself)
# would trip conservation on a healthy build, and points whose
# subsystem is not running in the scenario (autoscaler, autopilot,
# REST informers) would never fire. Everything here is expressible as
# a KTPU_TORCH_FAULTPOINTS token (no custom fn/exc), so every shrunk
# reproducer is a paste-able env string.
SAMPLABLE: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("kernel.wave", ("raise", "latency")),
    ("kernel.round", ("raise", "latency")),
    ("kernel.gang", ("raise", "latency")),
    ("kernel.hang", ("latency",)),
    ("device.lost", ("raise",)),
    ("queue.shed", ("drop",)),
    ("bind.post", ("raise", "latency", "drop")),
    ("watch.deliver", ("latency",)),
    ("snapshot.write", ("corrupt", "latency")),
    ("heartbeat.deliver", ("drop", "latency")),
    ("featurize.poison", ("raise",)),
    ("wave.poison", ("raise",)),
    ("queue.quarantine", ("drop",)),
    ("lease.renew", ("raise", "drop")),
    # control-plane outage: severs bind POSTs and truth GETs together;
    # sampled times (1-3) stay below the spool threshold (3 failed
    # attempts trip the breaker, the 4th fire darkens the truth GET),
    # so a healthy build conserves without ever spooling — duration
    # outages are driven explicitly by the outage tests/bench
    ("store.outage", ("raise",)),
    # capacity chaos: a raise here models HBM RESOURCE_EXHAUSTED at the
    # dispatch seam — the capacity-fault ladder must compact and retry
    # without a device conviction, a mesh reform, or a pod conviction
    ("device.oom", ("raise",)),
    # compaction chaos: a crash or stall at the compaction entry must
    # leave the live snapshot untouched (the scratch rebuild only swaps
    # in after it fully succeeds)
    ("snapshot.compact", ("raise", "latency")),
)

# point-pairs with a history of interacting badly: a device
# loss racing a poison conviction, a wedged dispatch while heartbeats
# stop, a failing bind POST while leadership is in doubt. The sampler
# seeds roughly a third of its schedules from one of these.
NASTY_PAIRS: Tuple[Tuple[Tuple[str, str], Tuple[str, str]], ...] = (
    (("device.lost", "raise"), ("wave.poison", "raise")),
    (("kernel.hang", "latency"), ("heartbeat.deliver", "drop")),
    (("bind.post", "raise"), ("lease.renew", "raise")),
    # a capacity fault whose recovery compaction itself crashes: the
    # ladder must salvage through the host twin (guarded compact),
    # never wedge the round or trip the breaker via a false conviction
    (("device.oom", "raise"), ("snapshot.compact", "raise")),
)

_LATENCY_ARGS = (0.005, 0.01, 0.02)


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault point inside a schedule. `tick` is the virtual-
    clock tick (0-based) the point is activated at; `times` bounds how
    many fires apply (faultpoints semantics, never None here so
    reproducer strings stay bounded)."""

    point: str
    mode: str
    arg: float = 0.0
    times: int = 1
    tick: int = 0

    def token(self) -> str:
        """The KTPU_TORCH_FAULTPOINTS token for this spec (tick elided: env
        activation arms at process start)."""
        if self.mode == "latency":
            return f"{self.point}={self.mode}:{self.arg}:{self.times}"
        return f"{self.point}={self.mode}::{self.times}"


def env_string(specs: Sequence[FaultSpec]) -> str:
    """The ready-to-paste KTPU_TORCH_FAULTPOINTS string for a schedule."""
    return ",".join(s.token() for s in specs)


@dataclass
class ReplayOutcome:
    violation: Optional[str] = None  # invariant name, or None = clean
    detail: str = ""
    digest: dict = field(default_factory=dict)
    injected: Dict[str, int] = field(default_factory=dict)
    placed: int = 0
    checks: int = 0

    @property
    def violated(self) -> bool:
        return self.violation is not None


@dataclass
class Finding:
    """One violating schedule, shrunk."""

    seed: int
    schedule: List[FaultSpec]
    minimal: List[FaultSpec]
    outcome: ReplayOutcome
    env: str  # KTPU_TORCH_FAULTPOINTS string of the minimal schedule
    env_retriggers: bool  # replaying the env form alone still violates


@dataclass
class CampaignResult:
    seed: int
    schedules: int = 0
    injected_total: int = 0
    checks_total: int = 0
    findings: List[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings


# -- schedule sampling ------------------------------------------------------

def sample_schedule(rng: random.Random) -> List[FaultSpec]:
    """2-4 fault specs at ticks 0..5; ~1/3 of schedules start from a
    NASTY_PAIRS combination, the rest draw independently from
    SAMPLABLE. Points are distinct within one schedule (faultpoints
    keeps one active fault per point)."""
    specs: List[FaultSpec] = []
    taken = set()

    def add(point: str, mode: str):
        if point in taken:
            return
        taken.add(point)
        arg = rng.choice(_LATENCY_ARGS) if mode == "latency" else 0.0
        times = rng.randint(2, 4) if mode == "corrupt" else rng.randint(1, 3)
        specs.append(FaultSpec(point=point, mode=mode, arg=arg,
                               times=times, tick=rng.randrange(6)))

    if rng.random() < 0.34:
        for point, mode in rng.choice(NASTY_PAIRS):
            add(point, mode)
    want = rng.randint(2, 4)
    while len(specs) < want:
        point, modes = rng.choice(SAMPLABLE)
        add(point, rng.choice(modes))
    specs.sort(key=lambda s: (s.tick, s.point))
    return specs


# -- the replay scenario ----------------------------------------------------

def _mk_pod(name: str, cpu: int, priority: int = 0,
            gang: Optional[str] = None, min_member: int = 0):
    from ..api import types as api

    p = api.Pod(
        metadata=api.ObjectMeta(name=name, namespace="default"),
        spec=api.PodSpec(
            priority=priority,
            containers=[api.Container(
                name="c",
                resources=api.ResourceRequirements(
                    requests={"cpu": cpu, "memory": 64 << 20}))]))
    if gang:
        p.metadata.annotations = {
            "pod-group.scheduling.k8s.io/name": gang,
            "pod-group.scheduling.k8s.io/min-available": str(min_member)}
    return p


def _workload(seed: int, ticks: int) -> Dict[int, list]:
    """tick -> pods arriving at that tick. Derived from the seed ALONE
    (never the fault schedule), so shrinking a schedule replays the
    identical scenario. The mix: a trickle of small plain pods (some
    below the shed priority threshold), a 2-member gang that fits, and
    a 3x9000m gang that can never fit 2 hollow nodes — it retries
    every round, keeping the joint-assignment + recheck path hot under
    whatever faults are armed."""
    rng = random.Random(seed * 7919 + 17)
    arrivals: Dict[int, list] = {t: [] for t in range(ticks)}
    n = 0
    for t in range(ticks):
        for _ in range(rng.randint(0, 2)):
            arrivals[t].append(_mk_pod(
                f"load-{seed}-{n}", cpu=rng.choice((100, 250)),
                priority=rng.choice((0, 1500))))
            n += 1
    fit_tick = rng.randrange(max(1, ticks // 2))
    arrivals[fit_tick].extend(
        _mk_pod(f"gfit-{seed}-{i}", cpu=4000, gang=f"gfit-{seed}",
                min_member=2) for i in range(2))
    big_tick = rng.randrange(max(1, ticks // 2))
    arrivals[big_tick].extend(
        _mk_pod(f"gbig-{seed}-{i}", cpu=9000, gang=f"gbig-{seed}",
                min_member=3) for i in range(3))
    return arrivals


def replay(specs: Sequence[FaultSpec], seed: int, ticks: int = 8,
           env_spec: Optional[str] = None,
           configure: Optional[Callable] = None,
           journal_path: Optional[str] = None,
           restart_tick: Optional[int] = None,
           device=None) -> ReplayOutcome:
    """Replay one fault schedule against the seeded scenario with the
    invariant checker armed. Returns the outcome; never raises for a
    violation (the campaign decides what to do with it).

    env_spec: instead of tick-scheduled activation, arm this
    KTPU_TORCH_FAULTPOINTS string before the first tick — the reproducer
    path, verifying a shrunk schedule re-triggers in its env form.
    configure: optional hook(sched) run before the first tick (the
    deliberately-broken-build acceptance test disables the gang
    rollback through it).
    journal_path: durable bind-intent journal for the scenario
    scheduler (control-plane outage coverage).
    restart_tick: kill -9 analog — at this tick the scheduler is
    abandoned mid-flight (no drain, no farewell) and a fresh one is
    constructed over the same store + journal; construction replays
    the journal before its first wave, and the same invariant checker
    keeps watching across the restart.
    device: where the scenario's scheduler runs (None: the CUDA card;
    raises without one)."""
    from ..kubemark.hollow import HollowCluster
    from ..ops.encoding import Caps, resolve_device
    from ..runtime.store import ObjectStore
    from ..sched.scheduler import Scheduler

    device = resolve_device(device)
    by_tick: Dict[int, List[FaultSpec]] = {}
    for s in specs:
        by_tick.setdefault(s.tick, []).append(s)
    arrivals = _workload(seed, ticks)

    faultpoints.reset()
    store = ObjectStore()
    vclock = [1000.0]

    def _mk_sched() -> "Scheduler":
        s = Scheduler(store, wave_size=8, caps=Caps(M=64, P=16, LV=64),
                      device=device,
                      clock=lambda: vclock[0], shed_watermark=8,
                      shed_age_s=1.0,
                      # short, deterministic store-probe window: the
                      # jitter pin makes retry_at = trip + cooldown
                      # exactly, so outage recovery is tick-predictable
                      store_breaker_cooldown=2.0,
                      # housekeeping compaction cadence: gives the
                      # snapshot.compact chaos point a fire path in
                      # schedules that churn rows (the oom ladder's
                      # forced compactions fire it regardless)
                      compact_interval=2.0,
                      bind_journal_path=journal_path)
        s.storehealth.jitter = lambda: 0.5
        return s

    sched = _mk_sched()
    checker = InvariantChecker(metrics=sched.metrics, strict=True)
    sched.invariants = checker
    if configure is not None:
        configure(sched)
    # racks/generations stamped so fault injection also exercises the
    # dense topology columns (rack_id/superpod_id/accel_gen scatter).
    cluster = HollowCluster(store, 2, racks=2, generations=2,
                            clock=lambda: vclock[0])
    out = ReplayOutcome()
    try:
        for node in cluster.nodes:
            node.kubelet.register_node()
        if env_spec is not None:
            faultpoints.activate_spec(env_spec)
        for t in range(ticks + 2):  # +2 drain ticks, faults quiescent
            if restart_tick is not None and t == restart_tick:
                sched = _mk_sched()
                sched.invariants = checker
                if configure is not None:
                    configure(sched)
            for s in by_tick.get(t, ()):
                faultpoints.activate(s.point, s.mode, arg=s.arg,
                                     times=s.times)
            vclock[0] += 1.0
            # the scenario's node-status plane: one heartbeat per tick
            # (also what carries a snapshot.write corruption into the
            # topo upload group — see state/snapshot.py update_node)
            cluster.nodes[t % len(cluster.nodes)].kubelet.heartbeat()
            for pod in arrivals.get(t, ()):
                store.create("pods", pod)
            out.placed += sched.run_once()
            out.placed += sched.run_once()
    except InvariantViolation as v:
        out.violation = v.invariant
        out.detail = v.detail
        out.digest = v.digest
    finally:
        out.checks = checker.checks
        out.injected = {s.point: faultpoints.hits(s.point) for s in specs}
        if env_spec is not None:
            for name, _, _, _ in faultpoints.parse(env_spec):
                out.injected[name] = faultpoints.hits(name)
        faultpoints.reset()
        sched.close()
    return out


# -- shrinking --------------------------------------------------------------

def shrink(specs: Sequence[FaultSpec], seed: int, ticks: int = 8,
           configure: Optional[Callable] = None,
           log: Optional[Callable[[str], None]] = None,
           device=None) -> Tuple[List[FaultSpec], ReplayOutcome]:
    """Greedily minimize a violating schedule: drop whole specs, then
    normalize surviving ticks to 0, then reduce times to 1 — keeping
    each step only if the violation still reproduces. Returns the
    minimal schedule and its replay outcome."""

    def still_violates(cand: Sequence[FaultSpec]) -> Optional[ReplayOutcome]:
        o = replay(cand, seed, ticks=ticks, configure=configure,
                   device=device)
        return o if o.violated else None

    cur = list(specs)
    best = still_violates(cur)
    if best is None:  # flaked? caller decides; report the original
        return cur, replay(cur, seed, ticks=ticks, configure=configure,
                           device=device)
    # pass 1: drop specs
    changed = True
    while changed and len(cur) > 1:
        changed = False
        for i in range(len(cur)):
            cand = cur[:i] + cur[i + 1:]
            o = still_violates(cand)
            if o is not None:
                if log:
                    log(f"shrink: dropped {cur[i].token()}")
                cur, best, changed = cand, o, True
                break
    # pass 2: fire everything at tick 0 (makes the schedule exactly
    # reproducible as a KTPU_TORCH_FAULTPOINTS env activation)
    cand = [replace(s, tick=0) for s in cur]
    if any(s.tick for s in cur):
        o = still_violates(cand)
        if o is not None:
            if log:
                log("shrink: normalized ticks to 0")
            cur, best = cand, o
    # pass 3: minimum times budget
    for i, s in enumerate(cur):
        while s.times > 1:
            cand_spec = replace(s, times=s.times - 1)
            cand = cur[:i] + [cand_spec] + cur[i + 1:]
            o = still_violates(cand)
            if o is None:
                break
            if log:
                log(f"shrink: {s.point} times -> {cand_spec.times}")
            s = cand_spec
            cur, best = cand, o
    return cur, best


# -- the campaign -----------------------------------------------------------

def run_campaign(seed: int, schedules: int, ticks: int = 8,
                 budget_s: Optional[float] = None,
                 configure: Optional[Callable] = None,
                 log: Optional[Callable[[str], None]] = None,
                 device=None) -> CampaignResult:
    """Sample and replay `schedules` fault schedules; shrink every
    violation to a minimal reproducer and verify its env-string form
    re-triggers. budget_s (wall seconds, monotonic) stops sampling
    early — the schedules already run still count. device as replay's
    (None: the CUDA card; raises without one, before any schedule)."""
    import time as _time

    from ..ops.encoding import resolve_device

    device = resolve_device(device)
    rng = random.Random(seed)
    result = CampaignResult(seed=seed)
    t0 = _time.monotonic()
    for i in range(schedules):
        if budget_s is not None and _time.monotonic() - t0 > budget_s:
            if log:
                log(f"budget exhausted after {i} schedules")
            break
        specs = sample_schedule(rng)
        out = replay(specs, seed, ticks=ticks, configure=configure,
                     device=device)
        result.schedules += 1
        result.checks_total += out.checks
        result.injected_total += sum(out.injected.values())
        if log:
            status = out.violation or "ok"
            log(f"[{i + 1}/{schedules}] {env_string(specs)} -> {status}")
        if not out.violated:
            continue
        minimal, mo = shrink(specs, seed, ticks=ticks,
                             configure=configure, log=log, device=device)
        env = env_string(minimal)
        env_ok = replay((), seed, ticks=ticks, env_spec=env,
                        configure=configure, device=device).violated
        result.findings.append(Finding(
            seed=seed, schedule=list(specs), minimal=minimal,
            outcome=mo, env=env, env_retriggers=env_ok))
        if log:
            log(f"  VIOLATION {mo.violation}: minimal reproducer "
                f"KTPU_TORCH_FAULTPOINTS='{env}' --seed {seed} "
                f"(env re-triggers: {env_ok})")
    return result
