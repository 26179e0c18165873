"""Scheduler component configuration.

A copy of kubernetes_tpu/sched/config.py; its relative imports resolve in this
package.

Analog of the KubeSchedulerConfiguration component-config object
(pkg/apis/componentconfig/types.go:79) + the algorithm source selection
(provider name or Policy file) and leader-election config the reference
loads in cmd/kube-scheduler/app/options. Loadable from YAML or JSON.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class LeaderElectionConfig:
    leader_elect: bool = False
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    lock_name: str = "kube-scheduler"


@dataclass
class KubeSchedulerConfiguration:
    scheduler_name: str = "default-scheduler"
    # algorithm source: named provider (DefaultProvider) or policy file
    algorithm_provider: str = "DefaultProvider"
    policy_config_file: str = ""
    hard_pod_affinity_symmetric_weight: int = 1
    disable_preemption: bool = False
    leader_election: LeaderElectionConfig = field(
        default_factory=LeaderElectionConfig)
    healthz_port: int = 10251  # reference default insecure port
    # TPU-wave specifics (no reference analog: the wave replaces the
    # one-pod cycle)
    wave_size: int = 128
    # mesh-sharded scheduling plane: shard the snapshot's node axis
    # across this many devices (parallel/mesh.py; 0 = single device,
    # -1 = every visible device). Placements are bit-identical to
    # single-device — GSPMD partitioning is an execution strategy, not
    # a semantic change (tests/test_mesh.py asserts it).
    mesh_devices: int = 0
    # mesh fault tolerance: the degradation ladder's floor. A device
    # loss reforms the mesh down one power-of-two rung (8 -> 4 -> 2 ->
    # 1) as long as at least this many devices survive; below the
    # floor the failure feeds the whole-path breaker instead (host-twin
    # rung). 1 = ride the ladder all the way down.
    mesh_min_devices: int = 1
    # robustness layer: periodic snapshot-scrub cadence in seconds
    # (0 disables the cadence; SIGUSR2 always triggers one, the
    # cache_comparer.go analog) and the device-path circuit breaker's
    # consecutive-failure threshold / open-state cooldown
    scrub_interval: float = 0.0
    breaker_threshold: int = 3
    breaker_cooldown: float = 30.0
    # memory-governance plane (state/scrubber.py compaction +
    # state/snapshot.py HBM budget governor — the kubelet
    # eviction-manager analog for device memory): cadence in seconds
    # between housekeeping compaction sweeps (0 disables the cadence;
    # the OOM-recovery ladder and the governor can still force one)
    # and the projected-HBM budget in bytes above which a snapshot
    # grow compacts first instead of letting the backend throw
    # RESOURCE_EXHAUSTED (0 = unbudgeted)
    compact_interval: float = 0.0
    hbm_budget_bytes: int = 0
    # bind reconciler: POST attempts per bind before the GET-based
    # succeeded-but-response-lost resolution kicks in
    bind_max_attempts: int = 3
    # control-plane outage survival (sched/storehealth.py +
    # state/journal.py): consecutive store failures across
    # bind/GET/LIST before the store-path breaker declares
    # DISCONNECTED, the jittered half-open probe cooldown, the durable
    # bind-intent journal path ("" disables durability — the spool is
    # then memory-only and a crash mid-outage loses it, the reference's
    # exposure), the journal segment cap (-1 = state/journal.py
    # default), and the spool watermark above which new sheddable
    # admissions are held in the shed area (0 = never hold)
    store_breaker_threshold: int = 3
    store_breaker_cooldown: float = 30.0
    bind_journal_path: str = ""
    bind_journal_max_bytes: int = -1
    spool_watermark: int = 0
    # overload control (sched/queue.py "Overload control" +
    # utils/watchdog.py): shed_watermark bounds the non-shed pending
    # depth (0 disables shedding); pods below shed_priority_threshold
    # park in the shed area past the watermark and age back into the
    # active heap after shed_age_s (starvation-proof);
    # wave_deadline_s (0 disables) budgets every device dispatch via
    # the watchdog — an exceeded dispatch is abandoned, trips the
    # breaker, and the round salvages through the hostwave twin — and
    # drives the per-round host-stage accounting that adaptively
    # shrinks the wave size under overload
    shed_watermark: int = 0
    shed_priority_threshold: int = 1000
    shed_age_s: float = 30.0
    wave_deadline_s: float = 0.0
    # observability: flight recorder (per-pod span tracing served at
    # /debug/trace, opt-in like --profiling), its round ring-buffer
    # depth, and the optional per-round JSONL ledger path
    tracing: bool = False
    trace_rounds: int = 64
    round_ledger_path: str = ""
    # ledger size cap in bytes: the file rotates to "<path>.1" (one
    # generation kept) before exceeding it; 0 disables rotation, -1
    # keeps the tracing default (utils/tracing.py LEDGER_MAX_BYTES)
    round_ledger_max_bytes: int = -1
    # shadow-scoring observatory (sched/weights.py): candidate/live
    # WeightProfiles preloaded from a JSON file (the store-watched
    # `weightprofiles` kind is the dynamic path); exact mode replays
    # the first wave of every Nth traced round through the numpy twin
    # under each candidate — exact divergence, calibrating the top-K
    # lower bound (0 disables). Shadow scoring itself rides the traced
    # decomposition, so it needs `tracing` on.
    weight_profiles_path: str = ""
    shadow_exact_interval: int = 0
    # runtime race detection (`--racecheck`): instrument the scheduler
    # and queue locks with utils/racecheck.py's LockOrderWatcher — the
    # `go test -race` analog. Lock names match the static lock graph
    # extracted by kubernetes_tpu/analysis, so observed edges are
    # directly diffable against ktpu-lint's lock-discipline rule.
    # Dev/test switch: each acquisition pays a dict+list bookkeeping hit.
    racecheck: bool = False
    # continuously-checked cluster invariants (`--invariants`): arm the
    # chaos/invariants.py checker after every scheduling round —
    # conservation, double-bind, capacity, snapshot-vs-residents, gang
    # atomicity, breaker/mesh/watchdog sanity. A violation raises
    # InvariantViolation with a state digest. Chaos/dev switch: each
    # round pays an O(pods + nodes) sweep; off costs one None check.
    invariants: bool = False
    # informer kinds mirrored before scheduling starts
    feature_gates: dict = field(default_factory=dict)

    @staticmethod
    def load(path: str) -> "KubeSchedulerConfiguration":
        text = open(path).read()
        if text.lstrip().startswith("{"):
            data = json.loads(text)
        else:
            import yaml
            data = yaml.safe_load(text) or {}
        cfg = KubeSchedulerConfiguration()
        le = data.pop("leaderElection", None) or {}
        for k, v in data.items():
            snake = "".join("_" + c.lower() if c.isupper() else c for c in k)
            if hasattr(cfg, snake):
                setattr(cfg, snake, v)
        for k, v in le.items():
            snake = "".join("_" + c.lower() if c.isupper() else c for c in k)
            if hasattr(cfg.leader_election, snake):
                setattr(cfg.leader_election, snake, v)
        return cfg
