"""Prometheus-style metrics registry: a copy of the JAX package's
kubernetes_tpu/utils/metrics.py, which imports nothing but the standard
library. The registry declares every series of the JAX scheduler; the
port's scheduler observes those of the machinery it carries (see
kubernetes_tpu_torch/sched/scheduler.py), and the rest stay at zero.

Analog of pkg/scheduler/metrics/metrics.go:30-87 — the same series names
are registered so dashboards built against the reference carry over:
e2e_scheduling_latency, scheduling_algorithm_latency,
scheduling_algorithm_predicate_evaluation,
scheduling_algorithm_priority_evaluation,
scheduling_algorithm_preemption_evaluation, binding_latency,
pod_preemption_victims, total_preemption_attempts.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional


def bounded_label(value: str, allowed: Iterable[str],
                  other: str = "Other") -> str:
    """Clamp a dynamic label value to a known set, bucketing everything
    else into `other` — the cardinality guard for labels fed from free
    text (predicate names from extenders, plugin messages). A label
    value minted per unique string grows /metrics without bound and can
    break exposition parsing; ktpu-lint's metrics-hygiene rule requires
    dynamic label values to route through this helper or come from a
    family's declared value set."""
    v = str(value)
    return v if v in allowed else other


class Counter:
    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, delta: float = 1.0):
        with self._lock:
            self.value += delta


class Gauge:
    """A value that can go down (prometheus Gauge) — queue depths,
    in-flight counts, target sizes. Counters only ever accumulate, so
    exporting a queue depth through one (the only pre-existing type)
    would be a lie the first time the queue drains."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self.value = float(v)

    def inc(self, delta: float = 1.0):
        with self._lock:
            self.value += delta

    def dec(self, delta: float = 1.0):
        with self._lock:
            self.value -= delta


class _LabelDecl:
    """Per-family label-cardinality declaration, checked at labels()
    time. `values` maps a label name to its closed value set — an
    undeclared value raises, so a free-text leak fails the first test
    that exercises it instead of growing /metrics forever. `open_labels`
    names labels that are *intentionally* unbounded (zones, resources,
    devices) and therefore pruned via remove()/zeroing when their
    subject disappears. ktpu-lint's metrics-hygiene rule reads the same
    declarations statically."""

    def __init__(self, labelnames, values, open_labels):
        self.values: Dict[str, frozenset] = {
            k: frozenset(v) for k, v in (values or {}).items()}
        self.open_labels = frozenset(open_labels or ())
        for ln in list(self.values) + list(self.open_labels):
            if ln not in labelnames:
                raise ValueError(f"declared label {ln!r} not in {labelnames}")

    def check(self, family: str, labelnames, key) -> None:
        for ln, v in zip(labelnames, key):
            allowed = self.values.get(ln)
            if allowed is not None and v not in allowed:
                raise ValueError(
                    f"{family}: label {ln}={v!r} outside the declared "
                    f"value set {sorted(allowed)} — extend the family's "
                    f"values= declaration or bucket through "
                    f"bounded_label()")


class LabeledCounter:
    """Counter family over a fixed label set; children render in
    Prometheus exposition form (`name{stage="bind"} 3`). The reference
    registers scheduling error series with a stage label
    (metrics.go `scheduling_errors`-style vectors); this is the minimal
    analog the registry + /metrics endpoint can serve.

    `values=` declares a closed per-label value set (enforced here,
    checked statically by ktpu-lint); `open_labels=` marks labels whose
    value space is intentionally open (see _LabelDecl)."""

    def __init__(self, name: str, labelnames=("stage",), help_: str = "",
                 values: Optional[Dict[str, Iterable[str]]] = None,
                 open_labels: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.decl = _LabelDecl(self.labelnames, values, open_labels)
        self._children: Dict[tuple, Counter] = {}
        self._lock = threading.Lock()

    def labels(self, **kw) -> Counter:
        # a label omitted by the caller defaults to "" and is dropped
        # from the rendered series (Prometheus treats an empty label
        # value as absent) — so a family can grow a dimension (e.g.
        # scheduling_errors_total's `device`) without touching every
        # existing call site or renaming their series
        key = tuple(str(kw.get(ln, "")) for ln in self.labelnames)
        self.decl.check(self.name, self.labelnames, key)
        with self._lock:
            c = self._children.get(key)
            if c is None:
                rendered = ",".join(
                    f'{ln}="{v}"' for ln, v in zip(self.labelnames, key)
                    if v != "")
                c = Counter(f"{self.name}{{{rendered}}}")
                self._children[key] = c
            return c

    def value(self, **kw) -> float:
        key = tuple(str(kw.get(ln, "")) for ln in self.labelnames)
        with self._lock:
            c = self._children.get(key)
            return c.value if c is not None else 0.0

    def total(self) -> float:
        with self._lock:
            return sum(c.value for c in self._children.values())

    def children(self) -> List[Counter]:
        with self._lock:
            return list(self._children.values())


class LabeledGauge:
    """Gauge family over a fixed label set (mirrors LabeledCounter —
    children render as `name{queue="active"} 3`, same values=/open_labels=
    cardinality declarations)."""

    def __init__(self, name: str, labelnames=("queue",), help_: str = "",
                 values: Optional[Dict[str, Iterable[str]]] = None,
                 open_labels: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.decl = _LabelDecl(self.labelnames, values, open_labels)
        self._children: Dict[tuple, Gauge] = {}
        self._lock = threading.Lock()

    def labels(self, **kw) -> Gauge:
        # omitted labels default to "" and are dropped from the rendered
        # series — same dimension-growth contract as LabeledCounter
        key = tuple(str(kw.get(ln, "")) for ln in self.labelnames)
        self.decl.check(self.name, self.labelnames, key)
        with self._lock:
            g = self._children.get(key)
            if g is None:
                rendered = ",".join(
                    f'{ln}="{v}"' for ln, v in zip(self.labelnames, key)
                    if v != "")
                g = Gauge(f"{self.name}{{{rendered}}}")
                self._children[key] = g
            return g

    def value(self, **kw) -> float:
        key = tuple(str(kw.get(ln, "")) for ln in self.labelnames)
        with self._lock:
            g = self._children.get(key)
            return g.value if g is not None else 0.0

    def remove(self, **kw) -> None:
        """Drop a child series so /metrics stops exporting it — a gauge
        whose subject disappeared (a deleted zone, a drained resource)
        must vanish, not freeze at its last value."""
        key = tuple(str(kw[ln]) for ln in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    def children(self) -> List[Gauge]:
        with self._lock:
            return list(self._children.values())


class Histogram:
    """Fixed-bucket histogram (reference uses exponential buckets starting
    at 1ms: prometheus.ExponentialBuckets(1000, 2, 15) in microseconds).

    Alongside the export buckets, a bounded reservoir of raw observations
    backs `quantile` so it reports a real number even past the top bucket
    — the bucket-only estimate saturated to the 16.4s ceiling (or inf)
    exactly at the drain-heavy scales the benchmark cares about."""

    RESERVOIR = 1 << 16

    def __init__(self, name: str, help_: str = "", buckets: Optional[List[float]] = None):
        self.name = name
        self.help = help_
        self.buckets = buckets or [0.001 * (2**i) for i in range(20)]
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0
        self.max = 0.0
        self._samples: List[float] = []
        # sorted-reservoir cache: bench reporting calls quantile() per
        # percentile, and re-sorting up to 64k samples each time was
        # O(quantiles * n log n); observe() invalidates
        self._sorted: Optional[List[float]] = None
        # deterministic LCG for reservoir sampling — keeps tests seedless
        self._rng = 0x2545F4914F6CDD1D
        self._lock = threading.Lock()

    def observe(self, v: float):
        with self._lock:
            self._sorted = None
            self.sum += v
            self.total += 1
            if v > self.max:
                self.max = v
            if len(self._samples) < self.RESERVOIR:
                self._samples.append(v)
            else:
                # Vitter's algorithm R: replace a uniform index with
                # probability RESERVOIR/total
                self._rng = (self._rng * 6364136223846793005 + 1442695040888963407) & (2**64 - 1)
                j = self._rng % self.total
                if j < self.RESERVOIR:
                    self._samples[j] = v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Quantile from the raw-sample reservoir (exact until the
        reservoir cap, sampled beyond); always finite."""
        with self._lock:
            if self.total == 0:
                return 0.0
            if self._sorted is None:
                self._sorted = sorted(self._samples)
            s = self._sorted
            idx = min(int(math.ceil(q * len(s))) - 1, len(s) - 1)
            return s[max(idx, 0)]


class Metrics:
    """Registry with the reference scheduler's series pre-registered."""

    def __init__(self):
        self.e2e_scheduling_latency = Histogram("e2e_scheduling_latency")
        # per-POD latency from first enqueue to assume+bind-dispatch (the
        # BASELINE target tracks p99 schedule latency alongside
        # throughput; e2e_scheduling_latency spans whole waves/rounds)
        self.pod_scheduling_latency = Histogram("pod_scheduling_latency")
        self.scheduling_algorithm_latency = Histogram("scheduling_algorithm_latency")
        self.predicate_evaluation = Histogram("scheduling_algorithm_predicate_evaluation")
        self.priority_evaluation = Histogram("scheduling_algorithm_priority_evaluation")
        self.preemption_evaluation = Histogram("scheduling_algorithm_preemption_evaluation")
        self.binding_latency = Histogram("binding_latency")
        self.pod_preemption_victims = Counter("pod_preemption_victims")
        self.total_preemption_attempts = Counter("total_preemption_attempts")
        self.schedule_attempts = Counter("schedule_attempts_total")
        # gang (coscheduling) series: attempts counts whole-gang placement
        # tries; wait_seconds spans first-member-parked -> gang released
        # into the active queue (minMember reached)
        self.gang_schedule_attempts = Counter("gang_schedule_attempts_total")
        self.gang_wait_seconds = Histogram("gang_wait_seconds")
        self.pods_scheduled = Counter("pods_scheduled_total")
        self.pods_failed = Counter("pods_failed_total")
        # robustness layer: per-stage error attribution (bind worker /
        # device wave / extender webhook / device dispatch), snapshot
        # scrubber audit series, and device-path circuit-breaker trips.
        # `device` is filled only by stage=dispatch (ops/kernel.py
        # record_dispatch attributes the culprit mesh device, bounded to
        # the active set + "unknown"); every other site omits it and
        # keeps its un-suffixed series
        self.scheduling_errors = LabeledCounter("scheduling_errors_total",
                                                ("stage", "device"),
                                                open_labels=("device",))
        self.snapshot_scrub_runs = Counter("snapshot_scrub_runs_total")
        self.snapshot_scrub_divergences = Counter(
            "snapshot_scrub_divergences_total")
        self.snapshot_scrub_repairs = Counter("snapshot_scrub_repairs_total")
        self.snapshot_scrub_duration = Histogram(
            "snapshot_scrub_duration_seconds")
        self.device_path_trips = Counter("device_path_breaker_trips_total")
        # live breaker state (0=closed, 1=half-open, 2=open), set on
        # every transition — the trips counter says degradation HAS
        # happened; this gauge says whether scheduling is degraded NOW
        self.breaker_state = Gauge("device_path_breaker_state")
        # control-plane resilience layer: reflector relist cycles (every
        # list+watch re-entry, error-driven or watchdog-forced), streams
        # declared stale by the watchdog, bind POST retry attempts beyond
        # the first, and assumed pods expired without bind confirmation
        # (an expiry means a lost confirmation — never silent)
        self.reflector_relists = Counter("reflector_relists_total")
        self.watch_stale = Counter("watch_stale_total")
        self.bind_retries = Counter("bind_retries_total")
        self.cache_assumed_expired = Counter("cache_assumed_expired_total")
        # control-plane outage plane (sched/storehealth.py + the bind
        # spool): store-path breaker state (0=connected, 1=degraded,
        # 2=disconnected) set on every transition, trips into
        # DISCONNECTED, per-op store failures, and bind intents spooled
        # into the journal while disconnected (the spool DEPTH rides
        # scheduler_pending_pods{queue="spool"})
        self.store_breaker_state = Gauge("scheduler_store_breaker_state")
        self.store_breaker_trips = Counter(
            "scheduler_store_breaker_trips_total")
        self.store_errors = LabeledCounter(
            "store_errors_total", ("op",),
            values={"op": ("get", "list", "bind", "create", "update",
                           "delete", "watch")})
        self.binds_spooled = Counter("scheduler_binds_spooled_total")
        # queue depth per area, refreshed by the scheduler housekeeping
        # step — the cluster autoscaler and operators both watch it
        # (a Counter can't report a depth that drains)
        self.pending_pods = LabeledGauge("scheduler_pending_pods", ("queue",))
        # overload-control plane (sched/queue.py "Overload control" +
        # utils/watchdog.py): pods parked by priority-aware load
        # shedding per class, pending depth banded by priority class
        # (the client-go workqueue-depth signal made class-aware), wave
        # deadline overruns by stage (dispatch = watchdog-abandoned
        # device dispatch; host = featurize/upload exceeded the round
        # budget), and the adaptive wave cap those host overruns drive.
        # Class values are sched/queue.py QUEUE_CLASSES verbatim.
        self.shed_total = LabeledCounter(
            "scheduler_shed_total", ("class",),
            values={"class": ("system", "high", "normal", "low")})
        self.queue_class_pods = LabeledGauge(
            "scheduler_queue_class_pods", ("class",),
            values={"class": ("system", "high", "normal", "low")})
        self.wave_deadline_overruns = LabeledCounter(
            "scheduler_wave_deadline_overruns_total", ("stage",),
            values={"stage": ("dispatch", "host")})
        self.effective_wave_size = Gauge("scheduler_effective_wave_size")
        # poison-work isolation (sched/scheduler.py input-fault plane):
        # pods convicted of poisoning the batched scheduling pass, by
        # attribution route — featurize (typed PodFeaturizeError, direct
        # uid), sentinel (the kernel's numeric-integrity isfinite plane),
        # bisect (wave bisection converged on the culprit), gang
        # (quarantined with a convicted gangmate — atomicity extends to
        # conviction), golden (the exact per-pod path crashed on the
        # pod, attribution free)
        self.poison_pods = LabeledCounter(
            "scheduler_poison_pods_total", ("reason",),
            values={"reason": ("featurize", "sentinel", "bisect", "gang",
                               "golden")})
        # continuously-checked cluster invariants (chaos/invariants.py):
        # one child per named invariant the post-round checker can fail.
        # Any nonzero child is a scheduler bug — the chaos campaign and
        # the storm/meshfault benches gate on the family staying zero.
        self.invariant_violations = LabeledCounter(
            "scheduler_invariant_violations_total", ("invariant",),
            values={"invariant": ("conservation", "double_bind",
                                  "capacity", "snapshot_usage",
                                  "gang_atomic", "state_machine")})
        # node lifecycle / eviction storm control: per-zone health state
        # (1 on the current state's child, 0 on the others), evictions
        # actually executed per zone, evictions due-but-held by the
        # rate limiter or a suspended zone, and zone-suspension entries
        # (FullDisruption transitions)
        # zone names come from node labels (open, one series per live
        # zone); the state set is the controller's closed enum
        # (controllers/nodelifecycle.py ZONE_STATES)
        self.zone_health = LabeledGauge(
            "node_lifecycle_zone_health", ("zone", "state"),
            values={"state": ("Normal", "PartialDisruption",
                              "FullDisruption")},
            open_labels=("zone",))
        self.zone_evictions = LabeledCounter(
            "node_lifecycle_evictions_total", ("zone",),
            open_labels=("zone",))
        self.eviction_queue_depth = LabeledGauge(
            "node_lifecycle_eviction_queue_depth", ("zone",),
            open_labels=("zone",))
        self.eviction_suspensions = Counter(
            "node_lifecycle_suspensions_total")
        # cluster-autoscaler series (autoscaler's scaled_up/down analogs)
        self.autoscaler_scale_ups = Counter(
            "cluster_autoscaler_scaled_up_nodes_total")
        self.autoscaler_scale_downs = Counter(
            "cluster_autoscaler_scaled_down_nodes_total")
        # device telemetry (fed where ops/kernel.py dispatches): jit
        # program-cache hits/misses per shape bucket, compile seconds on
        # misses, snapshot HBM footprint + host->device upload bytes,
        # device->host result-fetch bytes, and device-vs-host wave
        # attribution (how much scheduling actually ran on device)
        # program names are the record_dispatch() call sites; bucket is
        # intentionally open — one value per compiled shape bucket, the
        # same cardinality as the jit program cache itself
        self.device_jit_events = LabeledCounter(
            "device_jit_cache_events_total", ("program", "bucket", "event"),
            values={"program": ("wave", "round", "gang", "telemetry",
                                "preempt"),
                    "event": ("hit", "miss")},
            open_labels=("bucket",))
        self.device_jit_compile_seconds = Histogram(
            "device_jit_compile_seconds")
        self.snapshot_hbm_bytes = Gauge("snapshot_hbm_bytes")
        # per-device footprint under mesh sharding (each device holds
        # 1/shards of every node group + a full pod/term replica); the
        # unlabeled gauge above sums TRUE per-shard bytes across devices
        # device ids are open (mesh size varies) but bounded by the
        # visible device count; stale children are zeroed on fallback
        self.snapshot_hbm_device_bytes = LabeledGauge(
            "snapshot_hbm_bytes_per_device", ("device",),
            open_labels=("device",))
        self.snapshot_upload_bytes = Counter("snapshot_upload_bytes_total")
        # memory-governance plane: per-vocabulary interner
        # sizes (the closed label set IS VocabSet.NAMES — the soak
        # harness gates on every child plateauing under node churn),
        # HBM budget headroom (budget - projected footprint; negative =
        # over budget, only exported when a budget is configured),
        # compactions by trigger, and round-boundary capacity faults
        # (RESOURCE_EXHAUSTED / MemoryError classified as
        # capacity, not device faults)
        self.snapshot_vocab_size = LabeledGauge(
            "snapshot_vocab_size", ("vocab",),
            values={"vocab": ("label_keys", "label_values", "taint_keys",
                              "taint_values", "resources", "ports",
                              "namespaces", "zones", "images",
                              "pod_label_keys")})
        self.hbm_headroom_bytes = Gauge("scheduler_hbm_headroom_bytes")
        self.snapshot_compactions_total = LabeledCounter(
            "snapshot_compactions_total", ("trigger",),
            values={"trigger": ("cadence", "governor", "oom")})
        self.capacity_faults = Counter("scheduler_capacity_faults_total")
        self.device_fetch_bytes = Counter("device_fetch_bytes_total")
        # mesh fault tolerance (sched/breaker.py MeshFaultManager +
        # parallel/mesh.py reform_mesh): how many devices the scheduling
        # mesh currently spans (the degradation ladder's live rung: 8 ->
        # 4 -> 2 -> 1; 1 when unsharded), reforms by direction (down =
        # device loss shrank the mesh, up = a healed device re-admitted
        # by a recovery probe grew it back), and a per-device quarantine
        # flag (1 while quarantined; the child is removed on re-admit so
        # /metrics never freezes a healed device at 1). Device names are
        # open but bounded by the visible device count, like the
        # per-device HBM gauge above.
        self.mesh_devices = Gauge("scheduler_mesh_devices")
        self.mesh_reforms = LabeledCounter(
            "mesh_reform_total", ("direction",),
            values={"direction": ("down", "up")})
        self.device_quarantined = LabeledGauge(
            "device_quarantined", ("device",), open_labels=("device",))
        self.waves_total = LabeledCounter("scheduler_waves_total", ("path",))
        # degraded-mode visibility: breaker-open pods the hostwave twin
        # can't encode, routed to the exact per-pod golden path, by
        # reason (affinity = untwinned inter-pod-affinity plane;
        # multi_tk = multi-topology-key required terms)
        self.degraded_golden_pods = LabeledCounter(
            "scheduler_degraded_golden_pods_total", ("reason",),
            values={"reason": ("affinity", "multi_tk")})
        # decision observatory (score decomposition, tracing only):
        # margin-of-victory distribution over placed pods (winner's
        # weighted total minus the best DIFFERENT node's), and the
        # accumulated weighted contribution of each priority to winning
        # totals — the skew ratio between children says which priority
        # actually drives placements under the current weights
        self.score_margin = Histogram("scheduler_score_margin")
        # ops/scores.py SCORE_STACK verbatim (tests/test_analysis.py
        # asserts the two stay in lockstep)
        self.score_priority_points = LabeledCounter(
            "scheduler_score_priority_points_total", ("priority",),
            values={"priority": (
                "LeastRequested", "BalancedAllocation", "MostRequested",
                "NodeAffinity", "TaintToleration", "SelectorSpread",
                "PreferAvoid", "ImageLocality", "InterPodAffinity",
                "TopologySpread", "TopologyCompactness",
                "HostExtra")})
        # counterfactual shadow scoring (sched/weights.py): per
        # candidate-profile placement divergence (would-have-chosen !=
        # chosen over the traced decomposition — a top-K lower bound),
        # pods scored per profile (the rate denominator), and the
        # margin-over-runner-up delta distribution (candidate margin
        # minus production margin; negative = the candidate decides
        # less decisively). {profile} values are the loaded
        # WeightProfile names — a declared set bounded at
        # sched/weights.py MAX_PROFILES, overflow bucketed through
        # bounded_label into "Other"
        self.shadow_divergence = LabeledCounter(
            "scheduler_shadow_divergence_total", ("profile",))
        self.shadow_scored_pods = LabeledCounter(
            "scheduler_shadow_scored_pods_total", ("profile",))
        # score-scale buckets (weighted totals live in 0..~100k with the
        # default PreferAvoid weight; deltas are typically single-digit
        # and can be negative — sub-first-bucket values land in the
        # first cumulative bucket, the reservoir keeps exact quantiles)
        self.shadow_margin_delta = Histogram(
            "scheduler_shadow_margin_delta",
            buckets=[-100.0, -50.0, -20.0, -10.0, -5.0, -2.0, -1.0, 0.0,
                     1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0])
        # autopilot promotion pipeline (autopilot/controller.py):
        # terminal verdicts per candidate run — promoted counts the
        # go-live transition, rolled_back the regression watch firing
        # after one (a force-promoted regression increments both)
        self.autopilot_promotions = LabeledCounter(
            "scheduler_autopilot_promotions_total", ("outcome",),
            values={"outcome": (
                "promoted", "rejected_shadow", "rejected_replay",
                "rolled_back", "aborted")})
        # first-fail predicate attribution for unschedulable pods —
        # previously reachable only through events and FitError text,
        # invisible to dashboards
        self.unschedulable_reasons = LabeledCounter(
            "scheduler_unschedulable_reasons_total", ("predicate",))
        # cluster-state telemetry plane (ops/telemetry.py, refreshed
        # once per traced round): requested/allocatable/free per
        # resource, the fragmentation index (1 - largest free block /
        # total free), feasibility headroom per canonical pod shape,
        # and per-zone utilization
        # resource/zone labels are open by design (extended resources
        # and zones come from cluster state) and PRUNED on disappearance
        # by the telemetry exporter — cardinality tracks the live
        # cluster, not its history
        self.cluster_requested = LabeledGauge(
            "scheduler_cluster_requested", ("resource",),
            open_labels=("resource",))
        self.cluster_allocatable = LabeledGauge(
            "scheduler_cluster_allocatable", ("resource",),
            open_labels=("resource",))
        self.cluster_free_largest = LabeledGauge(
            "scheduler_cluster_free_largest_block", ("resource",),
            open_labels=("resource",))
        self.cluster_fragmentation = LabeledGauge(
            "scheduler_cluster_fragmentation_index", ("resource",),
            open_labels=("resource",))
        # ops/telemetry.py CANONICAL_SHAPES names verbatim
        # (tests/test_analysis.py asserts lockstep)
        self.feasibility_headroom = LabeledGauge(
            "scheduler_feasibility_headroom", ("shape",),
            values={"shape": ("1c-2g", "2c-8g", "4c-16g", "8c-32g")})
        self.zone_utilization = LabeledGauge(
            "scheduler_zone_utilization", ("zone", "resource"),
            open_labels=("zone", "resource"))

    def all_series(self):
        out = {}
        for k, v in vars(self).items():
            if isinstance(v, (Counter, Gauge, Histogram)):
                out[k] = v
            elif isinstance(v, (LabeledCounter, LabeledGauge)):
                for c in v.children():
                    out[c.name] = c
        return out
