"""The scheduler: watch, queue, device rounds, gangs, preemption, commit.

A lean counterpart of the JAX package's Scheduler
(kubernetes_tpu/sched/scheduler.py), its device calls ported.
`schedule_pending` follows the JAX loop (:1213-1271): it runs the
device-resident pipeline (`_schedule_pipelined`) and runs it again after
progress — placements, or preemptions the pipeline performed — and when
a pass makes none it switches to the per-wave loop (`run_once`) for the
rest of the drain. A pipeline pass

  1. pops the whole backlog (sched/queue.py `pop_wave`, which never
     splits a gang);
  2. places each gang all-or-nothing, one device dispatch a gang
     (ops/gang.py `schedule_gang`, the taint/host-port kernel launched
     once), committing it through a group-wide exact recheck; a gang
     that fails parks as a unit with one shared backoff and preempts;
  3. runs one device round over the other pods (`_run_pipeline`:
     featurize in numpy, upload the snapshot, ops/kernel.py
     `schedule_round` with the taint/port kernel launched once, one
     fetch of `chosen`, exact int64 recheck, assume and bind);
  4. preempts for the round's failures in chunks of `wave_size`
     (`_pipeline_preempt`): one what-if launch a chunk (ops/preempt.py,
     the kernel csrc/preempt_whatif.cu, and the taint/port kernel for
     its static masks), then the exact victim selection on the first
     PREEMPT_HOST_CANDIDATES ranked nodes (sched/preemption.py), and
     the evictions.

The per-wave loop (`_run_wave`) schedules one wave and attributes each
failure (`_handle_failure`): a FitError on the pod, host preemption
(sched/preemption.py `preempt`), and a park with backoff
(utils/backoff.py `PodBackoff`, on the scheduler's `clock`).

Pods whose required pod (anti-)affinity terms of one kind span more than
one topology key cannot be encoded for the device (ops/affinity.py
keeps one topology key a term group). The pipeline, the per-wave loop
and the gang path send them through the exact host path
(`_schedule_host_batch`, kubernetes_tpu/sched/scheduler.py:3334): one
pod at a time over plugins/golden.py's predicates, the profile's host
filters, the golden scores and the profile's host scores, host
preemption on failure. Its cost is O(nodes x bound
pods) a pod (the golden anchor scan). Gang members take it one at a
time, without atomicity, as in the JAX package.

`device_preemption = False` (the JAX scheduler's attribute of the same
name) sends the batched what-if of `_pipeline_preempt` through the numpy
twin (ops/hostwave.py `preemption_stats_host`) instead of the what-if
kernel; the rounds still run on the device. With it True, a failing
what-if is a device failure and its chunk is salvaged on the twin.

Pods are ordered by (-priority, arrival seq), as the JAX scheduling
queue orders them. A round places at most PIPELINE_MAX_WAVES waves of
`wave_size` pods (PIPELINE_MAX_WAVES_IPA when inter-pod affinity is in
play anywhere); the rest go back to the queue before the round runs.

`metrics` (utils/metrics.py, a plain attribute a caller may replace)
takes the JAX scheduler's observations on the paths the port has: pod
and e2e scheduling latency, binding latency, pods scheduled and failed,
schedule attempts, waves by path, unschedulable reasons, preemption
attempts, evaluation time and victims, gang attempts and wait, and bind
errors. `warm_pipeline` runs one round without a fetch, outside a
measured window.

The profile (plugins/registry.py `Profile`; `default_profile(store)`
unless one is given, or one built from a Policy file by
`Registry.profile_from_policy`) supplies the weights, the scheduler
name, the preemption switch and the host plugins. Its host filters
(NoDiskConflict and the volume predicates of plugins/volumes.py, or a
Policy's own) run on the host before each per-wave and gang dispatch
(`_host_plugin_mask`, through the equivalence cache of
sched/equivalence.py when the EnableEquivalenceClassCache gate is on)
and reach the device as its `extra` mask; its host scores as the
pre-weighted `extra_scores` (`_host_score_matrix`). A pipeline pass
whose wave needs either hands its whole backlog to the per-wave loop,
and a profile with host scores skips the pipeline, as the JAX scheduler
does. With the VolumeScheduling gate on, a commit binds the pod's
unbound claims first (sched/volume_binder.py) and a failed bind or a
rolled-back gang unbinds them.

With tracing on (the port's own flight recorder,
utils/tracing.py `enable()`), every round, per-wave dispatch and gang
dispatch is recorded as in the JAX scheduler: a RoundTrace whose stage
marks tile the round, queue-wait and bind pod spans, and one ledger
record (v2) a round. The round and the per-wave dispatch then also
carry the score decomposition (ops/kernel.py `collect_scores`) out of
the loop: `_record_decisions` files a decision a placed pod in the
recorder and scores the wave under every candidate WeightProfile
(sched/weights.py `WeightBook.score_wave`); `_emit_telemetry` reduces
the cluster's node tensors on the device once a round
(ops/telemetry.py). With tracing off none of it runs: the per-pod loop,
the fetches and the placements are those of an untraced scheduler.

The weights come from `weightbook` (sched/weights.py `WeightBook`),
which watches `weightprofiles` objects: the `live` one is hot-swapped
between rounds and rolled back by deleting or demoting it; the others
are candidates, scored in shadow. `_weights_kw()` resolves the
(gating Weights, vector, version) view once a round.
`shadow_exact_interval=N` replays the first wave of every Nth traced
round under each candidate (`_shadow_exact_sample`).

Every bind goes through the bind reconciler (sched/reconciler.py, as
kubernetes_tpu/sched/scheduler.py:3991-4103 sends it): a transport error
of the POST is retried `bind_max_attempts` times on a jittered ladder
(`bind_retries_total`), a refusal (KeyError, Conflict) is not, and then
the pod is read from the store (`_pod_truth`): bound there (the POST
landed and only its answer was lost, or another writer bound it:
CONFIRMED) adopts that binding; unbound (ORPHANED) forgets the
assumption and parks the pod with backoff; gone (GONE) forgets it.
Binds run inline on the scheduling thread: the JAX scheduler's bind
pool serves only a store that is `async_bind_safe`, which the
in-process ObjectStore is not.

The cluster autoscaler (controllers/clusterautoscaler.py) reads the
unschedulable map through `pending_unschedulable` and featurizes its
what-ifs through `shadow_featurizer`; neither touches a round.

The device-fault ladder (kubernetes_tpu/sched/scheduler.py:1838-1880,
:2184-2550, :2796-3012) is the JAX scheduler's, without the mesh:

  * every failed round, per-wave dispatch, gang dispatch or preemption
    what-if is one device failure (`_device_failure`): counted on
    scheduling_errors{stage="wave"} and, by ops/kernel.py
    record_dispatch, on scheduling_errors{stage="dispatch", device=...};
    `breaker_threshold` consecutive failures open the `DevicePathBreaker`
    (sched/breaker.py; `device_path_trips`, `breaker_state`);
  * while it is open the backlog drains through the numpy twin
    (`_schedule_degraded`: ops/hostwave.py twin waves, the twin's
    all-or-nothing gangs and the twin's preemption what-if), and
    `wave_path()` says "host"; after `breaker_cooldown` one half-open
    probe dispatches on the card, and its success closes the breaker
    and re-uploads the whole device mirror;
  * `wave_deadline_s` > 0 arms the dispatch watchdog (utils/
    watchdog.py): an abandoned dispatch trips the breaker at once and
    its round is salvaged through the twin; while it is still running
    nothing dispatches, the probe included (`_device_admitted`); host
    stages that overrun the deadline halve the adaptive wave cap;
  * bad WORK never blames the card: a spec that crashes the featurizer
    is convicted directly, a failed dispatch is replayed on the twin
    first (`_input_fault_verdict`) and a reproduced failure bisects the
    wave to its culprit (`_isolate_poison`; a gang is convicted whole),
    and the kernel's numeric-integrity sentinel convicts the pods it
    flags and re-runs the survivors. Convicted pods wait in the queue's
    quarantine area on the capped `poison_backoff_s` ladder
    (`poison_pods{reason}`, `pending_pods{queue=quarantine}`);
  * the host mirror `_host_rr` keeps the round-robin counter continuous
    across device -> twin -> device, so placements stay bit-equal to a
    clean run.

A kernel that fails to build or load raises KernelBuildError
(ops/cuda_build.py), and a wrapper that refuses its inputs (device,
dtype, shape, slot counts, shared memory, no launch plan) raises
KernelInputError, a KernelBuildError; the scheduler re-raises both with
the popped pods back in the queue and never counts either as a device
fault, and the JAX scheduler's demotion of a failed Pallas
kernel to its plain version is not copied: a failed kernel launch is one
device failure like any other. A sticky CUDA error keeps the scheduler
on the twin until the process restarts (sched/breaker.py).

A pod whose spec crashes the exact host path's golden pass is convicted
(reason golden) and the batch drains on; a batch whose every pod
crashed is parked as a systemic fault
(kubernetes_tpu/sched/scheduler.py:3334-3388).

The memory plane (kubernetes_tpu/sched/scheduler.py:1297-1310,
:2551-2627) is the JAX scheduler's, without the mesh:

  * `scrubber` (state/scrubber.py `SnapshotScrubber`) audits the
    snapshot against the host cache on SIGUSR2 (`install_signal`),
    `request()` or every `scrub_interval` seconds, repairs divergent
    rows, and is the breaker's recovery action (`rebuild`);
  * compaction (`scrubber.compact`: a vocabulary mark-and-sweep and a
    bucket shrink, Snapshot._compact) runs from housekeeping every
    `compact_interval` seconds when rows were removed since the last
    one, or when the budget governor (`hbm_budget_bytes`, a byte count
    of the snapshot's host arrays, as JAX's) demanded it; it drops the
    device tensors of the old arrays;
  * a capacity fault — a torch out-of-memory error or a MemoryError in
    a round, per-wave or gang dispatch or at featurize — climbs the
    strike ladder (`_capacity_fault`): compact and retry, then also halve
    the wave cap, then the twin; a gang compacts and takes the twin's
    all-or-nothing plane; a what-if's is a device failure salvaged on
    the twin, as in the JAX scheduler. The breaker is charged only when
    the budget's headroom stays negative after the sweep; no pod is
    convicted (`capacity_faults`, `snapshot_compactions_total{trigger}`,
    the `memory` record of a traced round's ledger).

Load shedding (sched/queue.py "Overload control"): with
`shed_watermark` > 0, pods below `shed_priority_threshold` (default the
high band) that arrive past the watermark wait in the queue's shed area,
age back after `shed_age_s`, and drain oldest first once the working
depth is back under the watermark (`shed_total{class}`,
`pending_pods{queue="shed"}`, `queue_class_pods{class}`).

The store plane (kubernetes_tpu/sched/scheduler.py:310-346, :750-785,
:3964-4480) is the JAX scheduler's:

  * the store-path breaker (sched/storehealth.py `StorePathBreaker`,
    `storehealth`) counts consecutive transport failures of bind POSTs
    and truth GETs (`store_errors_total{op}`); `store_breaker_threshold`
    of them trip it DISCONNECTED (`scheduler_store_breaker_state`,
    `..._trips_total`), and after a jittered `store_breaker_cooldown`
    one store op is let through as the probe;
  * while it is dark, scheduling goes on against the cache: a bind is
    not attempted, the pod stays assumed (no `finish_binding`, so the
    assume TTL never expires it) and its intent spools in arrival order
    (`_spool_bind`, `scheduler_binds_spooled_total`,
    `pending_pods{queue="spool"}`), first appended with an fsync to the
    durable journal (state/journal.py `BindJournal`) when
    `bind_journal_path` is set; a bind whose retries AND truth GET both
    failed spools the same way;
  * housekeeping drains the spool head first through the reconciler
    once the store answers again (`_drain_spool`), stopping at the first
    intent still dark;
  * construction replays the journal's unresolved intents after the
    watches' backfill (`recover_from_journal`): a landed bind is
    adopted, a pending pod re-assumed and re-spooled under its seq, a
    deleted one resolved GONE;
  * with `spool_watermark` > 0 and the spool at it while DISCONNECTED,
    the queue holds sheddable arrivals in its shed area
    (`queue.hold_admissions`, `_admissions_held`);
  * `enter_dormant` stops the rounds and `recover_leadership` settles
    every assumed pod against the store, replays the journal and
    rebuilds the device mirror; `close()` and `wait_for_binds()` settle
    the binds in flight.

The RemoteStore path (client/rest.py, client/reflector.py,
cli/kube_scheduler.py) is the JAX scheduler's too: a store with
`set_health` (a RemoteStore) has its reflectors' LISTs feed the store
breaker; a store that is `async_bind_safe` gets a bind pool of
`bind_workers` threads, whose binds `wait_for_binds` waits on and whose
threads `recover_leadership` fans its truth GETs over; `_pod_truth`
GETs through the store's REST client, never its stale mirror, with
`TRUTH_GET_TIMEOUT`, an APIStatusError answer counting as reachable and
a 404 as deleted. `metrics` may be a registry shared with the
reflectors; `racecheck` wraps `_mu` and the queue's lock in the
lock-order watcher (utils/racecheck.py) under the JAX names;
`mesh_min_devices` is kept for the configuration (one device on one
card).

The autopilot and the invariant checker (kubernetes_tpu/sched/
scheduler.py:496-519) are the JAX scheduler's: an
autopilot/controller.py AutopilotController registers itself as
`autopilot` (served at /debug/autopilot), and `invariants=True` arms a
strict chaos/invariants.py InvariantChecker that `_check_invariants`
runs under `_mu` after each pipeline pass, at the end of
`schedule_pending` and after each `run_once` wave. It reads host state
only. `_journal_replay_enabled` and `_gang_rollback_enabled` are JAX's
broken-build hooks: the first False stops the spool drain in
housekeeping and the journal replay, the second leaves a failed gang
commit's assumed members in place.

HTTP extenders (sched/extender.py; kubernetes_tpu/sched/scheduler.py
sites listed at each use) are the JAX scheduler's: a profile or Policy
with extenders skips the pipeline and drains per wave on the device;
each filter verb tightens the wave's host mask (`ExtenderFilter`), each
prioritize verb adds into the `extra_scores` plane, the exact host path
asks them over its feasible nodes only, a preempt verb trims the
candidates of every preemption path, and the first bind verb binds
inside the reconciler's attempt. An extender error parks the pod (or
the wave, or the gang) with backoff under
`scheduling_errors{stage="extender"}`; it never charges the device
breaker, never moves a wave to the twin and never runs on the CPU.

Left out with no stand-in: the mesh and its reform (the mesh gauge reads
one device, the reform series stay at zero in `metrics`, `meshfaults`
is None).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import labels as lbl
from ..api import types as api
from ..client.rest import APIStatusError
from ..ops import encoding as enc
from ..ops import hostwave
from ..ops.cuda_build import KernelBuildError
from ..ops.gang import schedule_gang
from ..ops import telemetry as tele
from ..ops.kernel import (schedule_round, schedule_wave, set_devices,
                          set_telemetry, set_watchdog)
from ..ops.preempt import (PreemptStats, preemption_stats,
                           preemption_stats_host, victim_levels)
from ..ops.scores import SCORE_STACK, W_INTERPOD
from ..ops.taint_ports import taint_ports_masks
from ..plugins import golden
from ..plugins.registry import Profile, default_profile
from ..runtime.store import ADDED, DELETED, MODIFIED, Conflict, Event, ObjectStore
from ..state.cache import SchedulerCache
from ..state.featurize import PodFeaturizeError, PodFeaturizer
from ..state.journal import BindJournal
from ..state.scrubber import SnapshotScrubber
from ..state.snapshot import Snapshot
from ..utils import faultpoints, tracing
from ..utils.backoff import PodBackoff
from ..utils.feature_gates import FeatureGates
from ..utils.metrics import Metrics, bounded_label
from ..utils.trace import Trace
from ..utils.watchdog import DispatchTimeout, DispatchWatchdog
from . import breaker as breaker_mod
from .breaker import STATE_CODES, DevicePathBreaker, is_capacity_error
from .equivalence import EquivalenceCache, equivalence_class
from .errors import (REASON_KEYS, REASONS, FitError, PoisonError,
                     insufficient_resource_reason)
from .extender import ExtenderError
from .gang import GangDirectory
from .preemption import (GangGuard, PreemptionResult,
                         get_lower_priority_nominated_pods,
                         pod_eligible_to_preempt_others, pick_one_node,
                         preempt, process_preemption_with_extenders,
                         select_victims_on_node)
from .queue import HIGH_PRIORITY_BAND, SchedulingQueue
from .reconciler import BOUND, CONFIRMED, GONE, ORPHANED, BindReconciler
from .storehealth import DISCONNECTED as STORE_DISCONNECTED
from .storehealth import STATE_CODES as STORE_STATE_CODES
from .storehealth import StorePathBreaker
from .volume_binder import VolumeBinder
from .weights import WeightBook, gate_weights

# Max chained waves per device-resident round; rounds are bucketed per
# power-of-two wave count (a fixed W would make small rounds pay for 128
# waves). Longer backlogs run multiple rounds. A round with inter-pod
# affinity anywhere (bound or pending) is capped lower, as the JAX
# scheduler caps it: the placements depend on where each round ends.
PIPELINE_MAX_WAVES = 128
PIPELINE_MAX_WAVES_IPA = 64
# batched preemption: candidate priority levels of the what-if, and the
# exact victim validations a failed pod gets (its top-ranked nodes)
PREEMPT_LEVELS = 8
PREEMPT_HOST_CANDIDATES = 8


def pipeline_bucket(n_waves: int, lo: int = 4,
                    hi: int = PIPELINE_MAX_WAVES) -> int:
    """Smallest power-of-two wave-count >= n_waves (ceiling at hi) — the
    W of the round."""
    b = lo
    while b < n_waves and b < hi:
        b *= 2
    return b


def assemble_round(pbs, waves, pm_rows_all, term_rows_all, wbucket, tpp):
    """Stack per-wave PodBatches + staged row ids into the fixed-shape
    inputs of ops.kernel.schedule_round: batches padded to the bucket
    with zeroed (valid=False) waves, row ids padded with -1."""
    P = pbs[0].req.shape[0]
    pad_pb = enc.PodBatch(*[np.zeros_like(a) for a in pbs[0]])
    pbs_padded = list(pbs) + [pad_pb] * (wbucket - len(pbs))
    pbs_stacked = enc.PodBatch(*[np.stack(arrs)
                                 for arrs in zip(*pbs_padded)])
    pm_rows = np.full((wbucket, P), -1, np.int32)
    term_rows = np.full((wbucket, P, tpp), -1, np.int32)
    cursor = 0
    for wi, wv in enumerate(waves):
        n = len(wv)
        pm_rows[wi, :n] = pm_rows_all[cursor:cursor + n]
        term_rows[wi, :n] = term_rows_all[cursor:cursor + n]
        cursor += n
    return pbs_stacked, pm_rows, term_rows


class GroupLister:
    """Selectors of services/RCs/RSs/StatefulSets that select a pod
    (reference: priorities metadata getSelectors,
    algorithm/priorities/metadata.go + selector_spreading.go:230)."""

    def __init__(self, store: ObjectStore):
        self.store = store

    def __call__(self, pod: api.Pod) -> List[lbl.Selector]:
        out: List[lbl.Selector] = []
        for svc in self.store.list("services", pod.namespace):
            if svc.selector and lbl.Selector.from_set(svc.selector).matches(pod.metadata.labels):
                out.append(lbl.Selector.from_set(svc.selector))
        for rc in self.store.list("replicationcontrollers", pod.namespace):
            if rc.selector and lbl.Selector.from_set(rc.selector).matches(pod.metadata.labels):
                out.append(lbl.Selector.from_set(rc.selector))
        for rs in self.store.list("replicasets", pod.namespace):
            if rs.selector is not None:
                sel = rs.selector.to_selector()
                if sel.requirements and sel.matches(pod.metadata.labels):
                    out.append(sel)
        for ss in self.store.list("statefulsets", pod.namespace):
            if ss.selector is not None:
                sel = ss.selector.to_selector()
                if sel.requirements and sel.matches(pod.metadata.labels):
                    out.append(sel)
        return out


def _pod_has_ipa_terms(pod: api.Pod) -> bool:
    aff = pod.spec.affinity
    return aff is not None and (aff.pod_affinity is not None
                                or aff.pod_anti_affinity is not None)


class Scheduler:
    """Watches `store` for nodes, pods and PodGroups and schedules pending
    pods on `device` (None: the CUDA card; raises where there is none).
    `clock` drives backoff deadlines and assumed-pod expiry; `backoff`
    (default PodBackoff(clock=clock)) may also be replaced as an
    attribute, as the JAX scheduler's is, and so may `metrics` and
    `device_preemption`. `profile` (default `default_profile(store)`)
    and `features` (default FeatureGates()) are the JAX scheduler's
    arguments of the same names; disable_preemption=True turns
    preemption off as the profile's switch of the same name does.
    shadow_exact_interval > 0 replays the first wave of every Nth
    traced round under each candidate WeightProfile.
    hbm_budget_bytes, scrub_interval and compact_interval configure the
    memory plane, shed_watermark, shed_priority_threshold and shed_age_s
    the queue's load shedding, as the JAX scheduler's arguments of the
    same names do (0 / None: off). store_breaker_threshold,
    store_breaker_cooldown, bind_journal_path, bind_journal_max_bytes
    (-1: the journal's default cap), spool_watermark (0: no admission
    hold) and bind_max_attempts configure the store plane, with the JAX
    scheduler's defaults; the reconciler's `sleep` and `jitter` and the
    store breaker's `jitter` are attributes a test may pin."""

    # idle backoff entries are swept on this cadence (2x the backoff
    # ceiling matches the reference Gc()'s retention window)
    BACKOFF_GC_PERIOD = 120.0

    def __init__(self, store: ObjectStore, wave_size: int = 128,
                 caps: Optional[enc.Caps] = None, device=None,
                 clock=time.monotonic, backoff: Optional[PodBackoff] = None,
                 disable_preemption: bool = False,
                 profile: Optional[Profile] = None,
                 features: Optional[FeatureGates] = None,
                 shadow_exact_interval: int = 0,
                 breaker_threshold: int = 3, breaker_cooldown: float = 30.0,
                 wave_deadline_s: float = 0.0,
                 poison_backoff_s: float = 5.0,
                 hbm_budget_bytes: int = 0,
                 scrub_interval: Optional[float] = None,
                 compact_interval: Optional[float] = None,
                 shed_watermark: int = 0,
                 shed_priority_threshold: Optional[int] = None,
                 shed_age_s: float = 30.0,
                 store_breaker_threshold: int = 3,
                 store_breaker_cooldown: float = 30.0,
                 bind_journal_path: Optional[str] = None,
                 bind_journal_max_bytes: int = -1,
                 spool_watermark: int = 0,
                 bind_max_attempts: int = 3,
                 metrics: Optional[Metrics] = None,
                 bind_workers: int = 4,
                 racecheck: bool = False,
                 mesh_min_devices: int = 1,
                 invariants: bool = False):
        self.device = enc.resolve_device(device)
        self.store = store
        self.profile = profile or default_profile(store)
        self.wave_size = wave_size
        self.features = features or FeatureGates()
        self.clock = clock
        self._disable_preemption = disable_preemption
        # live and candidate WeightProfiles; with none loaded, its
        # dispatch view is the profile's weights and their stacked
        # vector
        self.weightbook = WeightBook(self.profile.weights())
        self.shadow_exact_interval = int(shadow_exact_interval)
        self._shadow_rounds = 0
        # guards cache + snapshot against concurrent informer delivery;
        # RLock: the in-process store delivers bind events re-entrantly
        # on the committing thread
        self._mu = threading.RLock()
        self.cache = SchedulerCache(clock=clock)
        self.snapshot = Snapshot(caps=caps)
        # the device-memory budget governor: 0 = unlimited. When set, a
        # _grow that would push the projected footprint of the device
        # mirror over the budget demands a compaction instead of letting
        # the card's allocator fail mid-round
        self.snapshot.hbm_budget_bytes = int(hbm_budget_bytes)
        self.featurizer = PodFeaturizer(self.snapshot, GroupLister(store))
        # metrics may be a registry shared with the RemoteStore's
        # reflectors (cli/kube_scheduler.py), so the control-plane series
        # land on the same /metrics endpoint as the scheduling ones
        self.metrics = metrics or Metrics()
        # dispatches are counted into this registry by program and shape
        # bucket (process-global, as in the JAX package)
        set_telemetry(self.metrics)
        # (resources, (zone, resource) pairs) the telemetry gauges last
        # exported, so a vanished one is removed
        self._tele_exported = (set(), set())
        # overload control: the queue's priority-aware shed plane
        # (sched/queue.py "Overload control") — watermark 0 keeps it off
        self.queue = SchedulingQueue(
            clock=clock,
            pod_priority_enabled=self.features.enabled("PodPriority"),
            shed_watermark=shed_watermark,
            shed_priority_threshold=(HIGH_PRIORITY_BAND
                                     if shed_priority_threshold is None
                                     else shed_priority_threshold),
            shed_age_s=shed_age_s)
        self.queue.on_shed = self._pod_shed
        # racecheck: wrap the scheduling-plane locks in the lock-order
        # watcher (utils/racecheck.py) under the JAX package's names
        # (kubernetes_tpu/sched/scheduler.py:224-242), before anything
        # below captures the raw locks (the scrubber closes over _mu)
        self.racecheck_watcher = None
        if racecheck:
            from ..utils.racecheck import LockOrderWatcher, instrument

            self.racecheck_watcher = LockOrderWatcher()
            instrument(self.racecheck_watcher, self, "_mu", "Scheduler._mu")
            instrument(self.racecheck_watcher, self.queue, "_lock",
                       "SchedulingQueue._lock")
        # the class gauges' export cadence and the upload bytes already
        # counted into snapshot_upload_bytes_total
        self._next_class_export = 0.0
        self._upload_bytes_seen = 0
        self.queue.on_gang_released = self._gang_released
        # gang (PodGroup) coscheduling: the queue parks incomplete gangs
        # and the pipeline routes complete ones through ops/gang.py
        self.gangs = GangDirectory(store)
        self.queue.gang_lookup = self.gangs.lookup
        self.backoff = backoff if backoff is not None else PodBackoff(
            clock=clock)
        self._next_backoff_gc = 0.0
        # preemptions performed by the batched pipeline path;
        # device_preemption=False sends the batched what-if through the
        # numpy twin instead of the what-if kernel
        self.pipeline_preemptions = 0
        self.device_preemption = True
        # the host plugins' caches: the equivalence cache (gated), the
        # claim binder, and the first-failing host filter per (pod, node)
        # of the last host mask, for FitError and preemption
        self.ecache = (EquivalenceCache()
                       if self.features.enabled("EnableEquivalenceClassCache")
                       else None)
        self.volume_binder = VolumeBinder(store)
        self._wave_host_fails: Dict[int, Dict[str, str]] = {}
        self._rr: Optional[torch.Tensor] = None  # round-robin counter
        # the host MIRROR of the round-robin counter: a device pass adds
        # its placements (the device counter advances by one a
        # placement), a twin wave advances it directly and drops _rr, and
        # the next device pass re-seeds _rr from it — tie-breaks stay
        # bit-equal to a clean run across device -> twin -> device
        self._host_rr = 0
        self._last_path: Optional[str] = None
        # poison-work isolation: the capped re-probe backoff of CONVICTED
        # pods (sched/queue.py quarantine area), apart from the
        # scheduling backoff: a conviction clears only on a successful
        # bind or the pod's deletion
        self.poison_backoff = PodBackoff(
            initial=max(float(poison_backoff_s), 0.001),
            maximum=max(float(poison_backoff_s), 0.001) * 64,
            clock=clock)
        self.poison_convictions = 0
        # the snapshot scrubber (state/scrubber.py): audits the device
        # mirror against the host cache on SIGUSR2 / the periodic
        # cadence and repairs divergent rows in place, and compacts it on
        # its cadence or on demand. Shares _mu so a scrub can never
        # interleave with a round's upload.
        self.scrubber = SnapshotScrubber(
            self.cache, self.snapshot, metrics=self.metrics, clock=clock,
            period=scrub_interval, lock=self._mu,
            compact_period=compact_interval)
        # the capacity-fault strike ladder (an out-of-memory error or a
        # MemoryError at the device boundary — never a device fault,
        # never a conviction): strike 1 compacts and retries, strikes 2+
        # also halve the adaptive wave cap, strike 3 salvages the round
        # through the numpy twin. Reset by any successful dispatch.
        self._capacity_strikes = 0
        # the device-path circuit breaker: consecutive device failures
        # send whole waves through the numpy twin until a half-open probe
        # succeeds; recovery rebuilds every row of the mirror from host
        # truth and re-uploads it whole (nothing incremental is trusted
        # across a device fault)
        self.breaker = DevicePathBreaker(
            threshold=breaker_threshold, cooldown=breaker_cooldown,
            clock=clock, on_recover=self.scrubber.rebuild,
            on_trip=lambda: self.metrics.device_path_trips.inc(),
            on_state=self._breaker_state_changed)
        self.metrics.breaker_state.set(STATE_CODES[self.breaker.state])
        # an assumed-pod expiry means a bind confirmation was lost
        self.cache.on_expired = (
            lambda pod: self.metrics.cache_assumed_expired.inc())
        # the bind reconciler: jittered retries of the bind POST, then
        # the store's copy of the pod resolves what the POST did
        # (sched/reconciler.py); its per-attempt callbacks feed the
        # store-path breaker
        self.reconciler = BindReconciler(
            self._pod_truth, metrics=self.metrics,
            max_attempts=bind_max_attempts,
            on_transport_error=self._store_bind_failed,
            on_transport_ok=self._store_bind_ok)
        # dormant = leadership lost: rounds stop, the watches stay warm;
        # recover_leadership() settles the assumed pods and resumes
        self._dormant = False
        # the store-path breaker (sched/storehealth.py): consecutive
        # transport failures of bind POSTs and truth GETs trip
        # disconnected-mode scheduling — rounds go on against the cache,
        # binds spool into the journal, and the head intent's own POST is
        # the jittered half-open probe
        self.storehealth = StorePathBreaker(
            threshold=store_breaker_threshold,
            cooldown=store_breaker_cooldown, clock=clock,
            on_trip=lambda: self.metrics.store_breaker_trips.inc(),
            on_state=self._store_state_changed,
            on_reconnect=self._store_reconnected)
        self.metrics.store_breaker_state.set(
            STORE_STATE_CODES[self.storehealth.state])
        # a RemoteStore's reflectors feed the same breaker from their
        # LIST path (kubernetes_tpu/sched/scheduler.py:326-328)
        set_health = getattr(store, "set_health", None)
        if set_health is not None:
            set_health(self.storehealth)
        # the disconnected-mode bind spool: arrival-ordered
        # (pod, bound, node_name, vol_rollback, journal_seq) intents whose
        # POST waits for the store to heal. The pod STAYS assumed
        # (capacity held, so post-heal placements equal an outage-free
        # run's) and the journal holds the durable copy for a restart's
        # replay. Guarded by _mu.
        self._spool: List[tuple] = []
        self._spool_uids: set = set()
        self._spool_drain_due = False
        self.spool_watermark = int(spool_watermark)
        self.journal = (BindJournal(bind_journal_path,
                                    max_bytes=bind_journal_max_bytes)
                        if bind_journal_path else None)
        # admission hold: DISCONNECTED with the spool at its watermark,
        # sheddable arrivals park in the shed area instead of growing the
        # assumed capacity
        self.queue.hold_admissions = self._admissions_held
        # failed dispatches are attributed to the active device
        # (scheduling_errors{stage=dispatch, device=...})
        set_devices([self.device])
        # one device on one card: the degradation ladder's floor is kept
        # for the configuration, and the mesh gauge reads one device, as
        # the JAX scheduler's does without a mesh
        self.mesh_min_devices = max(int(mesh_min_devices), 1)
        self.metrics.mesh_devices.set(1)
        # no mesh fault manager: the JAX value without a mesh, which the
        # invariant checker's state_machine check reads
        self.meshfaults = None
        # the bind pool (kubernetes_tpu/sched/scheduler.py:465-480): the
        # bind POST runs from these threads outside _mu, so the next
        # wave's featurize and dispatch overlap this wave's binds. Only
        # for a store that delivers its watch events outside its own lock
        # (a RemoteStore: reflector threads); the in-process ObjectStore
        # delivers under its lock, where a binder thread would deadlock
        # against a wave holding _mu. bind_workers=0: inline binds. The
        # binder threads do host work only: no tensor is touched there.
        self._bind_pool = None
        if bind_workers > 0 and getattr(store, "async_bind_safe", False):
            self._bind_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=bind_workers, thread_name_prefix="binder")
        self._inflight_mu = threading.Lock()
        self._inflight: set = set()
        self.bind_overlap_hwm = 0  # high-water mark of concurrent binds
        # the autopilot controller (autopilot/controller.py) registers
        # itself here; the HealthServer serves it at /debug/autopilot
        # (404 while none is attached)
        self.autopilot = None
        # continuously-checked cluster invariants (chaos/invariants.py,
        # kubernetes_tpu/sched/scheduler.py:499-507): opt-in post-round
        # observer; None costs one attribute check per round. A checker
        # can also be attached externally (strict=False for end-of-run
        # gating).
        self.invariants = None
        if invariants:
            from ..chaos.invariants import InvariantChecker

            self.invariants = InvariantChecker(metrics=self.metrics)
        # gang-commit rollback test hook (kubernetes_tpu/sched/
        # scheduler.py:513): the chaos campaign's broken-build acceptance
        # flips this False to prove that a partial gang commit without
        # rollback is caught by the conservation / gang_atomic
        # invariants. NEVER disable outside a test.
        self._gang_rollback_enabled = True
        # crash-journal replay test hook (kubernetes_tpu/sched/
        # scheduler.py:519): a broken-build acceptance flips this False
        # to prove that a build which neither drains the spool nor
        # replays the journal is caught by the conservation invariant's
        # spool-outlived-the-outage rule. NEVER disable outside a test.
        self._journal_replay_enabled = True
        # both kernels are built now, before any dispatch runs under the
        # watchdog: a first build inside a guarded dispatch would read as
        # a hang. A failed build raises KernelBuildError here.
        if self.device.type == "cuda":
            from ..ops import preempt as _preempt
            from ..ops import taint_ports as _taint_ports

            _taint_ports.build()
            _preempt.build()
        # the dispatch watchdog: with wave_deadline_s > 0 every dispatch
        # runs under that deadline, and an abandoned one trips the
        # breaker at once and salvages its round through the twin.
        # Process-global like the telemetry hook: a deadline-free
        # scheduler clears a predecessor's.
        self.wave_deadline_s = float(wave_deadline_s)
        self.watchdog = None
        if self.wave_deadline_s > 0:
            self.watchdog = DispatchWatchdog(
                self.wave_deadline_s, on_abandon=self._dispatch_abandoned)
        set_watchdog(self.watchdog)
        # the adaptive wave cap: host-stage overruns of wave_deadline_s
        # halve it (floor MIN_ADAPTIVE_WAVE), fast rounds grow it back
        self._wave_cap = wave_size
        self._wire()
        # after the watches' backfill (which re-queues the Pending pods a
        # prior process had claimed), so the replay can retire
        # journal-claimed pods from the queue before the first round
        self.recover_from_journal()

    @property
    def disable_preemption(self) -> bool:
        """Preemption off: the constructor's switch, the profile's, or the
        PodPriority gate off."""
        return (self._disable_preemption or self.profile.disable_preemption
                or not self.features.enabled("PodPriority"))

    # -- watch handlers (reference: factory.go:191-295) -----------------------

    def _wire(self) -> None:
        self.store.watch("nodes", self._on_node_event)
        self.store.watch("pods", self._on_pod_event)
        for kind in ("services", "replicationcontrollers", "replicasets",
                     "statefulsets"):
            self.store.watch(kind, lambda ev: self._invalidate_features())
        # a PodGroup created/updated AFTER its pods may complete a gang
        # that was parked against a higher annotation-derived minMember
        self.store.watch("podgroups", self._on_podgroup_event)
        # live weight profiles: a promotion to role=live, a demotion or a
        # delete takes effect on the next round
        self.store.watch("weightprofiles", self._on_weight_profile_event)
        if self.ecache is not None:
            # targeted invalidation (kubernetes_tpu/sched/scheduler.py:
            # 564-577), under _mu so it never interleaves with a wave's
            # lookups and updates
            for kind in ("persistentvolumes", "persistentvolumeclaims"):
                self.store.watch(kind, self._on_volume_event)
            self.store.watch("services", self._on_service_event)
        # objects already in the store: nodes first, so their pods' rows
        # land against present node rows
        for node in self.store.list("nodes"):
            self._on_node_add(node)
        for pod in self.store.list("pods"):
            self._on_pod_add(pod)
        if self.store.list("podgroups"):
            self.queue.gang_reevaluate()
        for obj in self.store.list("weightprofiles"):
            self._on_weight_profile(obj)

    def _on_node_event(self, ev: Event) -> None:
        if ev.type == DELETED:
            self._on_node_delete(ev.obj)
        else:
            self._on_node_add(ev.obj)

    def _on_pod_event(self, ev: Event) -> None:
        if ev.type == ADDED:
            self._on_pod_add(ev.obj)
        elif ev.type == MODIFIED:
            self._on_pod_update(ev.old if ev.old is not None else ev.obj,
                                ev.obj)
        elif ev.type == DELETED:
            self._on_pod_delete(ev.obj)

    def _on_podgroup_event(self, ev: Event) -> None:
        if ev.type in (ADDED, MODIFIED):
            self.queue.gang_reevaluate()

    def _on_weight_profile_event(self, ev: Event) -> None:
        if ev.type == DELETED:
            self._on_weight_profile_delete(ev.obj)
        else:
            self._on_weight_profile(ev.obj)

    def _on_weight_profile(self, obj) -> None:
        """Add or update one WeightProfile (kubernetes_tpu/sched/
        scheduler.py:659-675): a bad table is logged and the old one
        stays in force."""
        with self._mu:
            before = self.weightbook.live_version()
            try:
                self.weightbook.on_profile(obj)
            except ValueError as e:
                logging.getLogger(__name__).error(
                    "rejecting WeightProfile %s: %s", obj.metadata.name, e)
                return
            after = self.weightbook.live_version()
        if after != before:
            logging.getLogger(__name__).info(
                "weight vector hot-swapped: %s -> %s", before, after)
            tracing.event("weights_swapped", before=before, after=after)

    def _on_weight_profile_delete(self, obj) -> None:
        with self._mu:
            before = self.weightbook.live_version()
            self.weightbook.on_profile_delete(obj)
            after = self.weightbook.live_version()
        if after != before:
            logging.getLogger(__name__).info(
                "weight vector rolled back: %s -> %s", before, after)
            tracing.event("weights_swapped", before=before, after=after)

    def _on_volume_event(self, ev: Event) -> None:
        with self._mu:
            self.ecache.on_volume_event()

    def _on_service_event(self, ev: Event) -> None:
        with self._mu:
            self.ecache.on_service_event()

    def _responsible(self, pod: api.Pod) -> bool:
        return pod.spec.scheduler_name == self.profile.scheduler_name

    def _on_pod_add(self, pod: api.Pod) -> None:
        with self._mu:
            if pod.spec.node_name:
                if self.ecache is not None:
                    self.ecache.on_assigned_pod_event(pod.spec.node_name)
                self.cache.add_pod(pod)
                ni = self.cache.node_infos.get(pod.spec.node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.add_pod(pod)
                self.queue.assigned_pod_added(pod)
            elif self._responsible(pod) and pod.status.phase in ("", "Pending"):
                self.queue.add(pod)

    def _on_pod_update(self, old: api.Pod, new: api.Pod) -> None:
        with self._mu:
            if new.spec.node_name:
                if self.ecache is not None:
                    self.ecache.on_assigned_pod_event(new.spec.node_name)
                if old.spec.node_name:
                    self.cache.update_pod(old, new)
                else:
                    self.cache.add_pod(new)  # bind confirmation
                ni = self.cache.node_infos.get(new.spec.node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.add_pod(new)
                self.queue.assigned_pod_added(new)
            elif self._responsible(new):
                self.queue.update(old, new)

    def _on_pod_delete(self, pod: api.Pod) -> None:
        with self._mu:
            if pod.spec.node_name:
                if self.ecache is not None:
                    self.ecache.on_assigned_pod_event(pod.spec.node_name)
                self.cache.remove_pod(pod)
                ni = self.cache.node_infos.get(pod.spec.node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.remove_pod(pod)
                # a BOUND gang member leaving must shrink its gang's
                # member count, or a stale uid would open the admission
                # gate for a sub-minMember gang
                self.queue.gang_forget(pod)
                self.queue.move_all_to_active()
            else:
                self.queue.delete(pod)

    def _on_node_add(self, node: api.Node) -> None:
        with self._mu:
            if self.ecache is not None:
                self.ecache.on_node_event(node.name)
            self.cache.add_node(node)
            self.snapshot.set_node(self.cache.node_infos[node.name])
            self.queue.move_all_to_active()

    def _on_node_delete(self, node: api.Node) -> None:
        with self._mu:
            if self.ecache is not None:
                self.ecache.on_node_event(node.name)
            self.cache.remove_node(node)
            self.snapshot.remove_node(node.name)

    def _invalidate_features(self) -> None:
        # group membership may have changed -> equivalence rows are stale
        self.featurizer._cache.clear()

    # -- introspection ----------------------------------------------------------

    def pending_count(self) -> int:
        """Pods pending in any area of the queue (active, backoff,
        unschedulable, gang waiting)."""
        return self.queue.pending_count()

    def unschedulable_pods(self) -> List[api.Pod]:
        return self.queue.unschedulable_pods()

    # -- cluster-autoscaler hooks (kubernetes_tpu/sched/scheduler.py:
    # 4318-4331) ----------------------------------------------------------------

    def pending_unschedulable(self) -> List[api.Pod]:
        """Snapshot of the unschedulable map — the cluster autoscaler's
        demand feed: pods that failed on every node and wait for the
        cluster to change."""
        return self.queue.unschedulable_pods()

    def shadow_featurizer(self, snapshot: Snapshot) -> PodFeaturizer:
        """Pending-pod featurization over a scratch snapshot (the
        autoscaler's what-if hook, ops/simulate.py): shares the live
        GroupLister so spreading selectors encode exactly as they would
        on the live path. The scratch snapshot must share the live
        vocabularies (shadow_snapshot guarantees it) so interned ids
        line up."""
        return PodFeaturizer(snapshot, self.featurizer.group_selectors)

    def wave_path(self) -> str:
        """What the most recent wave, round or gang ran on: 'cuda' when
        the taint/port kernel launched, 'torch-cpu' on the CPU, 'host'
        for the numpy twin (degraded waves; the JAX scheduler says
        'vector'), 'unresolved' before any."""
        return self._last_path or "unresolved"

    # -- the device-fault ladder's hooks (kubernetes_tpu/sched/
    # scheduler.py:711, :797-849) ------------------------------------------------

    def _breaker_state_changed(self, state: str) -> None:
        """Every breaker transition lands on the state gauge (0=closed,
        1=half-open, 2=open) and, when tracing, as a span event."""
        self.metrics.breaker_state.set(STATE_CODES[state])
        rec = tracing.active()
        if rec is not None:
            rec.event("breaker", state=state,
                      failures=self.breaker.failures)

    # -- the store plane's hooks (kubernetes_tpu/sched/scheduler.py:720-785)

    def _store_state_changed(self, state: str) -> None:
        """Every store-breaker transition lands on the state gauge
        (0=connected, 1=degraded, 2=disconnected) and, when tracing, as a
        span event."""
        self.metrics.store_breaker_state.set(STORE_STATE_CODES[state])
        rec = tracing.active()
        if rec is not None:
            rec.event("store_breaker", state=state,
                      failures=self.storehealth.failures,
                      spool=len(self._spool))

    def _store_reconnected(self) -> None:
        """record_success fires this from whichever call saw the heal;
        draining inline there could re-enter the reconciler from its own
        callback, so only flag it: the next housekeeping pass drains."""
        self._spool_drain_due = True

    def _store_bind_failed(self) -> None:
        # reconciler on_transport_error: one failed bind POST attempt
        self.metrics.store_errors.labels(op="bind").inc()
        self.storehealth.record_failure()

    def _store_bind_ok(self) -> None:
        self.storehealth.record_success()

    def _admissions_held(self) -> bool:
        """The queue's hold_admissions: DISCONNECTED with the spool at
        its watermark, sheddable arrivals park in the shed area until the
        store heals (system and high classes are never held)."""
        return (self.spool_watermark > 0
                and self.storehealth.state == STORE_DISCONNECTED
                and len(self._spool) >= self.spool_watermark)

    def spool_count(self) -> int:
        with self._mu:
            return len(self._spool)

    def spool_uids(self) -> frozenset:
        """UIDs spooled now: the assumed-but-unbound pods an outage
        leaves legitimately."""
        with self._mu:
            return frozenset(self._spool_uids)

    def store_debug(self) -> Dict[str, object]:
        """The JAX scheduler's /debug/store payload: the breaker's
        snapshot, the spool, the journal's stats and the store errors by
        op."""
        out = self.storehealth.snapshot()
        with self._mu:
            out["spool"] = {
                "depth": len(self._spool),
                "watermark": self.spool_watermark,
                "oldest_seq": self._spool[0][4] if self._spool else None,
                "drain_due": self._spool_drain_due,
            }
        out["journal"] = (self.journal.stats()
                          if self.journal is not None else None)
        out["errors"] = {
            op: self.metrics.store_errors.value(op=op)
            for op in ("get", "list", "bind", "create", "update",
                       "delete", "watch")}
        return out

    def _dispatch_abandoned(self, program: str, deadline: float) -> None:
        """Watchdog abandonment hook: the overrun counter's dispatch
        stage, a span event and a log line; the dispatch itself raises
        DispatchTimeout into the device-failure path."""
        self.metrics.wave_deadline_overruns.labels(stage="dispatch").inc()
        logging.getLogger(__name__).error(
            "device dispatch %s abandoned after %.3fs deadline; device "
            "presumed wedged until it returns", program, deadline)
        rec = tracing.active()
        if rec is not None:
            rec.event("dispatch_abandoned", program=program,
                      deadline_s=round(deadline, 3))

    # floor of the adaptive wave cap
    MIN_ADAPTIVE_WAVE = 16

    def _account_host_overrun(self, host_seconds: float) -> None:
        """Deadline accounting for the HOST stages of a round (featurize,
        stage, upload): one over wave_deadline_s halves the adaptive wave
        cap, one under a quarter of it doubles the cap back toward
        wave_size. No-op while wave_deadline_s is 0."""
        if self.wave_deadline_s <= 0:
            return
        if host_seconds > self.wave_deadline_s:
            self.metrics.wave_deadline_overruns.labels(stage="host").inc()
            self._wave_cap = max(self._wave_cap // 2,
                                 min(self.MIN_ADAPTIVE_WAVE,
                                     self.wave_size))
        elif (host_seconds <= self.wave_deadline_s / 4
                and self._wave_cap < self.wave_size):
            self._wave_cap = min(self._wave_cap * 2, self.wave_size)
        self.metrics.effective_wave_size.set(self._wave_cap)

    def _runtime_wedged(self) -> bool:
        """Is a watchdog-abandoned dispatch still running? The device is
        presumed wedged until that thread returns."""
        return self.watchdog is not None and bool(
            self.watchdog.outstanding())

    def _device_admitted(self) -> bool:
        """May this wave or round dispatch to the device? False while the
        device is wedged: even the breaker's half-open probe must not be
        spent on it — allow() is not consulted then, so the OPEN ->
        HALF_OPEN transition waits until the wedge clears."""
        if self._runtime_wedged():
            return False
        return self.breaker.allow()

    def export_queue_gauges(self) -> None:
        """Refresh scheduler_pending_pods{queue=...} for the areas the
        port's queue has (kubernetes_tpu/sched/scheduler.py:1315-1370):
        active, backoff, unschedulable, gang_waiting, shed, quarantine
        and spool (the store plane's bind intents); the depth banded by
        priority class (a 1 s cadence: the class walk is O(total
        pending) under the queue lock); and
        the memory plane's gauges: the device mirror's bytes, the budget
        headroom (with a budget set), the vocabulary sizes and the
        upload bytes since the last export. Called from housekeeping and
        after a drain settles."""
        g = self.metrics.pending_pods
        g.labels(queue="active").set(self.queue.active_count())
        g.labels(queue="backoff").set(self.queue.backoff_count())
        g.labels(queue="unschedulable").set(self.queue.unschedulable_count())
        g.labels(queue="gang_waiting").set(self.queue.gang_waiting_count())
        g.labels(queue="shed").set(self.queue.shed_count())
        g.labels(queue="quarantine").set(self.queue.quarantine_count())
        g.labels(queue="spool").set(self.spool_count())
        now = self.clock()
        if now >= self._next_class_export:
            self._next_class_export = now + 1.0
            for cls, n in self.queue.class_counts().items():
                self.metrics.queue_class_pods.labels(**{"class": cls}).set(n)
        self.metrics.snapshot_hbm_bytes.set(self.snapshot.hbm_bytes())
        headroom = self.snapshot.hbm_headroom_bytes()
        if headroom is not None:
            self.metrics.hbm_headroom_bytes.set(headroom)
        for vocab, size in self.snapshot.vocabs.sizes().items():
            self.metrics.snapshot_vocab_size.labels(vocab=vocab).set(size)
        up = self.snapshot.upload_bytes_total
        if up > self._upload_bytes_seen:
            self.metrics.snapshot_upload_bytes.inc(up - self._upload_bytes_seen)
            self._upload_bytes_seen = up

    def _pod_shed(self, cls: str) -> None:
        """Queue shed hook: one increment a shed decision, labelled by
        priority class (sheds of system/high are what the storm gates
        hold at zero), and a `pod_shed` event when tracing."""
        self.metrics.shed_total.labels(**{"class": cls}).inc()
        rec = tracing.active()
        if rec is not None:
            rec.event("pod_shed", cls=cls)

    def _note_path(self, launches0: int) -> None:
        self._last_path = ("cuda" if taint_ports_masks.launches > launches0
                           else "torch-cpu")

    def _weights_kw(self):
        """(gating Weights, f32 [S] live vector, version string) for one
        round, under one WeightBook lock hold (dispatch_view): the
        gating Weights pick the planes the loop computes, the vector
        (on the device, the kernel's weight_vec) supplies the
        multipliers, and the version is what the round's ledger record
        and decisions report."""
        return self.weightbook.dispatch_view(self.profile.weights())

    def _golden_reasons(self, pods: List[api.Pod]) -> Dict[str, int]:
        """{reason: count} of the pods routed to the exact host path —
        the pods with no ScoreDeco, the shadow observatory's coverage
        gap."""
        counts: Dict[str, int] = {}
        for p in pods:
            r = self.featurizer.golden_reason(p)
            counts[r] = counts.get(r, 0) + 1
        return counts

    # -- metrics (kubernetes_tpu/sched/scheduler.py:851, :1165) -----------------

    def _gang_released(self, key: str, waited: float) -> None:
        self.metrics.gang_wait_seconds.observe(waited)
        rec = tracing.active()
        if rec is not None:
            now = rec.now()
            rec.add_span("gang_wait", now - waited, now, cat="gang",
                         gang=key, waited_s=round(waited, 6))

    def _count_unschedulable(self, err: FitError) -> None:
        """scheduler_unschedulable_reasons_total{predicate}: one increment
        per (failed pod, first-fail predicate); free-text reasons bucket
        into "Other"."""
        for reason, count in err.failed_predicates.items():
            if not count:
                continue
            if reason.startswith("Insufficient "):
                pred = "PodFitsResources"
            else:
                pred = bounded_label(REASON_KEYS.get(reason, reason),
                                     REASONS)
            self.metrics.unschedulable_reasons.labels(predicate=pred).inc()

    # -- per-round records (kubernetes_tpu/sched/scheduler.py:859-1165) ----------

    def _trace_queue_waits(self, rt, pods: List[api.Pod]) -> None:
        """Per-pod queue_wait spans (first enqueue -> popped into this
        round), keyed by UID; added_at survives until bind, so reading it
        here consumes nothing."""
        now = self.clock()
        added_at = self.queue.added_at
        for p in pods:
            added = added_at.get(p.uid)
            if added is not None:
                rt.pod_span(p.uid, "queue_wait", now - added)

    def _round_snapshot_shape(self) -> Dict[str, int]:
        c = self.snapshot.caps
        return {"nodes": int(np.sum(self.snapshot.valid)),
                "N": c.N, "M": c.M, "E": c.E}

    def _record_decisions(self, rec, pods: List[api.Pod], chosen,
                          cparts, tidx, tvals, tparts,
                          committed: Optional[set] = None,
                          wvec=None, wver: Optional[str] = None):
        """Consume one fetched ScoreDeco slice ([P, ...] numpy arrays
        aligned with `pods`), as the JAX scheduler does (:875-982), in
        f64 numpy rounded to 4 places: a decision entry a committed pod
        in the recorder, margins into scheduler_score_margin, weighted
        per-priority contributions into
        scheduler_score_priority_points_total, the shadow pass over every
        candidate WeightProfile, and the (scores, shadow) aggregates of
        the round's ledger record. committed: the uids whose exact
        recheck and bind succeeded; wvec/wver: the round's weight view
        (_weights_kw)."""
        w = wvec if wvec is not None else self.weightbook.live_vector()
        if wver is None:
            wver = self.weightbook.live_version()
        shadow = self.weightbook.score_wave(
            pods, chosen, self.snapshot.node_names, cparts, tidx, tvals,
            tparts, committed=committed, metrics=self.metrics)
        margins: List[float] = []
        totals: List[float] = []
        contrib = np.zeros(len(SCORE_STACK), np.float64)
        names = self.snapshot.node_names
        placed = 0
        for i, pod in enumerate(pods):
            c = int(chosen[i])
            if c < 0 or c >= len(names):
                continue
            if committed is not None and pod.uid not in committed:
                continue
            placed += 1
            total = float(tvals[i][0])  # argmax total == top-1 value
            totals.append(total)
            # runner-up: the best-scoring OTHER feasible node (the
            # chosen node usually holds rank 0; a round-robin tie-break
            # can place it deeper, so scan)
            runner = None
            for j in range(tidx[i].shape[0]):
                if int(tidx[i][j]) != c and float(tvals[i][j]) >= 0:
                    runner = j
                    break
            margin = (total - float(tvals[i][runner])
                      if runner is not None else None)
            if margin is not None:
                margins.append(margin)
                self.metrics.score_margin.observe(margin)
            wparts = w.astype(np.float64) * cparts[i]
            contrib += wparts
            parts = {}
            for s, name in enumerate(SCORE_STACK):
                parts[name] = {
                    "weight": float(w[s]),
                    "chosen": round(float(cparts[i][s]), 4),
                    "runner_up": (round(float(tparts[i][s][runner]), 4)
                                  if runner is not None else None)}
            top = [{"node": names[int(tidx[i][j])],
                    "total": round(float(tvals[i][j]), 4)}
                   for j in range(tidx[i].shape[0])
                   if float(tvals[i][j]) >= 0 and int(tidx[i][j]) < len(names)]
            rec.record_decision(pod.uid, {
                "pod": pod.full_name(),
                "node": names[c],
                "round": rec.current().rid,
                "total": round(total, 4),
                "margin": None if margin is None else round(margin, 4),
                "runner_up": (names[int(tidx[i][runner])]
                              if runner is not None else None),
                "weights_version": wver,
                "weights": [float(x) for x in w],
                "parts": parts,
                "top": top,
            })
        if not placed:
            return None, shadow
        for s, name in enumerate(SCORE_STACK):
            if contrib[s]:
                self.metrics.score_priority_points.labels(
                    priority=name).inc(float(contrib[s]))
        out: Dict = {
            "min": round(min(totals), 4), "max": round(max(totals), 4),
            "mean": round(sum(totals) / len(totals), 4),
            "breakdown": {name: round(float(contrib[s]) / placed, 4)
                          for s, name in enumerate(SCORE_STACK)
                          if contrib[s]},
        }
        if margins:
            out["margin"] = {
                "min": round(min(margins), 4),
                "mean": round(sum(margins) / len(margins), 4),
                "max": round(max(margins), 4)}
        return out, shadow

    def _shadow_exact_sample(self, wave_pods, pbt, chosen_row, rr_start,
                             has_ipa: bool, has_ts: bool, gating, dev_tensors
                             ) -> Optional[Dict]:
        """Exact shadow mode (shadow_exact_interval > 0): every Nth
        traced round replays its FIRST wave under each candidate vector
        and counts the pods whose node changes
        (kubernetes_tpu/sched/scheduler.py:984-1021). The JAX scheduler
        replays through its numpy twin; this one replays through its own
        `schedule_wave` on the same round's device tensors (`dev_tensors`
        = nt, pm, tt, and `pbt`, the wave's batch), before any commit
        changes them, so on the card the plain version stays off the
        main path. The placements are the twin's: the wave is bit-equal
        to it. The replay is left out of the dispatch counts, as the
        twin's is. Costs one wave a candidate and one read of the rr
        counter a sampled round."""
        if (self.shadow_exact_interval <= 0
                or not self.weightbook.has_candidates()):
            return None
        self._shadow_rounds += 1
        if self._shadow_rounds % self.shadow_exact_interval:
            return None
        nt, pm, tt = dev_tensors
        dev = nt.valid.device
        P = pbt.req.shape[0]
        extra = torch.ones((P, nt.valid.shape[0]), dtype=torch.bool,
                           device=dev)
        rr0 = torch.tensor(0 if rr_start is None else int(rr_start),
                           dtype=torch.int32, device=dev)
        n = len(wave_pods)
        chosen_dev = np.asarray(chosen_row)[:n]
        out: Dict[str, Dict] = {}
        for name, vec in self.weightbook.candidate_vectors().items():
            res = schedule_wave(
                nt, pm, tt, pbt, extra, rr0, None,
                weights=gate_weights(gating, vec),
                num_zones=self.snapshot.caps.Z,
                num_label_values=self.snapshot.num_label_values,
                has_ipa=has_ipa, has_ts=has_ts,
                weight_vec=enc.weight_vec_to_torch(vec, dev), account=False)
            got = res.chosen.cpu().numpy()[:n]
            flips = int(np.sum(got != chosen_dev))
            self.weightbook.record_exact(name, n, flips)
            out[name] = {"pods": n, "flips": flips}
        return out or None

    @staticmethod
    def _merge_exact(shadow: Optional[Dict],
                     exact_info: Optional[Dict]) -> Optional[Dict]:
        """Fold a sampled exact-mode result into the round's shadow
        ledger record (creating profile entries the lower-bound pass
        produced nothing for)."""
        if not exact_info:
            return shadow
        shadow = shadow or {}
        for name, ex in exact_info.items():
            shadow.setdefault(
                name, {"pods": 0, "flips": 0,
                       "lower_bound": True})["exact"] = ex
        return shadow

    def _resource_names(self) -> List[str]:
        """Column -> resource name for the telemetry exports (core
        columns by convention, extended ones from the resource vocab)."""
        names = list(tele.CORE_RESOURCE_NAMES)
        for c in range(enc.RES_FIXED, self.snapshot.caps.R):
            try:
                names.append(self.snapshot.extended.string(
                    c - enc.RES_FIXED + 1))
            except Exception:
                names.append(f"ext{c}")
        return names

    def _emit_telemetry(self, rt, device_ok: bool = True) -> None:
        """One cluster-state reduction for a traced round (rt is the
        round trace; callers gate on it, so tracing off costs nothing),
        as the JAX scheduler's (:1052-1165): ops/telemetry.py on the
        node tensors' device while the breaker is CLOSED and no
        dispatch is wedged, the numpy twin (ops/hostwave.py
        cluster_telemetry_host) otherwise; the gauges refreshed, the
        round's ledger record extended and its stage marked.

        device_ok: False from degraded rounds — the device just
        misbehaved (or the breaker is open), and a telemetry dispatch
        there could hang where scheduling stepped away. A device failure
        counts scheduling_errors{stage="telemetry"}, is logged, and the
        twin serves the round."""
        Z = self.snapshot.caps.Z
        R = self.snapshot.caps.R
        packed = None
        backend = "host"
        # passive breaker check: allow() would spend the half-open probe
        if (device_ok and self.breaker.state == breaker_mod.CLOSED
                and not self._runtime_wedged()):
            try:
                nt, _pm, _tt = self.snapshot.to_device(self.device)
                packed = tele.cluster_telemetry(nt,
                                                num_zones=Z).cpu().numpy()
                self.metrics.device_fetch_bytes.inc(packed.nbytes)
                backend = "device"
            except Exception as e:
                self.metrics.scheduling_errors.labels(
                    stage="telemetry").inc()
                logging.getLogger(__name__).error(
                    "cluster telemetry failed on the device; round %s "
                    "takes the twin's", rt.rid, exc_info=e)
                packed = None
        if packed is None:
            nt, _pm, _tt = self.snapshot.host_tensors()
            packed = hostwave.cluster_telemetry_host(nt, num_zones=Z)
        ct = tele.ClusterTelemetry(packed, R, Z)
        res_names = self._resource_names()
        util = ct.utilization()
        frag = ct.fragmentation()
        m = self.metrics
        seen_res: set = set()
        for c, name in enumerate(res_names):
            if not (ct.alloc_total[c] or ct.req_total[c]):
                continue
            seen_res.add(name)
            m.cluster_requested.labels(resource=name).set(
                float(ct.req_total[c]))
            m.cluster_allocatable.labels(resource=name).set(
                float(ct.alloc_total[c]))
            m.cluster_free_largest.labels(resource=name).set(
                float(ct.free_max[c]))
            m.cluster_fragmentation.labels(resource=name).set(
                float(frag[c]))
        for k, (sname, _cpu, _mem) in enumerate(tele.CANONICAL_SHAPES):
            m.feasibility_headroom.labels(shape=sname).set(
                int(ct.headroom[k]))
        zones = {}
        seen_zone: set = set()
        # zone slot 0 is "no zone key" (the vocab pad) — real zones only
        for z in range(1, Z):
            if not np.any(ct.zone_alloc[z]):
                continue
            try:
                zname = self.snapshot.vocabs.zones.string(z)
            except Exception:
                zname = str(z)
            zu = {}
            for c, name in enumerate(res_names):
                if ct.zone_alloc[z][c]:
                    u = float(ct.zone_req[z][c] / ct.zone_alloc[z][c])
                    zu[name] = round(u, 4)
                    seen_zone.add((zname, name))
                    m.zone_utilization.labels(zone=zname,
                                              resource=name).set(u)
            zones[zname] = zu
        # a zone or resource that disappeared must stop exporting, not
        # freeze at its last value
        prev_res, prev_zone = self._tele_exported
        for name in sorted(prev_res - seen_res):
            for fam in (m.cluster_requested, m.cluster_allocatable,
                        m.cluster_free_largest, m.cluster_fragmentation):
                fam.remove(resource=name)
        for zname, name in sorted(prev_zone - seen_zone):
            m.zone_utilization.remove(zone=zname, resource=name)
        self._tele_exported = (seen_res, seen_zone)
        summary = {
            "backend": backend,
            "nodes": ct.nodes_valid,
            "schedulable": ct.nodes_schedulable,
            "util": {n: round(float(util[c]), 4)
                     for c, n in enumerate(res_names)
                     if ct.alloc_total[c]},
            "frag": {n: round(float(frag[c]), 4)
                     for c, n in enumerate(res_names)
                     if ct.free_total[c]},
            "headroom": {sname: int(ct.headroom[k])
                         for k, (sname, _c, _m2) in
                         enumerate(tele.CANONICAL_SHAPES)},
            "free_hist": {n: ct.free_hist[c].tolist()
                          for c, n in enumerate(res_names)
                          if ct.alloc_total[c]},
        }
        if zones:
            summary["zones"] = zones
        rt.ledger["telemetry"] = summary
        rt.mark("telemetry", backend=backend)

    # -- the drain (kubernetes_tpu/sched/scheduler.py:1213) ----------------------

    def schedule_pending(self) -> int:
        """Run the pipeline until the active queue drains, falling back to
        the per-wave loop once a pipeline pass makes no progress. Returns
        pods placed (assumed + bound)."""
        placed = 0
        # extenders and host scores need per-wave host evaluation: the
        # pipeline would only hand the backlog back, after one webhook
        # call a pod (kubernetes_tpu/sched/scheduler.py:1236-1245)
        allow_pipeline = not (self.profile.extenders
                              or self.profile.host_scores)
        while not self._dormant and self.queue.active_count() > 0:
            if allow_pipeline:
                pre = self.pipeline_preemptions
                pre_poison = self.poison_convictions
                n = self._schedule_pipelined()
                self._check_invariants()
                placed += n
                if (n > 0 or self.pipeline_preemptions > pre
                        or self.poison_convictions > pre_poison):
                    # preemptions and poison convictions are progress
                    # too: victims were evicted or culprits quarantined,
                    # and the survivors re-run the PIPELINE (so their
                    # placements stay bit-equal a clean run's)
                    continue
                # zero progress: the per-wave loop owns failure
                # attribution and host preemption for the rest of the
                # drain (re-attempting the pipeline before every wave
                # would re-pop the whole backlog each time)
                allow_pipeline = False
            placed += self.run_once()
        self.wait_for_binds()
        self.export_queue_gauges()
        self._check_invariants()
        return placed

    def _housekeep(self) -> None:
        """Expire assumed pods, drain the bind spool when the store path
        allows, sweep idle backoff entries (PodBackoff.gc,
        reference backoff_utils.go Gc), refresh the queue gauges, run
        the snapshot scrubber if its signal or cadence fired, and compact
        the snapshot when the budget governor demanded it or the cadence
        elapsed with removals outstanding
        (kubernetes_tpu/sched/scheduler.py:1272-1310)."""
        with self._mu:
            self.cache.cleanup_expired()
        # the bind spool: drain it once the store answers again (the
        # breaker flagged the reconnect), or let its head intent be the
        # half-open probe once the jittered cooldown has passed (allow()
        # admits exactly one). Gated on the replay hook so a broken-build
        # acceptance can model a build that never drains.
        if (self._journal_replay_enabled and self._spool
                and (self.storehealth.state != STORE_DISCONNECTED
                     or self.storehealth.allow())):
            self._drain_spool()
        now = self.clock()
        if now >= self._next_backoff_gc:
            self._next_backoff_gc = now + self.BACKOFF_GC_PERIOD
            self.backoff.gc()
            self.poison_backoff.gc()
        self.export_queue_gauges()
        self.scrubber.maybe_scrub()
        # a compaction crash (the snapshot.compact fault point) costs
        # the compaction, never the housekeeping pass: the live snapshot
        # only swaps in after the scratch rebuild fully succeeds
        try:
            self.scrubber.maybe_compact()
        except Exception as ce:
            logging.getLogger(__name__).error(
                "housekeeping compaction failed (live snapshot "
                "unchanged): %s: %s", type(ce).__name__, ce)

    def run_once(self, timeout: float = 0.0) -> int:
        """Schedule one wave through the per-wave path, waiting up to
        `timeout` seconds for the first pod (kubernetes_tpu/sched/
        scheduler.py:1372). Returns the pods placed (with a bind pool:
        assumed with their bind dispatched; none while dormant)."""
        if self._dormant:
            return 0
        self._housekeep()
        pods = self.queue.pop_wave(self._wave_cap, timeout=timeout)
        if not pods:
            return 0
        with self._mu:
            n = self._run_wave(pods)
        self._check_invariants()
        return n

    def _check_invariants(self) -> None:
        """Post-round invariant check (chaos/invariants.py,
        kubernetes_tpu/sched/scheduler.py:1387) — runs at every round
        boundary when a checker is armed (--invariants /
        Scheduler(invariants=True)); one attribute check when off.
        Holds _mu so informer delivery and the check see a consistent
        cache and snapshot, exactly like a wave."""
        chk = self.invariants
        if chk is None:
            return
        with self._mu:
            chk.check(self)

    def _schedule_pipelined(self) -> int:
        """One pipeline pass over the whole backlog: gangs first, one
        dispatch a gang, then one device round over the other pods
        (kubernetes_tpu/sched/scheduler.py:1399)."""
        self._housekeep()
        all_pods: List[api.Pod] = []
        while True:
            batch = self.queue.pop_wave(self._wave_cap, timeout=0.0)
            if not batch:
                break
            all_pods.extend(batch)
        if not all_pods:
            return 0
        with self._mu:
            if not self._device_admitted():
                # breaker open (or a wedged dispatch outstanding): the
                # whole backlog takes the twin — degraded, never stopped
                return self._schedule_degraded(all_pods)
            placed = 0
            # gangs bypass the device-resident round: their placements
            # must be all-or-nothing per group, which the round's
            # staged-commit carry can't express
            gang_pods = [p for p in all_pods if self.gangs.key(p) is not None]
            if gang_pods:
                all_pods = [p for p in all_pods
                            if self.gangs.key(p) is None]
                placed += self._schedule_gangs(gang_pods)
            # pods the device cannot encode take the exact host path;
            # they carry no ScoreDeco, so they are counted by reason as
            # the round's coverage gap
            host_path = [p for p in all_pods
                         if self.featurizer.needs_host_path(p)]
            golden = self._golden_reasons(host_path)
            pods = [p for p in all_pods
                    if not self.featurizer.needs_host_path(p)]
            placed += self._schedule_host_batch(host_path)
            if not pods:
                if golden:
                    tracing.event("golden_gap", **golden)
                return placed
            # RE-check admission: a gang dispatch above may have been
            # abandoned by the watchdog (breaker now open)
            if not self._device_admitted():
                return placed + self._schedule_degraded(pods,
                                                        golden=golden)
            return placed + self._run_pipeline(pods, golden=golden)

    def warm_pipeline(self, pods: List[api.Pod],
                      n_waves: Optional[int] = None) -> None:
        """Run the round program once for this cluster's shapes, without
        a fetch (kubernetes_tpu/sched/scheduler.py:1469), so that the
        device's lazy start-up and the kernels' first build land outside
        a measured window. n_waves picks the wave-count bucket (default:
        one wave). At most one wave of `pods` (host-path pods left out) is
        staged; every staged row is released again, the pods stay
        pending, and the queue and the round-robin counter are not
        touched."""
        with self._mu:
            pods = [p for p in pods
                    if not self.featurizer.needs_host_path(p)][:self.wave_size]
            if not pods:
                return
            self.featurizer.featurize(pods)
            pm_rows, term_rows = self.snapshot.stage_pending(pods)
            try:
                pb = self.featurizer.featurize(pods)
                dev = self.device
                nt, pm, tt = self.snapshot.to_device(dev)
                usage = (nt.requested, nt.nonzero, nt.pod_count)
                has_ipa = bool(self.snapshot.has_affinity_terms
                               or pb.ra_has.any() or pb.rn_has.any()
                               or (pb.pa_w != 0).any())
                wbucket = pipeline_bucket(
                    n_waves if n_waves is not None else 1,
                    hi=(PIPELINE_MAX_WAVES_IPA if has_ipa
                        else PIPELINE_MAX_WAVES))
                pbs_stacked, rows, trows = assemble_round(
                    [pb], [pods], pm_rows, term_rows, wbucket,
                    term_rows.shape[1])
                gating, wvec, _wver = self._weights_kw()
                # the variant the measured rounds will run: with tracing
                # on they carry the decomposition
                schedule_round(
                    nt, pm, tt,
                    enc.to_torch(None, None, None, pbs_stacked, dev)[3],
                    usage, torch.zeros((), dtype=torch.int32, device=dev),
                    torch.from_numpy(rows).to(dev),
                    torch.from_numpy(trows).to(dev),
                    weights=gating, num_zones=self.snapshot.caps.Z,
                    num_label_values=self.snapshot.num_label_values,
                    has_ipa=has_ipa,
                    collect_scores=tracing.active() is not None,
                    weight_vec=enc.weight_vec_to_torch(wvec, dev))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            finally:
                for p in pods:
                    self.snapshot.unstage(p)

    # -- the round -------------------------------------------------------------

    def _run_pipeline(self, pods: List[api.Pod],
                      golden: Optional[Dict[str, int]] = None) -> int:
        """One device-resident round over `pods` (queue order); the pods
        it leaves unplaced go to batched preemption, and those it does
        not handle back to the queue. golden: the pass's host-path pods
        by reason, ledgered with a traced round. Returns pods placed.

        The device-fault ladder of kubernetes_tpu/sched/scheduler.py:
        1586-1963: a pod whose spec crashes the featurizer is convicted
        and the survivors re-featurized; a failed dispatch first gets an
        input-fault verdict (the twin replays the round's pods) and
        bisects or convicts poison work; a genuine device failure feeds
        the breaker and hands the backlog back (a watchdog abandonment
        salvages it through the twin at once); the sentinel's flagged
        pods are convicted and the survivors re-run."""
        trace = Trace(f"pipeline of {len(pods)}", clock=self.clock)
        start = self.clock()
        # the ADAPTIVE cap: equal to wave_size unless wave_deadline_s
        # overruns shrank it
        W = self._wave_cap
        # ipa anywhere in the backlog (or already placed) caps the round
        # at the ipa wave count, even for ipa-free leading rounds
        max_waves = (PIPELINE_MAX_WAVES_IPA
                     if (self.snapshot.has_affinity_terms
                         or any(_pod_has_ipa_terms(p) for p in pods))
                     else PIPELINE_MAX_WAVES)
        waves = [pods[i:i + W] for i in range(0, len(pods), W)]
        if len(waves) > max_waves:
            # bound the round; the leftover goes back to the queue first
            keep = max_waves * W
            for p in pods[keep:]:
                self.queue.add_if_not_present(p)
            pods, waves = pods[:keep], waves[:max_waves]
        # ONE weight view a round: dispatch, decisions and the ledger's
        # weights_version all come from it
        gating, wvec, wver = self._weights_kw()
        rec = tracing.active()
        rt = None
        if rec is not None:
            rt = rec.begin_round("pipeline", pending=len(pods),
                                 waves=len(waves), weights_version=wver)
            self._trace_queue_waits(rt, pods)
            if golden:
                rt.ledger["golden"] = golden
        # pass 1 grows every vocab/cap to its final size; when it grew,
        # pass 2 re-emits every batch at the uniform final shapes. A
        # PodFeaturizeError is a DIRECT conviction: quarantine the
        # culprit, re-chunk the survivors, featurize again.
        while True:
            try:
                sig0 = (self.featurizer.vocabs.version(),
                        dataclasses.astuple(self.snapshot.caps))
                pbs = [self.featurizer.featurize(wv) for wv in waves]
                if (self.featurizer.vocabs.version(),
                        dataclasses.astuple(self.snapshot.caps)) != sig0:
                    pbs = [self.featurizer.featurize(wv) for wv in waves]
                break
            except PodFeaturizeError as e:
                pods = self._convict_featurize_victim(e, pods)
                if not pods:
                    if rt is not None:
                        rec.end_round(rt, outcome="input_fault")
                    return 0
                waves = [pods[i:i + W] for i in range(0, len(pods), W)]
            except Exception as e:
                # an allocation-site MemoryError (state/featurize.py
                # propagates it raw: environmental, not spec-caused) is a
                # CAPACITY fault at the round boundary: compact and retry
                # rather than crash the loop or convict the pod that was
                # featurizing when memory ran out
                if not is_capacity_error(e):
                    raise
                return self._capacity_fault(pods, e, rt, rec,
                                            self._run_pipeline)
        try:
            for wv, pb in zip(waves, pbs):
                P = pb.req.shape[0]
                if (not self._host_plugin_mask(wv, P).all()
                        or self._host_score_matrix(wv, P) is not None):
                    # a host filter or an extender rejects a node, or host
                    # or extender scores are in play: the per-wave loop
                    # evaluates them against fresh state, so the whole
                    # pass goes back to the queue
                    # (kubernetes_tpu/sched/scheduler.py:1670-1682)
                    for p in pods:
                        self.queue.add_if_not_present(p)
                    if rt is not None:
                        rec.end_round(rt, outcome="host_fallback")
                    return 0
        except ExtenderError:
            # every pod of the pass parks
            # (kubernetes_tpu/sched/scheduler.py:1684-1690)
            self._extender_failed(pods, rt, rec)
            return 0
        try:
            # the chaos seam, a wave at a time, while the batches are
            # still host numpy: a crash-kind poison reproduces on the
            # attribution replay, a nan-kind corrupts the victim's row
            for wv_pods, pb in zip(waves, pbs):
                self._wave_poison_seam(wv_pods, pb)
        except Exception as e:
            verdict = self._input_fault_verdict(pods, e)
            if rt is not None:
                rec.end_round(rt, outcome=("input_fault"
                                           if verdict is not None
                                           else "device_failure"),
                              error=type(e).__name__)
            if verdict is None:
                # transient (a times-bounded fault ran out): requeue for
                # a clean retry
                for p in pods:
                    self.queue.add_if_not_present(p)
                return 0
            return self._isolate_poison(pods, verdict, self._run_pipeline)
        pm_rows_all, term_rows_all = self.snapshot.stage_pending(pods)
        tpp = term_rows_all.shape[1]
        trace.step("featurized+staged")
        if rt is not None:
            rt.mark("featurize", pods=len(pods))
            up0 = self.snapshot.upload_bytes_total
        dev = self.device
        nt, pm, tt = self.snapshot.to_device(dev)
        trace.step("uploaded")
        if rt is not None:
            rt.mark("upload", cat="device",
                    bytes=self.snapshot.upload_bytes_total - up0, shards=1)
        # featurize+stage+upload overruns shrink the wave before they
        # stretch the latency
        self._account_host_overrun(self.clock() - start)
        usage = (nt.requested, nt.nonzero, nt.pod_count)
        if self._rr is None:
            # re-seed from the host mirror (a twin pass dropped _rr)
            self._rr = torch.tensor(self._host_rr, dtype=torch.int32,
                                    device=dev)
        # inter-pod affinity anywhere: bound pods' terms, or a required or
        # preferred term in any of the round's batches (host numpy)
        has_ipa = bool(self.snapshot.has_affinity_terms
                       or any(pb.ra_has.any() or pb.rn_has.any()
                              or (pb.pa_w != 0).any() for pb in pbs))
        wbucket = pipeline_bucket(len(waves), hi=max_waves)
        pbs_stacked, pm_rows, term_rows = assemble_round(
            pbs, waves, pm_rows_all, term_rows_all, wbucket, tpp)
        launches0 = taint_ports_masks.launches
        try:
            pbs_t = enc.to_torch(None, None, None, pbs_stacked, dev)[3]
            pm_rows_t = torch.from_numpy(pm_rows).to(dev)
            term_rows_t = torch.from_numpy(term_rows).to(dev)
            # the decomposition rides along exactly when tracing
            (chosen_d, _fail, _usage_end, rr_end, deco_d,
             fin_d) = schedule_round(
                nt, pm, tt, pbs_t, usage, self._rr, pm_rows_t, term_rows_t,
                weights=gating, num_zones=self.snapshot.caps.Z,
                num_label_values=self.snapshot.num_label_values,
                has_ipa=has_ipa, collect_scores=rt is not None,
                weight_vec=enc.weight_vec_to_torch(wvec, dev))
            trace.step("dispatched")
            if rt is not None:
                # a traced round waits for the card here, so that its
                # device_wave span holds the device time
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                rt.mark("device_wave", cat="device", waves=len(waves),
                        path=("cuda" if taint_ports_masks.launches > launches0
                              else "torch-cpu"))
            # the round's one fetch: chosen and the sentinel together
            # (and the decomposition planes when tracing); a fault of
            # the card's work surfaces here, inside the try
            chosen_all = chosen_d.cpu().numpy()
            fin_all = fin_d.cpu().numpy()
            deco_all = None
            if deco_d is not None:
                deco_all = tuple(a.cpu().numpy() for a in deco_d)
        except Exception as e:
            for p in pods:
                self.snapshot.unstage(p)
            if isinstance(e, KernelBuildError):
                # a kernel that cannot be built is not a device fault
                for p in pods:
                    self.queue.add_if_not_present(p)
                if rt is not None:
                    rec.end_round(rt, outcome="error",
                                  error=type(e).__name__)
                raise
            # capacity-fault attribution FIRST: a device OOM replays
            # clean on the twin, so the input-fault verdict would
            # misclassify it as a device fault
            if is_capacity_error(e):
                return self._capacity_fault(pods, e, rt, rec,
                                            self._run_pipeline)
            # input-fault attribution BEFORE breaker accounting: bad work
            # must never blame the device
            verdict = self._input_fault_verdict(pods, e)
            if verdict is not None:
                if rt is not None:
                    rec.end_round(rt, outcome="input_fault",
                                  error=type(e).__name__)
                return self._isolate_poison(pods, verdict,
                                            self._run_pipeline)
            self._device_failure(e)
            if rt is not None:
                rec.end_round(rt, outcome="device_failure",
                              error=type(e).__name__)
            if isinstance(e, DispatchTimeout):
                # a wedged dispatch: the breaker opened (record_hang) and
                # the SAME round's pods place now through the twin.
                # golden is not re-passed: this round's record has it.
                return self._schedule_degraded(pods)
            for p in pods:
                self.queue.add_if_not_present(p)
            return 0
        self.breaker.record_success()
        self._capacity_strikes = 0
        self._note_path(launches0)
        fetched = chosen_all.nbytes + fin_all.nbytes
        if deco_all is not None:
            fetched += sum(a.nbytes for a in deco_all)
        self.metrics.device_fetch_bytes.inc(fetched)
        trace.step("fetched")
        if rt is not None:
            rt.mark("fetch", cat="device", bytes=int(fetched))
        # numeric-integrity sentinel, fetched with chosen: a non-finite
        # row means a poison pod contaminated the shared usage carry —
        # DISCARD the whole round, convict the flagged pods, re-run the
        # survivors (bit-equal a clean run); rr not advanced
        bad = [wv_pods[i].uid for wi, wv_pods in enumerate(waves)
               for i in range(len(wv_pods)) if not fin_all[wi, i]]
        if bad:
            for p in pods:
                self.snapshot.unstage(p)
            if rt is not None:
                rec.end_round(rt, outcome="input_fault", poison=len(bad))
            return self._isolate_poison(
                pods, PoisonError("numeric-integrity sentinel", uids=bad),
                self._run_pipeline)
        # exact shadow sampling runs BEFORE any commit changes the
        # snapshot: the replay must see the state the round scored
        exact_info = None
        if rt is not None:
            exact_info = self._shadow_exact_sample(
                waves[0], enc.PodBatch(*[a[0] for a in pbs_t]),
                chosen_all[0], self._rr, has_ipa,
                bool(pbs[0].ts_valid.any()), gating, (nt, pm, tt))
        self._rr = rr_end
        # the mirror: the round advanced rr once a placement
        self._host_rr += int(np.sum(chosen_all >= 0))
        placed = 0
        committed: set = set()
        retry: List[api.Pod] = []
        for wi, wv_pods in enumerate(waves):
            for i, pod in enumerate(wv_pods):
                self.metrics.schedule_attempts.inc()
                node_idx = int(chosen_all[wi, i])
                if node_idx >= 0:
                    node_name = self.snapshot.node_names[node_idx]
                    if self._commit(pod, node_name):
                        placed += 1
                        committed.add(pod.uid)
                        continue
                # rejected by the exact recheck, or failed on the device:
                # batched preemption handles resource-starved failures;
                # everything else goes back through the queue
                self.snapshot.unstage(pod)
                retry.append(pod)
        if rt is not None:
            rt.mark("commit", placed=placed)
        try:
            handled = self._pipeline_preempt(retry) if retry else set()
        except Exception:
            # a what-if that raises (KernelBuildError) leaves the round's
            # failures in the queue
            for pod in retry:
                self.queue.add_if_not_present(pod)
            raise
        for pod in retry:
            if pod.uid not in handled:
                self.queue.add_if_not_present(pod)
        trace.step("committed")
        self.metrics.e2e_scheduling_latency.observe(self.clock() - start)
        self.metrics.waves_total.labels(path="device").inc(len(waves))
        if rt is not None:
            if retry:
                rt.mark("preempt", candidates=len(retry),
                        handled=len(handled))
            # the [W, P, ...] planes flattened to the real pods (pad
            # waves and pad rows carry none)
            sel = [(wi, i) for wi, wv in enumerate(waves)
                   for i in range(len(wv))]
            wi_idx = np.asarray([x[0] for x in sel], np.int64)
            i_idx = np.asarray([x[1] for x in sel], np.int64)
            scores, shadow = self._record_decisions(
                rec, pods, chosen_all[wi_idx, i_idx],
                *(a[wi_idx, i_idx] for a in deco_all),
                committed=committed, wvec=wvec, wver=wver)
            shadow = self._merge_exact(shadow, exact_info)
            self._emit_telemetry(rt)
            rec.end_round(
                rt, outcome="ok", placed=placed, retried=len(retry),
                preempted=len(handled), scores=scores, shadow=shadow,
                path=self.wave_path(),
                snapshot=self._round_snapshot_shape(),
                breaker=self.breaker.state)
        trace.log_if_long(0.5)
        return placed

    # -- batched preemption (kubernetes_tpu/sched/scheduler.py:1965) -----------

    def _pipeline_preempt(self, pods: List[api.Pod],
                          host: bool = False) -> set:
        """Batched preemption for round failures: one what-if launch
        computes the stats for every failed pod x node of a chunk (the
        numpy twin's when `host` is set, device_preemption is off, or
        the device is not admitted), then the host runs the exact victim
        selection and the tie-breaks on the few ranked candidates.
        Returns the uids handled (nominated + parked); the rest go back
        to the queue."""
        if self.disable_preemption:
            return set()
        if not self.device_preemption:
            host = True
        cands = [p for p in pods
                 if pod_eligible_to_preempt_others(p, self.cache)]
        if not cands:
            return set()
        # chunk at wave_size; later chunks see earlier chunks' evictions
        # through the refreshed snapshot, and the claimed map spans chunks
        # so freed capacity is never double-counted
        handled: set = set()
        claimed: Dict[str, List[api.Pod]] = {}
        exhausted: Dict[str, int] = {}
        for i in range(0, len(cands), self.wave_size):
            handled |= self._preempt_chunk(cands[i:i + self.wave_size],
                                           claimed, exhausted, host=host)
        return handled

    def _preempt_gang_weights(self):
        """Victim-gang disruption weights for the what-if stats: 1 for
        placed members of gangs with no slack above minMember (any
        eviction breaks them). Returns (guard, f32 [M] weights or None)."""
        guard, placed_gangs, gang_mins = self._gang_state()
        if guard is None:
            return None, None
        w = np.zeros((self.snapshot.caps.M,), np.float32)
        for gkey, gmembers in placed_gangs.items():
            if len(gmembers) <= gang_mins[gkey]:
                for gp in gmembers:
                    slot = self.snapshot.pod_slot.get(gp.uid)
                    if slot is not None:
                        w[slot] = 1.0
        return guard, (w if w.any() else None)

    def _whatif(self, pb, levels, gang_w, host: bool):
        """The what-if of one preemption chunk: packed [5, P, N] stats as
        numpy. On the device (one launch, one fetch), or through the numpy
        twin when `host` is set or the device is not admitted; any other
        failure of the dispatch or the fetch, an out-of-memory error
        included, feeds the breaker and the chunk is salvaged on the twin
        (kubernetes_tpu/sched/scheduler.py:2039-2090). A kernel that
        cannot be built or refuses the inputs (KernelBuildError) raises
        as it does in the round: it is not a device fault."""
        if not host and not self._device_admitted():
            # the breaker opened (or a dispatch wedged) mid-round: the
            # chunk must not follow the wave onto a bad device
            host = True
        if not host:
            try:
                nt, pm, _tt = self.snapshot.to_device(self.device)
                pbt = enc.to_torch(None, None, None, pb, self.device)[3]
                packed = preemption_stats(nt, pm, pbt, levels,
                                          num_levels=PREEMPT_LEVELS,
                                          gang_w=gang_w)
                # the fetch surfaces the card's faults too: keep it inside
                return packed.cpu().numpy()  # ONE fetch for all planes
            except Exception as e:
                # _device_failure re-raises a KernelBuildError
                self._device_failure(e)
        nt_h, pm_h, _tt = self.snapshot.host_tensors()
        return preemption_stats_host(nt_h, pm_h, pb,
                                     np.asarray(levels, np.int32),
                                     num_levels=PREEMPT_LEVELS,
                                     gang_w=gang_w)

    def _preempt_chunk(self, cands: List[api.Pod],
                       claimed: Dict[str, List[api.Pod]],
                       exhausted: Dict[str, int],
                       host: bool = False) -> set:
        t0 = self.clock()
        trace = Trace(f"preempt chunk of {len(cands)}", clock=self.clock)
        pb, cands = self._featurize_guarded(cands)
        if not cands:
            return set()
        # candidate thresholds: distinct priorities of live existing pods
        # (+1 so "< level" removes that class); always keep the HIGHEST
        # so the remove-all-lower option survives the level cap
        live = self.snapshot.ep_valid & self.snapshot.ep_alive
        levels = victim_levels(self.snapshot.ep_prio, live, PREEMPT_LEVELS)
        if levels is None:
            return set()
        # victim-gang awareness: the per-class segment sum ranks
        # gang-sparing nodes first; None for gang-free clusters
        guard, gang_w = self._preempt_gang_weights()
        packed = self._whatif(pb, levels, gang_w, host)
        trace.step("what-if")
        st = PreemptStats(packed)
        ok, victims_n = st.ok, st.victims
        psum, pmax = st.prio_sum, st.prio_max
        gviol = st.gang_viol
        trace.step("fetched")
        pdbs = self._pdbs()
        handled: set = set()
        # `claimed` = capacity claimed by earlier pods in this batch (the
        # host analog of the reference's nominated-pod accounting):
        # without it, one freed node would absorb every later candidate's
        # validation and the batch would degenerate to one eviction a
        # round
        for i, pod in enumerate(cands):
            cand_nodes = np.nonzero(ok[i])[0]
            if cand_nodes.size == 0:
                continue
            self.metrics.total_preemption_attempts.inc()
            # the device ranking approximates the reference's tie-breaks
            # to pick the TOP-K; the exact criteria (PDB violations
            # included) re-rank the validated candidates below. Python's
            # stable sort over keys read once from the planes.
            keys = list(zip(gviol[i, cand_nodes].astype(float).tolist(),
                            pmax[i, cand_nodes].astype(float).tolist(),
                            psum[i, cand_nodes].astype(float).tolist(),
                            victims_n[i, cand_nodes].astype(float).tolist()))
            nodes = cand_nodes.tolist()
            order = [nodes[j] for j in sorted(range(len(nodes)),
                                              key=keys.__getitem__)]
            aff = pod.spec.affinity
            with_aff = bool(self.snapshot.has_affinity_terms
                            or (aff is not None
                                and (aff.pod_affinity is not None
                                     or aff.pod_anti_affinity is not None))
                            # spread's what-if reads cluster-wide domain
                            # counts through the view, like affinity
                            or golden.has_hard_spread(pod))
            node_infos = self.cache.node_infos if with_aff else None
            validated = {}
            tried = 0
            for n in order:
                if tried >= PREEMPT_HOST_CANDIDATES:
                    break
                name = self.snapshot.node_names[n]
                ni = self.cache.node_infos.get(name)
                if ni is None or ni.node is None:
                    continue
                # a node that already FAILED validation at (or below) its
                # current claim count can't absorb another preemptor —
                # skip it WITHOUT spending a validation slot
                if (name in exhausted
                        and len(claimed.get(name, ())) >= exhausted[name]):
                    continue
                tried += 1
                if claimed.get(name):
                    ni = ni.clone()
                    for cp in claimed[name]:
                        ni.add_pod(cp)
                sel = select_victims_on_node(pod, ni, pdbs, node_infos,
                                             self._host_extra_fit, guard)
                if sel is not None:
                    validated[name] = sel
                elif claimed.get(name):
                    # validation failures on an UNclaimed node are pod-
                    # specific (PDB, affinity) — don't block other pods
                    exhausted[name] = len(claimed[name])
            if self.profile.extenders:
                # the preempt verbs trim the validated candidates
                # (kubernetes_tpu/sched/scheduler.py:2154-2157)
                validated = process_preemption_with_extenders(
                    pod, validated, self.profile.extenders, pdbs)
            chosen = pick_one_node(validated)
            rec = tracing.active()
            if rec is not None:
                rec.event("preempt_whatif", pod=pod.uid,
                          device_candidates=int(cand_nodes.size),
                          validated=len(validated),
                          chosen=chosen or "")
            if chosen is None:
                continue
            victims, nviol = validated[chosen]
            claimed.setdefault(chosen, []).append(pod)
            if not victims:
                # an earlier eviction already freed this node: the pod
                # fits WITHOUT preempting — requeue and let the next
                # round place it (the claim above stops later batch
                # members from also counting on this capacity)
                continue
            self._perform_preemption(
                pod, PreemptionResult(chosen, victims, nviol))
            self._park_with_backoff(pod)
            self.pipeline_preemptions += 1
            handled.add(pod.uid)
        trace.step("validated+performed")
        trace.log_if_long(0.5)
        self.metrics.preemption_evaluation.observe(self.clock() - t0)
        return handled

    # -- the per-wave loop (kubernetes_tpu/sched/scheduler.py:3028) -------------

    def _run_wave(self, pods: List[api.Pod]) -> int:
        """One wave through the per-wave dispatch, with the device-fault
        ladder of kubernetes_tpu/sched/scheduler.py:3028-3321: not
        admitted, the wave drains through the twin; a failed dispatch
        gets an input-fault verdict first, then feeds the breaker and
        degrades THIS wave to the twin; the sentinel's flagged pods are
        convicted and the survivors re-run."""
        if not self._device_admitted():
            return self._schedule_degraded(pods)
        # gang members place through the all-or-nothing path; pop_wave
        # delivers gangs whole
        placed_gang = 0
        gang_pods = [p for p in pods if self.gangs.key(p) is not None]
        if gang_pods:
            pods = [p for p in pods if self.gangs.key(p) is None]
            placed_gang = self._schedule_gangs(gang_pods)
            if not pods:
                return placed_gang
            if not self._device_admitted():
                # a gang dispatch was just abandoned by the watchdog: the
                # wave must not follow it onto the wedged device
                return placed_gang + self._schedule_degraded(pods)
        # pods whose required pod-(anti)affinity spans more than one
        # topology key take the exact host path
        host_path = [p for p in pods if self.featurizer.needs_host_path(p)]
        golden = self._golden_reasons(host_path)
        pods = [p for p in pods if not self.featurizer.needs_host_path(p)]
        placed_gang += self._schedule_host_batch(host_path)
        if not pods:
            if golden:
                tracing.event("golden_gap", **golden)
            return placed_gang
        trace = Trace(f"wave of {len(pods)}", clock=self.clock)
        start = self.clock()
        # ONE weight view a round (see _run_pipeline)
        gating, wvec, wver = self._weights_kw()
        rec = tracing.active()
        rt = None
        if rec is not None:
            rt = rec.begin_round("wave", pending=len(pods),
                                 weights_version=wver)
            self._trace_queue_waits(rt, pods)
            if golden:
                rt.ledger["golden"] = golden
        try:
            pb, pods = self._featurize_guarded(pods)
        except Exception as e:
            # an allocation-site MemoryError goes to the capacity ladder
            # (see _run_pipeline's featurize loop)
            if not is_capacity_error(e):
                raise
            return placed_gang + self._capacity_fault(pods, e, rt, rec,
                                                      self._run_wave)
        if not pods:
            # the whole wave was convicted at featurize time
            if rt is not None:
                rec.end_round(rt, outcome="input_fault")
            return placed_gang
        P = pb.req.shape[0]
        try:
            extra = self._host_plugin_mask(pods, P)
            extra_scores = self._host_score_matrix(pods, P)
        except ExtenderError:
            # only this attempt fails: the wave parks
            # (kubernetes_tpu/sched/scheduler.py:3087-3100)
            self._extender_failed(pods, rt, rec)
            return placed_gang
        trace.step("featurized")
        if rt is not None:
            rt.mark("featurize", pods=len(pods))
            up0 = self.snapshot.upload_bytes_total
        try:
            # the chaos seam while pb is still the host batch (see
            # _run_pipeline)
            self._wave_poison_seam(pods, pb)
        except Exception as e:
            verdict = self._input_fault_verdict(pods, e)
            if rt is not None:
                rec.end_round(rt, outcome=("input_fault"
                                           if verdict is not None
                                           else "device_failure"),
                              error=type(e).__name__)
            if verdict is None:
                # transient: park the wave for a clean retry
                for p in pods:
                    self._park_with_backoff(p)
                return placed_gang
            return placed_gang + self._isolate_poison(pods, verdict,
                                                      self._run_wave)
        dev = self.device
        nt, pm, tt = self.snapshot.to_device(dev)
        if rt is not None:
            rt.mark("upload", cat="device",
                    bytes=self.snapshot.upload_bytes_total - up0)
        self._account_host_overrun(self.clock() - start)
        if self._rr is None:
            # re-seed from the host mirror (a twin pass dropped _rr)
            self._rr = torch.tensor(self._host_rr, dtype=torch.int32,
                                    device=dev)
        has_ipa = bool(self.snapshot.has_affinity_terms or pb.ra_has.any()
                       or pb.rn_has.any() or (pb.pa_w != 0).any())
        launches0 = taint_ports_masks.launches
        try:
            pbt = enc.to_torch(None, None, None, pb, dev)[3]
            # the host inputs go up in one copy each
            extra_t = torch.from_numpy(extra).to(dev)
            scores_t = (torch.from_numpy(extra_scores).to(dev)
                        if extra_scores is not None else None)
            # the decomposition rides along exactly when tracing
            res = schedule_wave(nt, pm, tt, pbt, extra_t, self._rr,
                                scores_t, weights=gating,
                                num_zones=self.snapshot.caps.Z,
                                num_label_values=self.snapshot
                                .num_label_values,
                                has_ipa=has_ipa,
                                has_ts=bool(pb.ts_valid.any()),
                                collect_scores=rt is not None,
                                weight_vec=enc.weight_vec_to_torch(wvec,
                                                                   dev))
            # the fetch surfaces the card's faults too: inside the try
            chosen = res.chosen.cpu().numpy()
            fin = res.finite.cpu().numpy()
        except Exception as e:
            if isinstance(e, KernelBuildError):
                # not a device fault (see _run_pipeline)
                for p in pods:
                    self.queue.add_if_not_present(p)
                if rt is not None:
                    rec.end_round(rt, outcome="error",
                                  error=type(e).__name__)
                raise
            # capacity-fault attribution FIRST (see _run_pipeline)
            if is_capacity_error(e):
                return placed_gang + self._capacity_fault(
                    pods, e, rt, rec, self._run_wave)
            # input-fault attribution BEFORE breaker accounting
            verdict = self._input_fault_verdict(pods, e)
            if verdict is not None:
                if rt is not None:
                    rec.end_round(rt, outcome="input_fault",
                                  error=type(e).__name__)
                return placed_gang + self._isolate_poison(pods, verdict,
                                                          self._run_wave)
            # count it against the breaker and degrade THIS wave to the
            # twin: a device fault costs a slower wave, never a stopped
            # scheduler. golden is not re-passed (this wave's record
            # has it).
            self._device_failure(e)
            if rt is not None:
                rec.end_round(rt, outcome="device_failure",
                              error=type(e).__name__)
            return placed_gang + self._schedule_degraded(pods)
        self.breaker.record_success()
        self._capacity_strikes = 0
        self._note_path(launches0)
        # numeric-integrity sentinel, fetched with chosen: the WHOLE wave
        # is discarded, the flagged pods convicted, the survivors re-run;
        # rr not advanced
        bad = [pods[i].uid for i in range(len(pods)) if not fin[i]]
        if bad:
            if rt is not None:
                rec.end_round(rt, outcome="input_fault", poison=len(bad))
            return placed_gang + self._isolate_poison(
                pods, PoisonError("numeric-integrity sentinel", uids=bad),
                self._run_wave)
        self._rr = res.rr_end
        if rt is not None:
            rt.mark("device_wave", cat="device", path=self.wave_path())
        # the mirror: one rr advance a placement
        self._host_rr += int(np.sum(chosen >= 0))
        fetched = chosen.nbytes + fin.nbytes
        deco = None
        if res.deco is not None:
            deco = tuple(a.cpu().numpy() for a in res.deco)
            fetched += sum(a.nbytes for a in deco)
        self.metrics.device_fetch_bytes.inc(fetched)
        trace.step("device wave")
        if rt is not None:
            rt.mark("fetch", cat="device", bytes=int(fetched))
        placed = 0
        committed: set = set()
        fail_counts = masks = None
        for i, pod in enumerate(pods):
            self.metrics.schedule_attempts.inc()
            node_idx = int(chosen[i])
            if node_idx >= 0:
                node_name = self.snapshot.node_names[node_idx]
                if self._commit(pod, node_name):
                    placed += 1
                    committed.add(pod.uid)
                    continue
                # exact recheck lost a race with device f32 arithmetic:
                # retry next wave without counting it unschedulable
                self.queue.add_if_not_present(pod)
                continue
            if fail_counts is None:
                fail_counts = res.fail_counts.cpu().numpy()
                masks = res.masks.cpu().numpy()
            self._handle_failure(pod, i, fail_counts, masks)
        trace.step("committed")
        self.metrics.e2e_scheduling_latency.observe(self.clock() - start)
        self.metrics.waves_total.labels(path="device").inc()
        if rt is not None:
            rt.mark("commit", placed=placed)
            scores = shadow = None
            if deco is not None:
                scores, shadow = self._record_decisions(
                    rec, pods, chosen, *deco, committed=committed,
                    wvec=wvec, wver=wver)
            if scores is None and committed:
                # a summary over the placements that committed only
                sc = res.score.cpu().numpy()
                won = sc[[i for i, p in enumerate(pods)
                          if p.uid in committed]]
                scores = ({"min": round(float(won.min()), 4),
                           "max": round(float(won.max()), 4),
                           "mean": round(float(won.mean()), 4)}
                          if won.size else None)
            self._emit_telemetry(rt)
            rec.end_round(
                rt, outcome="ok", placed=placed,
                failed=len(pods) - placed, path=self.wave_path(),
                scores=scores, shadow=shadow,
                snapshot=self._round_snapshot_shape(),
                breaker=self.breaker.state)
        trace.log_if_long(0.1)
        return placed + placed_gang

    # -- the device-fault ladder (kubernetes_tpu/sched/scheduler.py:2184-2550) ---

    def _device_failure(self, exc: BaseException) -> bool:
        """Account one device-path failure: a watchdog abandonment
        (DispatchTimeout) trips the breaker at once (record_hang), any
        other failure counts toward its threshold. The port has no mesh
        to reform, so this always returns False (not reformed), as the
        JAX scheduler's does without a mesh. A KernelBuildError (a
        kernel that cannot be built or loaded, or a wrapper's
        KernelInputError refusal) is not a device fault: it re-raises
        and the breaker is left as it is."""
        if isinstance(exc, KernelBuildError):
            raise exc
        self.metrics.scheduling_errors.labels(stage="wave").inc()
        if isinstance(exc, DispatchTimeout):
            self.breaker.record_hang()
        else:
            self.breaker.record_failure()
        logging.getLogger(__name__).error(
            "device wave failed (%s consecutive, breaker %s): %s: %s",
            self.breaker.failures, self.breaker.state,
            type(exc).__name__, exc, exc_info=exc)
        return False

    def _capacity_fault(self, pods: List[api.Pod], exc: BaseException,
                        rt, rec, retry_fn) -> int:
        """The capacity-fault ladder (kubernetes_tpu/sched/scheduler.py:
        2551-2597): an out-of-memory error or a MemoryError at the device
        boundary is the scheduler's OWN footprint outgrowing the card —
        never the card's fault and never the work's, so it convicts no
        pod and feeds the breaker only when compaction cannot restore
        the budget's headroom. Every strike compacts the snapshot; strike
        1 retries; strikes 2 and later also halve the adaptive wave cap
        (floor MIN_ADAPTIVE_WAVE); strike 3 and later salvage the round
        through the numpy twin, which needs no device memory. Strikes
        reset on the next successful dispatch."""
        self._capacity_strikes += 1
        strike = self._capacity_strikes
        self.metrics.capacity_faults.inc()
        logging.getLogger(__name__).warning(
            "capacity fault (strike %d), compacting: %s: %s", strike,
            type(exc).__name__, exc)
        summary = self._compact_guarded(trigger="oom")
        if strike >= 2:
            # the floor of _account_host_overrun: a scheduler configured
            # below the adaptive floor never has a fault RAISE its wave
            self._wave_cap = max(self._wave_cap // 2,
                                 min(self.MIN_ADAPTIVE_WAVE,
                                     self.wave_size))
            self.metrics.effective_wave_size.set(self._wave_cap)
        headroom = self.snapshot.hbm_headroom_bytes()
        exhausted = headroom is not None and headroom < 0
        if exhausted:
            # compaction could not restore headroom: only now does the
            # fault feed the breaker
            self.breaker.record_failure()
        if rt is not None:
            rec.end_round(rt, outcome="capacity_fault",
                          error=type(exc).__name__,
                          memory=self._memory_ledger())
        if strike >= 3 or summary is None or exhausted:
            # third strike, compaction deferred or failed, or the budget
            # still exceeded: salvage the round on the host instead of
            # burning another dispatch
            return self._schedule_degraded(pods)
        return retry_fn(pods)

    def _compact_guarded(self, trigger: str):
        """scrubber.compact for the scheduling loop: a crash inside the
        compaction (the `snapshot.compact` fault point, or a real bug)
        costs the compaction, never the round — the live snapshot is
        untouched until the scratch rebuild fully succeeds. Returns the
        summary, or None when the compaction failed or was deferred."""
        try:
            return self.scrubber.compact(trigger=trigger, force=True)
        except Exception as ce:
            logging.getLogger(__name__).error(
                "snapshot compaction failed (live snapshot unchanged): "
                "%s: %s", type(ce).__name__, ce)
            return None

    def _memory_ledger(self) -> Dict:
        """The round ledger's `memory` record: {hbm_bytes, budget,
        headroom, vocabs, compactions, capacity_strikes}; headroom is
        None when no budget is configured."""
        return {
            "hbm_bytes": int(self.snapshot.projected_hbm_bytes()),
            "budget": int(self.snapshot.hbm_budget_bytes),
            "headroom": self.snapshot.hbm_headroom_bytes(),
            "vocabs": self.snapshot.vocabs.sizes(),
            "compactions": int(
                self.metrics.snapshot_compactions_total.total()),
            "capacity_strikes": int(self._capacity_strikes),
        }

    def _needs_golden(self, pod: api.Pod) -> bool:
        """Must this pod take the exact golden path instead of the twin?
        Only for the encoding neither the twin nor the device carries:
        multi-topology-key required affinity (needs_host_path)."""
        return self.featurizer.needs_host_path(pod)

    def _count_degraded_golden(self, pods: List[api.Pod], rt=None) -> None:
        """Degraded-mode visibility: pods the twin can't encode drain
        through the golden path; count them by reason
        (scheduler_degraded_golden_pods_total{reason}) and tag the round
        ledger."""
        counts = self._golden_reasons(pods)
        for r, n in counts.items():
            self.metrics.degraded_golden_pods.labels(reason=r).inc(n)
        if rt is not None:
            g = rt.ledger.setdefault("degraded_golden", {})
            for r, n in counts.items():
                g[r] = g.get(r, 0) + n

    def _schedule_degraded(self, pods: List[api.Pod],
                           golden: Optional[Dict[str, int]] = None) -> int:
        """Breaker-open degraded mode: the backlog drains through the
        numpy twin (ops/hostwave.py) — one batched mask+score wave a
        wave_size chunk, batched twin preemption for its failures, and
        all-or-nothing gang placement through the twin's
        count-feasibility plane. Pods the twin can't encode take the
        exact golden path, as they do on the device path. Nothing here
        touches the device."""
        gating, wvec, wver = self._weights_kw()
        rec = tracing.active()
        rt = None
        if rec is not None:
            rt = rec.begin_round("degraded", pending=len(pods),
                                 weights_version=wver)
            self._trace_queue_waits(rt, pods)
            if golden:
                g = rt.ledger.setdefault("golden", {})
                for r, n in golden.items():
                    g[r] = g.get(r, 0) + n
        placed = 0
        # gangs stay atomic in degraded mode
        gang_pods = [p for p in pods if self.gangs.key(p) is not None]
        if gang_pods:
            pods = [p for p in pods if self.gangs.key(p) is None]
            groups: Dict[str, List[api.Pod]] = {}
            for p in gang_pods:
                groups.setdefault(self.gangs.key(p), []).append(p)
            for key, members in groups.items():
                placed += self._schedule_degraded_gang(key, members, rt)
        golden_pods = [p for p in pods if self._needs_golden(p)]
        if golden_pods:
            pods = [p for p in pods if not self._needs_golden(p)]
            self._count_degraded_golden(golden_pods, rt)
            placed += self._schedule_host_batch(golden_pods)
        # chunk at wave_size: featurize buckets caps.P by batch length
        deco_acc: Optional[List] = [] if rt is not None else None
        committed: set = set()
        for i in range(0, len(pods), self.wave_size):
            placed += self._host_wave(pods[i:i + self.wave_size], rt,
                                      deco_acc=deco_acc,
                                      committed=committed,
                                      weights_view=(gating, wvec))
        if rt is not None:
            scores = shadow = None
            if deco_acc:
                # one decision-recording pass over every twin chunk's
                # decomposition
                all_pods = [p for ps, _c, _d in deco_acc for p in ps]
                chosen_cat = np.concatenate([c for _p, c, _d in deco_acc])
                planes = [np.concatenate([d[k] for _p, _c, d in deco_acc])
                          for k in range(4)]
                scores, shadow = self._record_decisions(
                    rec, all_pods, chosen_cat, *planes,
                    committed=committed, wvec=wvec, wver=wver)
            self._emit_telemetry(rt, device_ok=False)
            rec.end_round(rt, outcome="ok", placed=placed, path="host",
                          scores=scores, shadow=shadow,
                          breaker=self.breaker.state,
                          snapshot=self._round_snapshot_shape())
        return placed

    def _host_wave(self, pods: List[api.Pod], rt=None,
                   deco_acc: Optional[List] = None,
                   committed: Optional[set] = None,
                   weights_view=None) -> int:
        """One batched twin wave: numpy masks, scores and greedy commit
        over the snapshot's host planes (no device touch), then the same
        exact int64 recheck -> assume -> bind commit as the device path.
        Failures go through ONE batched twin preemption pass, then park
        with exact FitError attribution from the twin's mask stack.

        deco_acc: when tracing, (pods, chosen, deco) of the chunk is
        appended for the degraded round's decision-recording pass."""
        if not pods:
            return 0
        trace = Trace(f"host wave of {len(pods)}", clock=self.clock)
        start = self.clock()
        for _p in pods:
            self.metrics.schedule_attempts.inc()
        runner = (lambda ps: self._host_wave(
            ps, rt, deco_acc=deco_acc, committed=committed,
            weights_view=weights_view))
        pb, pods = self._featurize_guarded(pods)
        if not pods:
            return 0  # the whole chunk was convicted at featurize time
        P = pb.req.shape[0]
        try:
            extra = self._host_plugin_mask(pods, P)
            extra_scores = self._host_score_matrix(pods, P)
        except ExtenderError:
            # kubernetes_tpu/sched/scheduler.py:2319-2325
            self._extender_failed(pods)
            return 0
        trace.step("featurized")
        if rt is not None:
            rt.mark("featurize", pods=len(pods))
        nt, pm, tt = self.snapshot.host_tensors()
        gating, wvec = (weights_view if weights_view is not None
                        else self._weights_kw()[:2])
        has_ipa = bool(self.snapshot.has_affinity_terms or pb.ra_has.any()
                       or pb.rn_has.any() or (pb.pa_w != 0).any())
        try:
            self._wave_poison_seam(pods, pb)
            res, _usage = hostwave.schedule_wave_host(
                nt, pm, tt, pb, extra, self._host_rr, extra_scores,
                weights=gating,
                num_zones=self.snapshot.caps.Z,
                num_label_values=self.snapshot.num_label_values,
                has_ipa=has_ipa,
                collect_scores=deco_acc is not None,
                weight_vec=wvec)
        except Exception as e:
            # a crash on the host path follows the data (no device to
            # blame): input fault — bisect to the culprit. Known
            # infrastructure errors are exempt.
            if self._infra_error(e):
                self.metrics.scheduling_errors.labels(stage="wave").inc()
                logging.getLogger(__name__).error(
                    "host wave failed on infrastructure, parking %d "
                    "pods", len(pods), exc_info=e)
                for p in pods:
                    self._park_with_backoff(p)
                return 0
            verdict = (e if isinstance(e, (PoisonError, PodFeaturizeError))
                       else PoisonError(f"host twin pass failed: "
                                        f"{type(e).__name__}: {e}"))
            return self._isolate_poison(pods, verdict, runner)
        # numeric-integrity sentinel: discard the chunk, convict the
        # flagged pods, re-run the survivors (host rr not advanced)
        fin = np.asarray(res.finite)
        bad = [pods[i].uid for i in range(len(pods)) if not fin[i]]
        if bad:
            return self._isolate_poison(
                pods, PoisonError("numeric-integrity sentinel", uids=bad),
                runner)
        if deco_acc is not None and res.deco is not None:
            # featurize's P-bucket pad rows sliced off: the degraded round
            # concatenates chunks
            n = len(pods)
            deco_acc.append((list(pods), np.asarray(res.chosen[:n]),
                             tuple(np.asarray(a)[:n] for a in res.deco)))
        self._host_rr = int(res.rr_end)
        self._rr = None  # device resumption re-seeds from the mirror
        self._last_path = "host"
        trace.step("host wave")
        if rt is not None:
            rt.mark("host_wave", cat="host", backend="vector",
                    pods=len(pods))
        placed = 0
        failed: List = []
        for i, pod in enumerate(pods):
            node_idx = int(res.chosen[i])
            if node_idx >= 0:
                if self._commit(pod, self.snapshot.node_names[node_idx]):
                    placed += 1
                    if committed is not None:
                        committed.add(pod.uid)
                    continue
                # exact recheck lost a race with f32 arithmetic: retry
                self.queue.add_if_not_present(pod)
                continue
            failed.append((i, pod))
        trace.step("committed")
        if rt is not None:
            rt.mark("commit", placed=placed)
        handled: set = set()
        if failed:
            handled = self._pipeline_preempt([p for _, p in failed],
                                             host=True)
            for i, pod in failed:
                self.metrics.pods_failed.inc()
                err = self._fit_error(pod, i, res.fail_counts, res.masks)
                self._count_unschedulable(err)
                if pod.uid not in handled:
                    self._park_with_backoff(pod)
                self.store.set_pod_condition(
                    pod, ("PodScheduled", "False:" + err.message()))
            if rt is not None:
                rt.mark("preempt", candidates=len(failed),
                        handled=len(handled))
        self.metrics.e2e_scheduling_latency.observe(self.clock() - start)
        self.metrics.waves_total.labels(path="host").inc()
        trace.log_if_long(0.5)
        return placed

    def _schedule_degraded_gang(self, key: str, members: List[api.Pod],
                                rt=None) -> int:
        """Degraded-mode gang placement through the twin's all-or-nothing
        count-feasibility plane (ops/hostwave.py schedule_gang_host):
        minMember members hold capacity together or nothing commits.
        Gangs with golden-only members place individually."""
        self.metrics.gang_schedule_attempts.inc()
        for _p in members:
            self.metrics.schedule_attempts.inc()
        if any(self._needs_golden(p) for p in members):
            self._count_degraded_golden(
                [p for p in members if self._needs_golden(p)], rt)
            return self._schedule_host_batch(members)
        min_member = self.gangs.min_member(members[0])
        bound = self.gangs.bound_count(self.cache, key,
                                       exclude={p.uid for p in members})
        need = max(min_member - bound, 0)
        try:
            pb = self.featurizer.featurize(members)
        except PodFeaturizeError as e:
            # gang-atomic conviction, as on the device path
            self._gang_input_fault(members, e, rt)
            return 0
        P = pb.req.shape[0]
        try:
            extra = self._host_plugin_mask(members, P)
            extra_scores = self._host_score_matrix(members, P)
        except ExtenderError:
            # kubernetes_tpu/sched/scheduler.py:2453-2461
            self._extender_failed(members)
            return 0
        nt, pm, tt = self.snapshot.host_tensors()
        gating, wvec, _wver = self._weights_kw()
        has_ipa = bool(self.snapshot.has_affinity_terms or pb.ra_has.any()
                       or pb.rn_has.any() or (pb.pa_w != 0).any())
        try:
            self._wave_poison_seam(members, pb)
            res = hostwave.schedule_gang_host(
                nt, pm, tt, pb, extra, self._host_rr, extra_scores, need,
                weights=gating,
                num_zones=self.snapshot.caps.Z,
                num_label_values=self.snapshot.num_label_values,
                has_ipa=has_ipa,
                weight_vec=wvec)
        except Exception as e:
            # a host-path crash follows the data: the gang convicts whole
            verdict = (e if isinstance(e, (PoisonError, PodFeaturizeError))
                       else PoisonError(f"host twin gang pass failed: "
                                        f"{type(e).__name__}: {e}"))
            self._gang_input_fault(members, verdict, rt)
            return 0
        self._last_path = "host"
        if rt is not None:
            rt.mark("host_wave", cat="host", backend="vector", gang=key,
                    pods=len(members))
        fin = np.asarray(res.finite)
        bad = [members[i].uid for i in range(len(members)) if not fin[i]]
        if bad:
            self._gang_input_fault(
                members,
                PoisonError("numeric-integrity sentinel", uids=bad), rt)
            return 0
        if not bool(res.ok):
            self._fail_gang(key, members, need, res.masks, int(res.placed))
            return 0
        self._host_rr = int(res.rr_end)
        self._rr = None  # device resumption re-seeds from the mirror
        pairs: List = []
        leftover: List = []
        for i, pod in enumerate(members):
            n = int(res.chosen[i])
            if n >= 0:
                pairs.append((pod, self.snapshot.node_names[n]))
            else:
                leftover.append((i, pod))
        if not self._commit_gang(pairs):
            for pod in members:
                self.queue.add_if_not_present(pod)
            return 0
        self.backoff.clear("gang:" + key)
        self.metrics.waves_total.labels(path="host").inc()
        if leftover:
            for i, pod in leftover:
                self._handle_failure(pod, i, res.fail_counts, res.masks)
        return len(pairs)

    # -- poison-work isolation (kubernetes_tpu/sched/scheduler.py:2796-3012) ---

    # the attribution replay is bounded: a poison beyond it is caught by
    # the salvage path's own twin waves
    ATTRIBUTION_REPLAY_MAX_WAVES = 4

    def _wave_poison_seam(self, pods: List[api.Pod], pb) -> None:
        """The `wave.poison` chaos seam: fired before EVERY batched pass
        over a pod list — device round/wave/gang dispatches, degraded
        twin waves and the input-fault attribution replay — with (pods,
        host PodBatch) as payload, so an injected poison follows the
        DATA across backends (state/featurize.py poison_pod_fault)."""
        faultpoints.fire("wave.poison", payload=(pods, pb))

    def _featurize_guarded(self, pods: List[api.Pod]):
        """(PodBatch, survivors): featurize a batch, convicting pods
        whose spec crashes (or numerically poisons) the featurizer.
        Returns (None, []) when every pod was convicted."""
        pods = list(pods)
        while pods:
            try:
                return self.featurizer.featurize(pods), pods
            except PodFeaturizeError as e:
                pods = self._convict_featurize_victim(e, pods)
        return None, []

    def _convict_featurize_victim(self, e: PodFeaturizeError,
                                  pods: List[api.Pod]) -> List[api.Pod]:
        """Quarantine the pod the typed error names and return the
        survivors. Re-raises when it names a pod outside the batch (a
        bug, not poison)."""
        victims = [p for p in pods if p.uid == e.uid]
        if not victims:
            raise e
        self._convict(victims, reason="featurize", error=str(e),
                      cohort=pods)
        return [p for p in pods if p.uid != e.uid]

    @staticmethod
    def _infra_error(exc: BaseException) -> bool:
        """An infrastructure failure (store, REST, OS), which the pod's
        own spec cannot cause (kubernetes_tpu/sched/scheduler.py:
        3390-3406). Conviction paths that wrap phases with side effects
        (commit, preemption) must not blame the work for these."""
        return isinstance(exc, (OSError, TimeoutError, Conflict, KeyError,
                                APIStatusError))

    def _input_fault_verdict(self, pods: List[api.Pod],
                             exc: BaseException):
        """Fault ATTRIBUTION, before any breaker accounting: replay the
        failed batch through the numpy twin over the host planes
        (commits discarded, rr untouched). The twin failing too — or its
        sentinel flagging non-finite planes — convicts the WORK: returns
        the verdict (uids when attribution is direct, none for the
        bisection path). A clean replay returns None: a genuine device
        fault. DispatchTimeout skips the replay — a wedge is the
        device's, never the work's."""
        if isinstance(exc, DispatchTimeout):
            return None
        if isinstance(exc, (PoisonError, PodFeaturizeError)):
            return exc
        replay = pods[:self.ATTRIBUTION_REPLAY_MAX_WAVES * self.wave_size]
        gating, wvec, _wver = self._weights_kw()
        try:
            for s in range(0, len(replay), self.wave_size):
                chunk = replay[s:s + self.wave_size]
                pb = self.featurizer.featurize(chunk)
                self._wave_poison_seam(chunk, pb)
                nt, pm, tt = self.snapshot.host_tensors()
                extra = np.ones((pb.req.shape[0], nt.valid.shape[0]), bool)
                has_ipa = bool(self.snapshot.has_affinity_terms
                               or pb.ra_has.any() or pb.rn_has.any()
                               or (pb.pa_w != 0).any())
                res, _usage = hostwave.schedule_wave_host(
                    nt, pm, tt, pb, extra, self._host_rr, None,
                    weights=gating, num_zones=self.snapshot.caps.Z,
                    num_label_values=self.snapshot.num_label_values,
                    has_ipa=has_ipa, weight_vec=wvec)
                fin = np.asarray(res.finite)
                bad = [p.uid for j, p in enumerate(chunk) if not fin[j]]
                if bad:
                    return PoisonError(
                        "numeric-integrity sentinel flagged the twin "
                        "replay", uids=bad)
        except PodFeaturizeError as fe:
            return fe
        except Exception as replay_exc:
            if self._infra_error(replay_exc):
                # the replay itself failed on infrastructure: that proves
                # nothing about the work
                return None
            return PoisonError(
                f"twin replay reproduced the failure: "
                f"{type(replay_exc).__name__}: {replay_exc}")
        return None

    def _isolate_poison(self, pods: List[api.Pod], verdict,
                        runner) -> int:
        """Input-fault isolation. Direct conviction when the verdict
        names UIDs — the survivors requeue and place bit-equal a clean
        run on the next round. Otherwise WAVE BISECTION: split in half
        preserving order and re-run each half through `runner`; the
        clean half places, the poisoned half fails again and recurses,
        converging on the culprit in log2(wave) rounds. Returns pods
        placed by the retries."""
        self.metrics.scheduling_errors.labels(stage="poison").inc()
        victims, reason = self._verdict_attribution(verdict, pods)
        if victims:
            vuids = {p.uid for p in victims}
            self._convict(victims, reason=reason, error=str(verdict),
                          cohort=pods)
            for p in pods:
                if p.uid not in vuids:
                    self.queue.add_if_not_present(p)
            return 0
        if len(pods) <= 1:
            self._convict(list(pods), reason="bisect", error=str(verdict),
                          cohort=pods)
            return 0
        mid = (len(pods) + 1) // 2
        tracing.event("poison_bisect", pods=len(pods))
        logging.getLogger(__name__).warning(
            "input fault with no direct attribution: bisecting a "
            "%d-pod wave (%s)", len(pods), verdict)
        return runner(pods[:mid]) + runner(pods[mid:])

    def _convict(self, pods: List[api.Pod], reason: str, error: str = "",
                 cohort=()) -> None:
        """Quarantine convicted poison work. Gang-atomic: a poisoned
        member convicts its WHOLE gang (pending mates pulled from every
        queue area and from `cohort`, the in-hand wave mates). Every
        conviction gets a FitError condition, the
        scheduler_poison_pods_total{reason} increment and a capped
        re-probe deadline; a dropped quarantine (the queue.quarantine
        fault) degrades to a plain backoff park."""
        victims: Dict[str, tuple] = {}
        for p in pods:
            victims[p.uid] = (p, reason)
        if self.gangs.active:
            keys: Dict[str, None] = {}
            for p in pods:
                k = self.gangs.key(p)
                if k is not None:
                    keys[k] = None
            for k in keys:
                for mate in self.queue.gang_pending_pods(k):
                    victims.setdefault(mate.uid, (mate, "gang"))
                for mate in cohort:
                    if (mate.uid not in victims
                            and self.gangs.key(mate) == k):
                        victims[mate.uid] = (mate, "gang")
        n_nodes = int(np.sum(self.snapshot.valid))
        log = logging.getLogger(__name__)
        for uid, (pod, r) in victims.items():
            d = self.poison_backoff.bump(uid)
            until = self.clock() + d
            if not self.queue.quarantine(pod, until):
                self._park_with_backoff(pod)
                continue
            self.poison_convictions += 1
            self.metrics.pods_failed.inc()
            self.metrics.poison_pods.labels(reason=r).inc()
            err = FitError(pod.full_name(), n_nodes,
                           {REASONS["Poisoned"]: 1})
            self.store.set_pod_condition(
                pod, ("PodScheduled", "False:" + err.message()))
            tracing.event("pod_quarantined", pod=uid, reason=r,
                          reprobe_s=round(d, 3))
            log.error(
                "poison pod %s quarantined (%s; re-probe in %.1fs): %s",
                pod.full_name(), r, d, error or reason)

    def _gang_input_fault(self, members: List[api.Pod], verdict,
                          rt=None) -> None:
        """Gang flavor of _isolate_poison: no bisection within a gang —
        one poisoned member quarantines the group (the culprit keeps its
        direct reason, the mates are booked under reason=gang)."""
        self.metrics.scheduling_errors.labels(stage="poison").inc()
        culprits, reason = self._verdict_attribution(verdict, members)
        if not culprits:
            culprits = list(members)
        self._convict(culprits, reason=reason, error=str(verdict),
                      cohort=members)
        if rt is not None:
            rt.ledger["outcome"] = "input_fault"

    @staticmethod
    def _verdict_attribution(verdict, pods: List[api.Pod]):
        """(culprits, reason) for one input-fault verdict: the pods it
        names directly with the matching conviction reason, or
        ([], "bisect") when attribution is indirect."""
        uids = set(getattr(verdict, "uids", ()) or ())
        one = getattr(verdict, "uid", None)
        if one:
            uids.add(one)
        culprits = [p for p in pods if p.uid in uids]
        if not culprits:
            return [], "bisect"
        return culprits, ("featurize"
                          if isinstance(verdict, PodFeaturizeError)
                          else "sentinel")

    # -- the exact host path (kubernetes_tpu/sched/scheduler.py:3334) -------------

    def _extender_node_labels(self) -> Optional[Dict[str, dict]]:
        """node -> labels of every cached node, for the filter extenders
        that are not nodeCacheCapable; None when there is none. Built once
        a batch and passed down (kubernetes_tpu/sched/scheduler.py:
        3323-3332)."""
        if not any(e.filter_verb and not e.node_cache_capable
                   for e in self.profile.extenders):
            return None
        return {n: (ni.node.metadata.labels or {})
                for n, ni in self.cache.node_infos.items()
                if ni.node is not None}

    def _schedule_host_batch(self, pods: List[api.Pod]) -> int:
        """The exact host path for `pods`, one pod at a time, over one
        ClusterView and one extender node-labels map shared by the batch
        (both read the live cache, so commits and evictions inside the
        loop stay visible) (kubernetes_tpu/sched/scheduler.py:3334-3388).
        The per-pod loop
        is the fault domain: a pod whose spec crashes the golden pass is
        convicted (reason golden, into the queue's quarantine) and the
        batch drains on; an infrastructure failure parks its pod with
        backoff; when EVERY pod of a batch of two or more crashed, the
        fault is systemic and the batch is parked, not convicted.
        Returns the pods placed."""
        if not pods:
            return 0
        view = golden.ClusterView(self.cache.node_infos)
        node_labels = self._extender_node_labels()
        placed = 0
        crashed: List[tuple] = []
        for p in pods:
            try:
                placed += self._schedule_host_path(p, view, node_labels)
            except Exception as e:
                if self._infra_error(e):
                    # the golden pass also preempts and commits: a store
                    # failure there is not the pod's fault — a plain
                    # backoff park, never a conviction
                    self.metrics.scheduling_errors.labels(
                        stage="bind").inc()
                    logging.getLogger(__name__).error(
                        "golden pass failed on infrastructure, "
                        "parking %s", p.full_name(), exc_info=e)
                    self._park_with_backoff(p)
                    continue
                crashed.append((p, e))
        if crashed and len(crashed) == len(pods) and len(pods) > 1:
            # EVERY pod of the batch crashed the golden pass: a systemic
            # fault (a buggy host plugin, corrupt shared state), not
            # per-pod poison — park the batch instead of quarantining an
            # innocent class. A single-pod batch cannot be told apart and
            # keeps the conviction (the re-probe ladder bounds a wrong
            # call).
            self.metrics.scheduling_errors.labels(stage="wave").inc()
            logging.getLogger(__name__).error(
                "golden pass crashed for ALL %d pods (systemic, not "
                "poison); parking batch", len(pods),
                exc_info=crashed[0][1])
            for p, _e in crashed:
                self._park_with_backoff(p)
            return placed
        for p, e in crashed:
            self._convict([p], reason="golden",
                          error=f"{type(e).__name__}: {e}")
        return placed

    def _schedule_host_path(self, pod: api.Pod, view, node_labels) -> int:
        """The exact one-pod pass over plugins/golden.py for a pod the
        round cannot encode (kubernetes_tpu/sched/scheduler.py:3408-3535):
        its predicates and the profile's host filters on every node, then
        each filter extender over the nodes still feasible, host
        preemption when none fits, else the golden scores plus the
        profile's host scores and the extenders' priorities over the
        feasible nodes, and a commit on the first best node. Returns 1 if
        it placed the pod. node_labels: the batch's
        `_extender_node_labels`. Traced as a `host_wave` span of backend
        "golden"."""
        self.metrics.schedule_attempts.inc()
        self.metrics.waves_total.labels(path="host").inc()
        rec = tracing.active()
        if rec is None:
            return self._host_path_inner(pod, view, node_labels)
        t0 = rec.now()
        try:
            return self._host_path_inner(pod, view, node_labels)
        finally:
            rec.add_span("host_wave", t0, rec.now(), cat="host",
                         pod=pod.uid, backend="golden")

    def _host_path_inner(self, pod: api.Pod, view, node_labels) -> int:
        feasible: List[str] = []
        reasons: Dict[str, int] = {}
        failed: Dict[str, List[str]] = {}
        for name, ni in self.cache.node_infos.items():
            ok, rs = golden.pod_fits_on_node(pod, ni, view=view)
            if ok:
                for fn in self.profile.host_filters.values():
                    if (getattr(fn, "relevant", None) is not None
                            and not fn.relevant(pod)):
                        continue
                    ok2, rs2 = fn(pod, ni)
                    if not ok2:
                        ok, rs = False, rs2
                        break
            if ok:
                feasible.append(name)
            else:
                for r in rs[:1]:
                    reasons[r] = reasons.get(r, 0) + 1
                failed[name] = rs[:1]
        try:
            # each filter extender over the nodes still feasible, the
            # labels of those nodes only for a legacy one; its failure
            # reasons count into the FitError, its nodes fail as
            # ExtenderFilter (kubernetes_tpu/sched/scheduler.py:3453-3474)
            for ext in self.profile.extenders:
                if ext.filter_verb and feasible:
                    labels_arg = None if ext.node_cache_capable else {
                        n: node_labels[n] for n in feasible
                        if n in node_labels}
                    feasible, ext_failed = ext.filter(
                        pod, feasible, node_labels=labels_arg)
                    for n, r in ext_failed.items():
                        reasons[r] = reasons.get(r, 0) + 1
                        failed[n] = ["ExtenderFilter"]
        except ExtenderError:
            self._extender_failed([pod])
            return 0
        if not feasible:
            self.metrics.pods_failed.inc()
            err = FitError(pod.full_name(), len(self.cache.node_infos),
                           reasons)
            self._count_unschedulable(err)
            if not self.disable_preemption:
                # reason strings back to predicate names for the
                # unresolvable filter
                fp = {n: [REASON_KEYS.get(r, r) for r in rs]
                      for n, rs in failed.items()}
                pr = preempt(pod, self.cache, fp, self._pdbs(),
                             with_affinity=True,
                             extenders=self.profile.extenders,
                             extra_fit=self._host_extra_fit,
                             gang_guard=self._gang_guard(),
                             snapshot=self.snapshot,
                             featurizer=self.featurizer)
                if pr is not None:
                    self._perform_preemption(pod, pr)
            self._park_with_backoff(pod)
            self.store.set_pod_condition(
                pod, ("PodScheduled", "False:" + err.message()))
            return 0
        # score: the golden interpod priority at the LIVE vector's interpod
        # weight (a hot-swapped profile reaches these pods too), plus
        # least-requested and balanced allocation at weight 1 and the
        # profile's weighted host scores; the first best node wins
        w_interpod = float(self.weightbook.live_vector()[W_INTERPOD])
        ipa_scores = golden.interpod_affinity_priority(
            pod, [self.cache.node_infos[n] for n in feasible], view,
            hard_weight=int(self.profile.weights().hard_pod_affinity))
        host_scores: Dict[str, float] = {}
        for fn, weight in self.profile.host_scores.values():
            for node, s in fn(pod, self.cache.node_infos).items():
                host_scores[node] = host_scores.get(node, 0.0) + weight * s
        try:
            # the extenders' priorities over the feasible nodes
            # (kubernetes_tpu/sched/scheduler.py:3513-3520)
            for ext in self.profile.extenders:
                for node, s in ext.prioritize(pod, feasible).items():
                    host_scores[node] = host_scores.get(node, 0.0) + s
        except ExtenderError:
            self._extender_failed([pod])
            return 0
        best_name, best_score = None, None
        for name in feasible:
            ni = self.cache.node_infos[name]
            s = (w_interpod * ipa_scores.get(name, 0)
                 + golden.least_requested_map(pod, ni)
                 + golden.balanced_allocation_map(pod, ni)
                 + host_scores.get(name, 0.0))
            if best_score is None or s > best_score:
                best_name, best_score = name, s
        if best_name is not None and self._commit(pod, best_name):
            return 1
        self.queue.add_if_not_present(pod)
        return 0

    def _host_extra_fit(self, pod: api.Pod, ni) -> bool:
        """The profile's host filters as one fit check for preemption's
        what-if (kubernetes_tpu/sched/scheduler.py:4705: victim removal
        can resolve NoDiskConflict and the volume counts, so the
        simulation re-runs them)."""
        for fn in self.profile.host_filters.values():
            if getattr(fn, "relevant", None) is not None and not fn.relevant(pod):
                continue
            ok, _ = fn(pod, ni)
            if not ok:
                return False
        return True

    # -- host plugins (kubernetes_tpu/sched/scheduler.py:4646) -------------------

    def _host_plugin_mask(self, pods: List[api.Pod], P: int) -> np.ndarray:
        """bool [P, caps.N]: the profile's host filters for each pod on
        each node, a filter run only for the pods its `relevant(pod)`
        gate admits, each (pod, node) stopping at its first failure.
        Records that failure's predicate key per (pod index, node name)
        in `_wave_host_fails` for FitError and the preemption
        unresolvable filter. With the equivalence cache on, a (class,
        node, filter) result is looked up before it is computed and
        stored after. Then each filter extender, one POST a pod, over
        every node of the snapshot in its order, with the labels of every
        cached node for a legacy one: a node still admitted that it drops
        fails as ExtenderFilter (kubernetes_tpu/sched/scheduler.py:
        4686-4701)."""
        N = self.snapshot.caps.N
        mask = np.ones((P, N), bool)
        self._wave_host_fails = {}
        if not self.profile.host_filters and not self.profile.extenders:
            return mask
        for i, pod in enumerate(pods):
            fails: Dict[str, str] = {}
            fns = [(pname, fn)
                   for pname, fn in self.profile.host_filters.items()
                   if getattr(fn, "relevant", None) is None
                   or fn.relevant(pod)]
            eclass = (equivalence_class(pod) if self.ecache is not None
                      else None)
            if fns:
                for name, ni_idx in self.snapshot.node_index.items():
                    ni = self.cache.node_infos.get(name)
                    if ni is None:
                        continue
                    for pname, fn in fns:
                        cached = (self.ecache.lookup(eclass, name, pname)
                                  if self.ecache is not None else None)
                        if cached is not None:
                            ok, rs = cached
                        else:
                            ok, rs = fn(pod, ni)
                            if self.ecache is not None:
                                self.ecache.update(eclass, name, pname, ok,
                                                   rs)
                        if not ok:
                            mask[i, ni_idx] = False
                            fails[name] = (REASON_KEYS.get(rs[0], pname)
                                           if rs else pname)
                            break
            for ext in self.profile.extenders:
                if not ext.filter_verb:
                    continue
                # the labels map is built again a pod, as JAX builds it
                feasible, _failed = ext.filter(
                    pod, list(self.snapshot.node_index),
                    node_labels=None if ext.node_cache_capable else {
                        n: (ni.node.metadata.labels or {})
                        for n, ni in self.cache.node_infos.items()
                        if ni.node is not None})
                keep = {self.snapshot.node_index[n] for n in feasible
                        if n in self.snapshot.node_index}
                for name, ni_idx in self.snapshot.node_index.items():
                    if ni_idx not in keep and mask[i, ni_idx]:
                        mask[i, ni_idx] = False
                        fails[name] = "ExtenderFilter"
            if fails:
                self._wave_host_fails[i] = fails
        return mask

    def _host_score_matrix(self, pods: List[api.Pod],
                           P: int) -> Optional[np.ndarray]:
        """f32 [P, caps.N]: the profile's host scores, each weighted and
        added in the order of `host_scores`, then each extender's
        prioritize over every node of the snapshot (one POST a pod and
        extender, its scores already weighted), added in profile order;
        None when there is neither (the kernel's extra_scores input,
        kubernetes_tpu/sched/scheduler.py:4717-4739)."""
        if not self.profile.host_scores and not any(
                ext.prioritize_verb for ext in self.profile.extenders):
            return None
        out = np.zeros((P, self.snapshot.caps.N), np.float32)
        idx = self.snapshot.node_index
        for i, pod in enumerate(pods):
            for fn, weight in self.profile.host_scores.values():
                for node, s in fn(pod, self.cache.node_infos).items():
                    j = idx.get(node)
                    if j is not None:
                        out[i, j] += weight * s
            for ext in self.profile.extenders:
                for node, s in ext.prioritize(pod, list(idx)).items():
                    j = idx.get(node)
                    if j is not None:
                        out[i, j] += s
        return out

    # -- gangs (kubernetes_tpu/sched/scheduler.py:3537) ---------------------------

    def _schedule_gangs(self, pods: List[api.Pod]) -> int:
        """All-or-nothing placement of the gang pods, grouped by PodGroup
        and committed one group at a time, so the second gang's dispatch
        sees the first gang's assumed usage: two gangs contending for the
        same nodes never interleave partial placements."""
        groups: Dict[str, List[api.Pod]] = {}
        for p in pods:
            groups.setdefault(self.gangs.key(p), []).append(p)
        placed = 0
        for key, members in groups.items():
            placed += self._schedule_one_gang(key, members)
        return placed

    def _schedule_one_gang(self, key: str, members: List[api.Pod]) -> int:
        """One gang's dispatch, traced as a round of kind "gang"
        (kubernetes_tpu/sched/scheduler.py:3552-3570)."""
        self.metrics.gang_schedule_attempts.inc()
        self.metrics.schedule_attempts.inc(len(members))
        rec = tracing.active()
        rt = None
        if rec is not None:
            rt = rec.begin_round("gang", pending=len(members), gang=key,
                                 weights_version=self.weightbook
                                 .live_version())
            self._trace_queue_waits(rt, members)
        try:
            return self._schedule_one_gang_inner(key, members, rt)
        finally:
            if rt is not None and rt.t1 is None:
                rec.end_round(rt, snapshot=self._round_snapshot_shape(),
                              breaker=self.breaker.state)

    def _schedule_one_gang_inner(self, key: str, members: List[api.Pod],
                                 rt=None) -> int:
        # per-gang admission: an earlier gang of this batch may have been
        # abandoned by the watchdog
        if not self._device_admitted():
            return self._schedule_degraded_gang(key, members, rt)
        min_member = self.gangs.min_member(members[0])
        bound = self.gangs.bound_count(self.cache, key,
                                       exclude={p.uid for p in members})
        # members already holding capacity count toward minMember: the
        # dispatch only needs to place the remainder
        need = max(min_member - bound, 0)
        # multi-topology-key required affinity can't be device-encoded;
        # such members take the exact host path one at a time: atomicity
        # is not offered for this combination
        host_path = [p for p in members if self.featurizer.needs_host_path(p)]
        members = [p for p in members
                   if not self.featurizer.needs_host_path(p)]
        placed = self._schedule_host_batch(host_path)
        if not members:
            return placed
        try:
            pb = self.featurizer.featurize(members)
        except PodFeaturizeError as e:
            # gang-atomic conviction: one poisoned member quarantines the
            # whole group
            self._gang_input_fault(members, e, rt)
            return placed
        P = pb.req.shape[0]
        try:
            extra = self._host_plugin_mask(members, P)
            extra_scores = self._host_score_matrix(members, P)
        except ExtenderError:
            # kubernetes_tpu/sched/scheduler.py:3612-3621
            self._extender_failed(members, rt)
            return placed
        if rt is not None:
            rt.mark("featurize", pods=len(members))
        try:
            # the chaos seam while pb is still the host batch
            self._wave_poison_seam(members, pb)
        except Exception as e:
            verdict = self._input_fault_verdict(members, e)
            if verdict is None:
                for p in members:
                    self._park_with_backoff(p)
                if rt is not None:
                    rt.ledger["outcome"] = "device_failure"
                return placed
            self._gang_input_fault(members, verdict, rt)
            return placed
        dev = self.device
        nt, pm, tt = self.snapshot.to_device(dev)
        if rt is not None:
            rt.mark("upload", cat="device")
        if self._rr is None:
            # re-seed from the host mirror (a twin pass dropped _rr)
            self._rr = torch.tensor(self._host_rr, dtype=torch.int32,
                                    device=dev)
        has_ipa = bool(self.snapshot.has_affinity_terms or pb.ra_has.any()
                       or pb.rn_has.any() or (pb.pa_w != 0).any())
        gating, wvec, _wver = self._weights_kw()
        launches0 = taint_ports_masks.launches
        try:
            pbt = enc.to_torch(None, None, None, pb, dev)[3]
            # the host inputs go up in one copy each
            extra_t = torch.from_numpy(extra).to(dev)
            scores_t = (torch.from_numpy(extra_scores).to(dev)
                        if extra_scores is not None else None)
            res = schedule_gang(
                nt, pm, tt, pbt, extra_t, self._rr, scores_t,
                torch.tensor(need, dtype=torch.int32, device=dev),
                weights=gating, num_zones=self.snapshot.caps.Z,
                num_label_values=self.snapshot.num_label_values,
                has_ipa=has_ipa,
                weight_vec=enc.weight_vec_to_torch(wvec, dev),
                ts_valid_host=pb.ts_valid)
            # the dispatch's one fetch: chosen, ok, placed and finite
            # together; the card's faults surface here, inside the try
            head = torch.cat([res.chosen, res.ok.to(torch.int32).reshape(1),
                              res.placed.reshape(1),
                              res.finite.to(torch.int32)]).cpu().numpy()
        except Exception as e:
            if isinstance(e, KernelBuildError):
                # not a device fault (see _run_pipeline)
                for p in members:
                    self.queue.add_if_not_present(p)
                if rt is not None:
                    rt.ledger.update(outcome="error",
                                     error=type(e).__name__)
                raise
            if is_capacity_error(e):
                # capacity-fault attribution first: compact and salvage
                # the gang through the twin's all-or-nothing plane —
                # never a device failure or a gang conviction for the
                # scheduler's own footprint
                self._capacity_strikes += 1
                self.metrics.capacity_faults.inc()
                self._compact_guarded(trigger="oom")
                if rt is not None:
                    rt.ledger.update(outcome="capacity_fault",
                                     error=type(e).__name__,
                                     memory=self._memory_ledger())
                return placed + self._schedule_degraded_gang(key, members,
                                                             rt)
            # input-fault attribution first: a poisoned member quarantines
            # its gang, never feeds the breaker
            verdict = self._input_fault_verdict(members, e)
            if verdict is not None:
                self._gang_input_fault(members, verdict, rt)
                return placed
            self._device_failure(e)
            if rt is not None:
                rt.ledger.update(outcome="device_failure",
                                 error=type(e).__name__)
            if isinstance(e, DispatchTimeout):
                # a wedged dispatch: salvage the gang through the twin's
                # all-or-nothing plane now (the breaker just opened)
                return placed + self._schedule_degraded_gang(key, members,
                                                             rt)
            # park the gang for retry (nothing placed: atomicity holds)
            for p in members:
                self._park_with_backoff(p)
            return placed
        self.breaker.record_success()
        self._capacity_strikes = 0
        G = res.chosen.shape[0]
        chosen, ok, n_placed = head[:G], bool(head[G]), int(head[G + 1])
        fin = head[G + 2:] != 0
        self._note_path(launches0)
        self.metrics.waves_total.labels(path="device").inc()
        if rt is not None:
            rt.mark("device_wave", cat="device", path=self.wave_path())
        # counted as the JAX scheduler counts its fetch of chosen (i32)
        # and finite (bool)
        self.metrics.device_fetch_bytes.inc(G * (4 + 1))
        # numeric-integrity sentinel: a poisoned member discards the
        # whole gang's placements and convicts the group atomically
        bad = [members[i].uid for i in range(len(members)) if not fin[i]]
        if bad:
            self._gang_input_fault(
                members, PoisonError("numeric-integrity sentinel", uids=bad),
                rt)
            return placed
        if not ok:
            if rt is not None:
                rt.ledger.update(outcome="gang_unplaceable",
                                 path=self.wave_path())
            self._fail_gang(key, members, need, res.masks, n_placed)
            return placed
        self._rr = res.rr_end
        self._host_rr += int(np.sum(chosen >= 0))  # the mirror
        pairs: List = []
        leftover: List = []
        for i, pod in enumerate(members):
            n = int(chosen[i])
            if n >= 0:
                pairs.append((pod, self.snapshot.node_names[n]))
            else:
                leftover.append((i, pod))
        if not self._commit_gang(pairs):
            # the exact int64 recheck lost a race with the device's f32
            # arithmetic: retry the whole gang, not unschedulable
            for pod in members:
                self.queue.add_if_not_present(pod)
            if rt is not None:
                rt.ledger["outcome"] = "recheck_race"
            return placed
        self.backoff.clear("gang:" + key)
        if rt is not None:
            rt.mark("commit", placed=len(pairs))
            rt.ledger.update(outcome="ok", placed=len(pairs),
                             path=self.wave_path())
        # surplus members beyond minMember that didn't fit park
        # individually with normal per-pod attribution
        if leftover:
            fail_counts = res.fail_counts.cpu().numpy()
            masks = res.masks.cpu().numpy()
            for i, pod in leftover:
                self._handle_failure(pod, i, fail_counts, masks)
        return placed + len(pairs)

    def _fail_gang(self, key: str, members: List[api.Pod], need: int,
                   masks, n_placed: int) -> None:
        """minMember pods can't hold capacity together: no member commits
        (the device already discarded the placements), every member parks
        with ONE shared backoff deadline, and gang-aware preemption runs
        so a higher-priority gang can evict its way in."""
        n_nodes = int(np.sum(self.snapshot.valid))
        short = max(need - n_placed, 1)
        tracing.event("gang_failed", gang=key, need=need, short=short)
        err = FitError(key, n_nodes, {REASONS["Gang"]: short})
        # park FIRST: the preemption below emits store events (nominated-
        # node writes, victim deletes) whose queue.update would re-add a
        # not-yet-parked member to the ACTIVE heap — the gang would then
        # retry as shrinking subsets instead of waiting out its backoff
        until = self.clock() + self.backoff.bump("gang:" + key)
        for pod in members:
            self.metrics.pods_failed.inc()
            self.queue.set_backoff(pod.uid, until)
            self.queue.add_unschedulable_if_not_present(pod)
            self.store.set_pod_condition(
                pod, ("PodScheduled", "False:" + err.message()))
        if self.disable_preemption:
            return
        t0 = self.clock()
        guard = self._gang_guard()
        # the member mask stack [Q, G, N]: a device tensor, or the twin's
        # numpy planes
        masks = (masks.cpu().numpy() if isinstance(masks, torch.Tensor)
                 else np.asarray(masks))
        # claimed: nodes earlier members already nominated — each member
        # must free a DIFFERENT node or the gang re-fails with one slot
        # freed
        claimed: set = set()
        for i, pod in enumerate(members):
            self.metrics.total_preemption_attempts.inc()
            fp = {n: preds for n, preds in
                  self._failed_predicates_by_node(masks, i).items()
                  if n not in claimed}
            pr = preempt(pod, self.cache, fp, self._pdbs(),
                         with_affinity=self.snapshot.has_affinity_terms
                         or _pod_has_ipa_terms(pod),
                         extenders=self.profile.extenders,
                         extra_fit=self._host_extra_fit,
                         gang_guard=guard, snapshot=self.snapshot,
                         featurizer=self.featurizer)
            if pr is not None:
                claimed.add(pr.node_name)
                self._perform_preemption(pod, pr)
        self.metrics.preemption_evaluation.observe(self.clock() - t0)

    def _commit_gang(self, pairs) -> bool:
        """Group-wide exact commit: EVERY member passes the int64 recheck
        and assumes before any bind; one failure rolls the entire group
        back, so a partially-bound gang never reaches the store."""
        assumed: List = []  # (pod, bound, node_name, vol_rollback)
        ok = True
        for pod, node_name in pairs:
            ni = self.cache.node_infos.get(node_name)
            if ni is None or not ni.fits_exactly(pod):
                ok = False
                break
            got, vol_rollback = self._bind_volumes(pod, ni)
            if not got:
                ok = False
                break
            assumed.append((pod, self._assume(pod, node_name), node_name,
                            vol_rollback))
        if not ok:
            if not self._gang_rollback_enabled:
                # test hook (see __init__): leave the partial commit in
                # place — the invariant checker must catch the orphaned
                # assumed members (conservation) and the split gang
                # (gang_atomic)
                return False
            for pod, bound, node_name, vol_rollback in reversed(assumed):
                self._forget(bound, node_name)
                if vol_rollback is not None:
                    vol_rollback()
            return False
        for pod, bound, node_name, vol_rollback in assumed:
            self._dispatch_bind(pod, bound, node_name, vol_rollback)
        return True

    def _gang_state(self):
        """(GangGuard, placed-members map, minMember map) from ONE cache
        scan, or (None, {}, {}) when the cluster has never seen a gang
        pod."""
        if not self.gangs.active:
            return None, {}, {}
        placed = self.gangs.placed_by_gang(self.cache)
        if not placed:
            return None, {}, {}
        mins = {key: self.gangs.min_member_by_key(key, sample=members[0])
                for key, members in placed.items()}
        slack = {key: max(len(members) - mins[key], 0)
                 for key, members in placed.items()}
        return GangGuard(self.gangs.key, slack), placed, mins

    def _gang_guard(self) -> Optional[GangGuard]:
        return self._gang_state()[0]

    # -- failure attribution (kubernetes_tpu/sched/scheduler.py:4484) ------------

    def _fit_error(self, pod: api.Pod, idx: int, fail_counts,
                   masks) -> FitError:
        """fail_counts [Q, P] and masks [Q, P, N], fetched. A node whose
        first failure is the host stack counts under the host filter that
        rejected it (`_wave_host_fails`)."""
        reasons: Dict[str, int] = {}
        for q, name in enumerate(enc.MASK_STACK_NAMES):
            c = int(fail_counts[q, idx])
            if not c:
                continue
            if name == "PodFitsResources":
                reasons[insufficient_resource_reason("resources")] = c
            elif name == "HostPlugins":
                fails = self._wave_host_fails.get(idx, {})
                if fails:
                    col = masks[:, idx, :]  # [Q, N]
                    valid = self.snapshot.valid
                    for n, nname in enumerate(self.snapshot.node_names):
                        if (n < col.shape[1] and valid[n] and not col[q, n]
                                and col[:q, n].all()):
                            key = fails.get(nname, "NoDiskConflict")
                            r = REASONS.get(key, key)
                            reasons[r] = reasons.get(r, 0) + 1
                else:
                    reasons[REASONS["NoDiskConflict"]] = c
            elif name == "CheckNodeCondition":
                reasons[REASONS["NodeNotReady"]] = c
            elif name == "CheckNodeUnschedulable":
                reasons[REASONS["NodeUnschedulable"]] = c
            elif name == "CheckNodeMemoryPressure":
                reasons[REASONS["NodeUnderMemoryPressure"]] = c
            elif name == "CheckNodeDiskPressure":
                reasons[REASONS["NodeUnderDiskPressure"]] = c
            elif name == "CheckNodePIDPressure":
                reasons[REASONS["NodeUnderPIDPressure"]] = c
            else:
                reasons[REASONS.get(name, name)] = c
        return FitError(pod.full_name(), int(np.sum(self.snapshot.valid)),
                        reasons)

    def _failed_predicates_by_node(self, masks,
                                   idx: int) -> Dict[str, List[str]]:
        """First-failing predicate per node for one failed pod, from the
        fetched mask stack [Q, P, N] (short-circuit attribution)."""
        col = masks[:, idx, :]  # [Q, N]
        out: Dict[str, List[str]] = {}
        valid = self.snapshot.valid
        host_fails = self._wave_host_fails.get(idx, {})
        for n, name in enumerate(self.snapshot.node_names):
            if n < col.shape[1] and valid[n]:
                fails = np.flatnonzero(~col[:, n])
                if fails.size:
                    pred = enc.MASK_STACK_NAMES[fails[0]]
                    if pred == "HostPlugins":
                        out[name] = [host_fails.get(name, "NoDiskConflict")]
                        continue
                    if pred == "CheckNodeCondition":
                        # distinguish sub-reasons host-side for the
                        # unresolvable filter
                        ni = self.cache.node_infos.get(name)
                        if ni is not None and ni.node is not None:
                            _, rs = golden.check_node_condition(None, ni)
                            out[name] = ["NodeNotReady" if r == REASONS["NodeNotReady"]
                                         else "NodeNetworkUnavailable" if r == REASONS["NodeNetworkUnavailable"]
                                         else "NodeUnschedulable" if r == REASONS["NodeUnschedulable"]
                                         else "NodeOutOfDisk" for r in rs] or ["NodeNotReady"]
                            continue
                    out[name] = [pred]
        return out

    def _handle_failure(self, pod: api.Pod, idx: int, fail_counts, masks):
        """fail_counts [Q, P] and masks [Q, P, N]: the wave's, fetched."""
        self.metrics.pods_failed.inc()
        err = self._fit_error(pod, idx, fail_counts, masks)
        self._count_unschedulable(err)
        if not self.disable_preemption:
            t0 = self.clock()
            self.metrics.total_preemption_attempts.inc()
            aff = pod.spec.affinity
            pod_has_ipa = aff is not None and (
                aff.pod_affinity is not None
                or aff.pod_anti_affinity is not None)
            pr = preempt(pod, self.cache,
                         self._failed_predicates_by_node(masks, idx),
                         self._pdbs(),
                         with_affinity=(self.snapshot.has_affinity_terms
                                        or pod_has_ipa),
                         extenders=self.profile.extenders,
                         extra_fit=self._host_extra_fit,
                         gang_guard=self._gang_guard(),
                         snapshot=self.snapshot, featurizer=self.featurizer)
            self.metrics.preemption_evaluation.observe(self.clock() - t0)
            if pr is not None and pr.victims:
                self._perform_preemption(pod, pr)
            # a zero-victim candidate means the what-if thinks the pod
            # fits as-is: don't nominate, just park and retry
        self._park_with_backoff(pod)
        self.store.set_pod_condition(
            pod, ("PodScheduled", "False:" + err.message()))

    def _extender_failed(self, pods: List[api.Pod], rt=None,
                         rec=None) -> None:
        """A non-ignorable extender failed: only this attempt fails. One
        scheduling_errors{stage="extender"} and every pod parked with
        backoff (reference scheduleOne records the error,
        MakeDefaultErrorFunc requeues). With `rt`, the round's outcome is
        "extender_error": ended here through `rec`, or left in the ledger
        for the caller that ends it (a gang's round)."""
        self.metrics.scheduling_errors.labels(stage="extender").inc()
        for p in pods:
            self._park_with_backoff(p)
        if rt is None:
            return
        if rec is not None:
            rec.end_round(rt, outcome="extender_error")
        else:
            rt.ledger["outcome"] = "extender_error"

    def _park_with_backoff(self, pod: api.Pod):
        """Failure-path requeue: the pod's next backoff duration, then a
        park as unschedulable; the queue keeps it out of the active heap
        until the deadline even if cluster events move it (reference:
        util/backoff_utils.go:97-112)."""
        d = self.backoff.bump(pod.uid)
        self.queue.set_backoff(pod.uid, self.clock() + d)
        self.queue.add_unschedulable_if_not_present(pod)

    def _pdbs(self) -> List[api.PodDisruptionBudget]:
        return list(self.store.list("poddisruptionbudgets"))

    def _perform_preemption(self, pod: api.Pod, pr):
        """Reference: scheduler.go:233-256 — nominate, evict victims, clear
        lower nominations. When the evictions drop a victim gang below
        its minMember, the gang's REMAINING members are evicted too
        (cluster-wide): a sub-minMember gang holds capacity while doing
        no useful work."""
        tracing.event("preemption", pod=pod.uid, node=pr.node_name,
                      victims=len(pr.victims),
                      pdb_violations=pr.num_pdb_violations)
        pod.status.nominated_node_name = pr.node_name
        self.store.set_nominated_node(pod, pr.node_name)
        self.queue.update_nominated_pod(pod, pr.node_name)
        # dict-as-ordered-set: the broken-gang teardown below deletes
        # pods in this order, which must follow victim order
        victim_gangs: Dict[str, None] = {}
        for victim in pr.victims:
            if self.gangs.active:
                k = self.gangs.key(victim)
                if k is not None:
                    victim_gangs[k] = None
            self.metrics.pod_preemption_victims.inc()
            try:
                self.store.delete("pods", victim.namespace,
                                  victim.metadata.name)
            except KeyError:
                pass
        victim_uids = {v.uid for v in pr.victims}
        for gkey in victim_gangs:
            remaining = [p for p in self.gangs.placed_members(self.cache,
                                                              gkey)
                         if p.uid not in victim_uids]
            if not remaining:
                continue
            m = self.gangs.min_member_by_key(gkey, sample=remaining[0])
            if len(remaining) >= m:
                continue
            for p in remaining:
                self.metrics.pod_preemption_victims.inc()
                try:
                    self.store.delete("pods", p.namespace, p.metadata.name)
                except KeyError:
                    pass
        for lower in get_lower_priority_nominated_pods(pod, pr.node_name,
                                                       self.queue):
            lower.status.nominated_node_name = ""
            self.queue.update_nominated_pod(lower, "")

    # -- commit ------------------------------------------------------------------

    def _assume(self, pod: api.Pod, node_name: str) -> api.Pod:
        bound = api.with_node_name(pod, node_name)
        self.cache.assume_pod(bound)
        self.snapshot.refresh_node_resources(self.cache.node_infos[node_name])
        self.snapshot.add_pod(bound)
        return bound

    def _forget(self, bound: api.Pod, node_name: str) -> None:
        if self.cache.is_assumed(bound):
            self.cache.forget_pod(bound)
        ni = self.cache.node_infos.get(node_name)
        if ni is not None:
            self.snapshot.refresh_node_resources(ni)
        self.snapshot.remove_pod(bound)

    def _bind_volumes(self, pod: api.Pod, ni):
        """With the VolumeScheduling gate on, bind the pod's unbound
        claims to PVs that admit the node (kubernetes_tpu/sched/
        scheduler.py:3851-3859): (ok, rollback or None)."""
        if (self.features.enabled("VolumeScheduling")
                and self.volume_binder.pod_has_claims(pod)):
            return self.volume_binder.bind_pod_volumes(pod, ni.node)
        return True, None

    def _bind_attempt(self, pod: api.Pod, node_name: str):
        """One bind POST as a closure (kubernetes_tpu/sched/scheduler.py:
        3964-3989), shared by the live bind and the spool drain, so both
        go through the same fault seams and the same extender routing:
        the first extender with a bind verb binds, then the store is
        updated, inside the reconciler's attempt (a failed extender bind
        is retried and counted by the store breaker like a failed
        POST)."""

        def _attempt():
            # chaos seam: a raise exercises the retries, then the
            # resolution against the store's copy
            faultpoints.fire("bind.post", payload=pod)
            # the store-path outage seam, once an attempt
            if faultpoints.fire("store.outage", payload=("bind", pod.uid)):
                raise ConnectionError("store.outage: bind request dropped")
            # reference scheduler.go:409 GetBinder: an extender with a
            # bind verb performs the binding; the store is then updated
            # so the informers see the placement either way
            binder = next((e for e in self.profile.extenders if e.bind_verb),
                          None)
            if binder is not None:
                binder.bind(pod, node_name)
            self.store.bind(pod, node_name)

        return _attempt

    def _bind_and_finish(self, pod: api.Pod, bound: api.Pod,
                         node_name: str, vol_rollback=None) -> bool:
        """The bind POST through the reconciler, and its outcome
        (kubernetes_tpu/sched/scheduler.py:3991-4031). While the store
        breaker is dark no POST is attempted: the intent spools at once.
        A bind whose retries and truth GET both failed — the reconciler's
        (ORPHANED, None) — spools too: that is a store outage, not a
        placement problem, and forgetting the pod would place it anew
        after the heal. Traced as a `bind` pod span, and a
        `bind_resolution` event for every outcome but BOUND."""
        t0 = self.clock()
        if not self.storehealth.allow():
            return self._spool_bind(pod, bound, node_name, vol_rollback)
        outcome, truth = self.reconciler.reconcile(
            pod, node_name, self._bind_attempt(pod, node_name))
        rec = tracing.active()
        if rec is not None:
            rec.pod_span(pod.uid, "bind", self.clock() - t0,
                         node=node_name, outcome=outcome)
            if outcome != BOUND:
                rec.event("bind_resolution", pod=pod.uid, outcome=outcome,
                          node=node_name)
        if outcome == ORPHANED and truth is None:
            return self._spool_bind(pod, bound, node_name, vol_rollback)
        return self._apply_bind_outcome(pod, bound, node_name, vol_rollback,
                                        outcome, truth, t0)

    def _apply_bind_outcome(self, pod: api.Pod, bound: api.Pod,
                            node_name: str, vol_rollback,
                            outcome: str, truth, t0: float) -> bool:
        """What one reconciled bind does to the cache and the queue
        (kubernetes_tpu/sched/scheduler.py:4031-4103), shared by the live
        bind and the spool drain:

          * CONFIRMED — the store shows the pod bound (our POST landed
            and its answer was lost, or another writer bound it first):
            the cache adopts that truth, the snapshot row moves to the
            node truth names, and the claims bound for our node are
            released if they cannot serve it; no requeue, no park;
          * ORPHANED — it is unbound: the assumption and the pod's claim
            bindings roll back and the pod parks with backoff;
          * GONE — it was deleted: the assumption rolls back.

        A bind that lands (or is confirmed) observes the pod's latency
        from its first enqueue (the queue's added_at, consumed only
        here, so a failed bind's requeue keeps the original time)."""
        if outcome == CONFIRMED:
            with self._mu:
                # add_pod confirms the assumption (and moves it if truth
                # names another node); a later duplicate confirmation
                # from the watch is a no-op
                self.cache.add_pod(truth)
                if truth.spec.node_name != node_name:
                    # the row written at assume time still charges our
                    # node
                    self.snapshot.remove_pod(bound)
                    ni = self.cache.node_infos.get(node_name)
                    if ni is not None:
                        self.snapshot.refresh_node_resources(ni)
                    nb = self.cache.node_infos.get(truth.spec.node_name)
                    if nb is not None:
                        self.snapshot.refresh_node_resources(nb)
                        self.snapshot.add_pod(truth)
                    if vol_rollback is not None and \
                            not self.volume_binder.volumes_admit_node(
                                pod, nb.node if nb is not None else None):
                        # the claims were bound for the node we assumed
                        vol_rollback()
        elif outcome in (ORPHANED, GONE):
            self.metrics.scheduling_errors.labels(stage="bind").inc()
            with self._mu:
                try:
                    self.cache.forget_pod(bound)
                except KeyError:
                    # the watch confirmed it meanwhile: the bind landed
                    return True
                ni = self.cache.node_infos.get(node_name)
                if ni is not None:
                    self.snapshot.refresh_node_resources(ni)
                self.snapshot.remove_pod(bound)
            if vol_rollback is not None:
                vol_rollback()
            if outcome == ORPHANED:
                # backoff-requeue: a bind that just failed repeatedly
                # should not re-enter the very next wave at full speed
                self._park_with_backoff(truth if truth is not None else pod)
            return False
        with self._mu:
            self.cache.finish_binding(bound)
        self.metrics.binding_latency.observe(self.clock() - t0)
        added = self.queue.added_at.pop(pod.uid, None)
        if added is not None:
            self.metrics.pod_scheduling_latency.observe(self.clock() - added)
        self.metrics.pods_scheduled.inc()
        self.backoff.clear(pod.uid)
        # a successful bind clears the poison ladder too: a recovered
        # spec starts fresh on any future conviction
        self.poison_backoff.clear(pod.uid)
        self.queue.clear_backoff(pod.uid)
        self.queue.update_nominated_pod(pod, "")
        return True

    def _commit(self, pod: api.Pod, node_name: str) -> bool:
        """Exact int64 re-verification, the pod's claims bound when the
        VolumeScheduling gate is on, then assume and bind (reference:
        scheduler.go:268 assumeAndBindVolumes, :486 assume -> :491
        bind). True: the pod is placed (bound, confirmed, or spooled
        while the store is dark)."""
        ni = self.cache.node_infos.get(node_name)
        if ni is None or not ni.fits_exactly(pod):
            return False
        got, vol_rollback = self._bind_volumes(pod, ni)
        if not got:
            return False
        return self._dispatch_bind(pod, self._assume(pod, node_name),
                                   node_name, vol_rollback)

    def _dispatch_bind(self, pod: api.Pod, bound: api.Pod, node_name: str,
                       vol_rollback=None) -> bool:
        """The bind of an assumed pod: inline without a bind pool, else
        submitted to the pool (kubernetes_tpu/sched/scheduler.py:
        3885-3943), where True means assumed with the bind dispatched — a
        bind that fails later forgets the assumption and parks the pod."""
        if self._bind_pool is None:
            return self._bind_and_finish(pod, bound, node_name, vol_rollback)
        fut = self._bind_pool.submit(self._bind_and_finish, pod, bound,
                                     node_name, vol_rollback)
        with self._inflight_mu:
            self._inflight.add(fut)
            self.bind_overlap_hwm = max(self.bind_overlap_hwm,
                                        len(self._inflight))
        fut.add_done_callback(self._bind_done)
        return True

    def _bind_done(self, fut) -> None:
        with self._inflight_mu:
            self._inflight.discard(fut)
        exc = fut.exception()
        if exc is not None:
            # nothing awaits these futures for a value: count the error
            # so it reaches /metrics, not only the log
            self.metrics.scheduling_errors.labels(stage="bind").inc()
            logging.getLogger(__name__).error(
                "bind worker raised", exc_info=exc)

    # -- the store plane: the bind spool and the durable intent journal
    # (kubernetes_tpu/sched/scheduler.py:4108-4293) ------------------------------

    def _spool_bind(self, pod: api.Pod, bound: api.Pod, node_name: str,
                    vol_rollback=None, seq: Optional[int] = None) -> bool:
        """Disconnected-mode bind: keep the assumption (capacity stays
        held, and no finish_binding: the assume TTL cannot expire it),
        append the intent to the journal, and park the POST in the spool
        in arrival order. Returns True — the pod IS placed; only the
        store write waits."""
        with self._mu:
            if pod.uid in self._spool_uids:
                return True
            if seq is None and self.journal is not None:
                try:
                    seq = self.journal.append_intent(bound, node_name)
                except Exception:
                    # a full disk or an IO fault: the intent still spools
                    # in memory (a crash now loses it)
                    logging.getLogger(__name__).exception(
                        "bind journal append failed; intent for %s/%s "
                        "spools in memory only", pod.namespace, pod.name)
            self._spool.append((pod, bound, node_name, vol_rollback, seq))
            self._spool_uids.add(pod.uid)
            depth = len(self._spool)
        self.metrics.binds_spooled.inc()
        rec = tracing.active()
        if rec is not None:
            rec.event("bind_spooled", pod=pod.uid, node=node_name,
                      seq=seq if seq is not None else -1, depth=depth)
        return True

    def _drain_spool(self) -> Dict[str, int]:
        """Replay the spooled intents head first (arrival order) through
        the reconciler. Stops at the first intent whose store path is
        still dark: it stays at the head for the next probe, and the
        breaker has re-tripped through the per-attempt callbacks. Every
        resolved intent leaves the spool and is marked resolved in the
        journal."""
        stats = {"bound": 0, "confirmed": 0, "orphaned": 0, "gone": 0}
        while True:
            with self._mu:
                if not self._spool:
                    break
                entry = self._spool[0]
            if not self._flush_intent(entry, stats):
                break
        self._spool_drain_due = False
        if any(stats.values()):
            logging.getLogger(__name__).info(
                "bind spool drained: %(bound)d bound, %(confirmed)d "
                "confirmed, %(orphaned)d orphaned+requeued, "
                "%(gone)d gone", stats)
        return stats

    def _flush_intent(self, entry, stats) -> bool:
        """POST one spooled intent and apply its outcome. False: the
        store is still dark (the entry stays spooled at the head)."""
        pod, bound, node_name, vol_rollback, seq = entry
        t0 = self.clock()
        outcome, truth = self.reconciler.reconcile(
            pod, node_name, self._bind_attempt(pod, node_name))
        if outcome == ORPHANED and truth is None:
            return False
        with self._mu:
            try:
                self._spool.remove(entry)
            except ValueError:
                pass
            self._spool_uids.discard(pod.uid)
        self._apply_bind_outcome(pod, bound, node_name, vol_rollback,
                                 outcome, truth, t0)
        if seq is not None and self.journal is not None:
            self.journal.resolve(
                seq, CONFIRMED if outcome in (BOUND, CONFIRMED) else outcome)
        stats[outcome if outcome != BOUND else "bound"] += 1
        rec = tracing.active()
        if rec is not None:
            rec.event("bind_despooled", pod=pod.uid, node=node_name,
                      outcome=outcome)
        return True

    def recover_from_journal(self) -> Dict[str, int]:
        """Crash-restart replay: re-own every unresolved intent of the
        journal before the first round. The store's copy decides each:
        bound -> adopt (the crash lost only the confirmation); still
        pending -> re-assume and re-spool under the same seq; deleted or
        recreated under a new uid -> resolved GONE; unreachable (the
        outage outlived the crash) -> re-assume from the local copy and
        re-spool for the post-heal drain. Runs at construction and in
        recover_leadership()."""
        stats = {"adopted": 0, "respooled": 0, "requeued": 0, "gone": 0,
                 "unreachable": 0}
        if self.journal is None or not self._journal_replay_enabled:
            return stats

        class _PodRef:
            # pod-shaped stub for the truth GET: namespace, name and uid
            # are all the journal recorded
            def __init__(self, ns, name, uid):
                self.namespace, self.name, self.uid = ns, name, uid
                self.metadata = type("M", (), {"name": name})()

        for it in self.journal.unresolved():
            uid, node, seq = it.get("uid"), it.get("node"), it.get("seq")
            ns, name = it.get("ns"), it.get("name")
            with self._mu:
                if uid in self._spool_uids:
                    continue  # the live spool owns it
            local = self.store.get("pods", ns, name)
            reachable = True
            try:
                truth = self._pod_truth(local if local is not None
                                        else _PodRef(ns, name, uid))
            except Exception:
                truth, reachable = None, False
            if not reachable:
                # re-own the intent from the local copy so capacity is
                # held; without one it stays unresolved for the next
                # replay
                if local is not None and self._respool_local(local, node,
                                                             seq):
                    stats["respooled"] += 1
                else:
                    stats["unreachable"] += 1
                continue
            if truth is None or truth.uid != uid:
                # deleted (or the name reused by a NEW pod) while down
                self.journal.resolve(seq, GONE)
                stats["gone"] += 1
            elif truth.spec.node_name:
                # the bind landed before the crash: adopt it and retire
                # the pod the backfill re-queued
                with self._mu:
                    self.cache.add_pod(truth)
                    self.queue.remove_if_pending(uid)
                    self.queue.assigned_pod_added(truth)
                self.journal.resolve(seq, CONFIRMED)
                stats["adopted"] += 1
            elif self._respool_local(truth, node, seq):
                # still pending: the intent never landed
                stats["respooled"] += 1
            else:
                # its node vanished while down: the pod stays queued and
                # schedules afresh
                self.journal.resolve(seq, ORPHANED)
                stats["requeued"] += 1
        if any(stats.values()):
            logging.getLogger(__name__).info(
                "bind-journal replay: %(adopted)d adopted, %(respooled)d "
                "re-spooled, %(requeued)d requeued fresh, %(gone)d gone, "
                "%(unreachable)d unreachable (kept for next replay)",
                stats)
            self.export_queue_gauges()
        return stats

    def _respool_local(self, pod: api.Pod, node_name: str,
                       seq: Optional[int]) -> bool:
        """Re-own one journaled intent: assume the pod onto its journaled
        node (if that node still exists) and re-spool it."""
        bound = api.with_node_name(pod, node_name)
        with self._mu:
            ni = self.cache.node_infos.get(node_name)
            if ni is None:
                return False
            try:
                self.cache.assume_pod(bound)
            except KeyError:
                pass  # already known: its capacity is already held
            else:
                self.snapshot.refresh_node_resources(
                    self.cache.node_infos[node_name])
                self.snapshot.add_pod(bound)
            self.queue.remove_if_pending(bound.uid)
        self._spool_bind(pod, bound, node_name, None, seq=seq)
        return True

    # per-attempt deadline on truth GETs: reconciliation runs on binder
    # threads and, for the recovery pass, before the rounds resume — a
    # hung round trip must fail fast, like the bind POST's own timeout
    TRUTH_GET_TIMEOUT = 5.0

    def _pod_truth(self, pod: api.Pod) -> Optional[api.Pod]:
        """One pod from the store's truth (kubernetes_tpu/sched/
        scheduler.py:4444-4480): None = deleted; raises when the store
        cannot be reached. With a RemoteStore the GET goes through its
        REST client: the store's own get() serves the reflector mirror,
        whose staleness is what bind reconciliation and the recovery pass
        must not trust. It is the store breaker's GET feed: a transport
        failure counts on store_errors{op="get"} and the
        consecutive-failure ladder; any answer, a 404 or 409 too, counts
        as the store being reachable. The `store.outage` point fires
        here, so chaos severs the truth path with the bind path."""
        try:
            if faultpoints.fire("store.outage", payload=("get", pod.uid)):
                raise ConnectionError("store.outage: truth GET dropped")
            client = getattr(self.store, "client", None)
            if client is not None:
                try:
                    truth = client.get("pods", pod.namespace,
                                       pod.metadata.name,
                                       timeout=self.TRUTH_GET_TIMEOUT)
                except APIStatusError as e:
                    self.storehealth.record_success()  # the store ANSWERED
                    if e.code == 404:
                        return None
                    raise
            else:
                truth = self.store.get("pods", pod.namespace, pod.name)
        except APIStatusError:
            raise  # an answer: counted as reachable above
        except Exception:
            self.metrics.store_errors.labels(op="get").inc()
            self.storehealth.record_failure()
            raise
        self.storehealth.record_success()
        return truth

    def wait_for_binds(self) -> None:
        """Drain every bind in flight on the pool (callers that need
        settled store state: the end of schedule_pending, dormancy,
        shutdown). Without a pool the binds ran inline and none is in
        flight."""
        while True:
            with self._inflight_mu:
                pending = list(self._inflight)
            if not pending:
                return
            concurrent.futures.wait(pending)

    def close(self) -> None:
        """Settle the binds in flight and release the bind pool's
        threads. The scheduler stays queryable but schedules no more; the
        spool and the journal are left as they are, for a later
        process's replay."""
        self.wait_for_binds()
        if self._bind_pool is not None:
            self._bind_pool.shutdown(wait=True)
            self._bind_pool = None

    # -- leadership (kubernetes_tpu/sched/scheduler.py:4335-4430) ----------------

    @property
    def dormant(self) -> bool:
        return self._dormant

    def enter_dormant(self) -> None:
        """Leadership lost: stop scheduling rounds and settle the binds;
        the watches keep the cache warm for recover_leadership().
        Idempotent; taking _mu orders dormancy after a round already
        running on another thread."""
        if self._dormant:
            return
        with self._mu:
            self._dormant = True
        self.wait_for_binds()
        logging.getLogger(__name__).info(
            "scheduler dormant: leadership lost; binds drained, %d assumed "
            "pods held for reconciliation, informers stay warm",
            len(self.cache.assumed_pods()))

    def recover_leadership(self) -> Dict[str, int]:
        """Leadership re-acquired after a dormant spell: settle every
        assumed pod against the store (adopt a confirmed binding, forget
        an orphan and release its capacity), replay the journal, rebuild
        the whole device mirror (nothing incremental is trusted across a
        leadership gap) and resume. The truth GETs run outside _mu, fanned
        over the bind pool when there is one (it is idle: the binds were
        just drained), so a wave of assumed pods resolves in about one
        round trip. Returns the tally."""
        self.wait_for_binds()
        stats = {"confirmed": 0, "orphaned": 0, "unresolved": 0}

        def _fetch(pod):
            try:
                return (pod, self._pod_truth(pod), True)
            except Exception as e:
                # unreachable for THIS pod: keep the assumption (holding
                # capacity briefly beats double-placing)
                logging.getLogger(__name__).warning(
                    "recovery: could not resolve assumed pod %s/%s "
                    "against API truth (%s: %s); keeping the assumption",
                    pod.namespace, pod.name, type(e).__name__, e)
                return (pod, None, False)

        assumed = self.cache.assumed_pods()
        if self._bind_pool is not None and len(assumed) > 1:
            resolved = list(self._bind_pool.map(_fetch, assumed))
        else:
            resolved = [_fetch(p) for p in assumed]
        with self._mu:
            for pod, truth, ok in resolved:
                if not self.cache.is_assumed(pod):
                    continue  # a watch event settled it meanwhile
                if not ok:
                    stats["unresolved"] += 1
                elif truth is not None and truth.spec.node_name:
                    self.cache.add_pod(truth)  # adopt the binding
                    self.queue.remove_if_pending(pod.uid)
                    self.queue.assigned_pod_added(truth)
                    stats["confirmed"] += 1
                else:
                    try:
                        self.cache.forget_pod(pod)
                    except KeyError:
                        pass
                    stats["orphaned"] += 1
                    if truth is not None:
                        # still pending in the store: schedule it afresh
                        self.queue.add_if_not_present(truth)
                    else:
                        self.queue.delete(pod)
            self.recover_from_journal()
            self.scrubber.rebuild()
            self._dormant = False
        # anything another leader failed to place may fit now
        self.queue.move_all_to_active()
        logging.getLogger(__name__).info(
            "scheduler resumed leadership: %(confirmed)d assumed pods "
            "confirmed, %(orphaned)d orphans forgotten+requeued, "
            "%(unresolved)d unresolved (TTL backstop)", stats)
        return stats
