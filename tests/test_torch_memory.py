"""The memory plane of kubernetes_tpu_torch's Scheduler against the JAX
Scheduler (tests/test_compaction.py's classes, the mesh case left out):
the device-memory budget governor, the vocabulary and row compaction of
state/scrubber.py with Snapshot._compact, and the capacity-fault ladder
(`device.oom`, a MemoryError at featurize). Each scenario runs in both
packages from the same store writes on the same virtual clock
(torch_parity.Both), and the bindings, vocabulary sizes, caps,
projected and resident bytes, budgets, headroom, the memory plane's
series, the fault state and the fault points' hit counts are compared
after every step (`check_memory`).

Also the what-if's capacity fault (ROADMAP queue 3): a `device.oom`
injected at a preemption chunk's what-if dispatch is charged to the
breaker and the chunk salvaged on the numpy twin, as the JAX scheduler's
_preempt_chunk does, instead of raising out of the drain.
"""

import pytest
import torch

from kubernetes_tpu.ops import preempt as jpreempt
from kubernetes_tpu.sched import breaker as jbreaker
from kubernetes_tpu.utils import faultpoints as jfp
from kubernetes_tpu_torch.sched import breaker as tbreaker
from kubernetes_tpu_torch.sched import scheduler as tsched
from kubernetes_tpu_torch.state.snapshot import SNAPSHOT_DIMS
from kubernetes_tpu_torch.utils import faultpoints as tfp

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both, arm, check_faults, disarm
from torch_worlds import bindings, plain_node, plain_pod

SIDES = ("jax", "torch")
MEMORY_POINTS = ("device.oom", "snapshot.compact")


def memory_state(sched) -> dict:
    """The memory plane of one scheduler: vocabulary sizes, the
    snapshot-owned caps, projected and resident bytes, the budget and its
    headroom, the governor's demand, the removals counter, upload bytes,
    the capacity strikes and the wave cap, and the plane's series."""
    snap, m = sched.snapshot, sched.metrics

    def fam(f):
        return {c.name: c.value for c in f.children()}

    return {
        "vocabs": dict(snap.vocabs.sizes()),
        "caps": {d: getattr(snap.caps, d) for d in SNAPSHOT_DIMS},
        "projected": snap.projected_hbm_bytes(),
        "resident": snap.hbm_bytes(),
        "budget": snap.hbm_budget_bytes,
        "headroom": snap.hbm_headroom_bytes(),
        "requested": snap.compaction_requested,
        "removals": snap.removals_since_compact,
        "uploaded": snap.upload_bytes_total,
        "strikes": sched._capacity_strikes,
        "wave_cap": sched._wave_cap,
        "capacity_faults": m.capacity_faults.value,
        "compactions": fam(m.snapshot_compactions_total),
        "effective_wave_size": m.effective_wave_size.value,
        "hbm_gauge": m.snapshot_hbm_bytes.value,
        "headroom_gauge": m.hbm_headroom_bytes.value,
        "vocab_gauge": fam(m.snapshot_vocab_size),
        "upload_counter": m.snapshot_upload_bytes.value,
        "scrubs": (m.snapshot_scrub_runs.value,
                   m.snapshot_scrub_divergences.value,
                   m.snapshot_scrub_repairs.value),
    }


def check_memory(b, points=MEMORY_POINTS):
    """Both schedulers of `b` in the same memory and fault state, the
    memory plane's fault points hit as often in both packages."""
    want, got = (memory_state(b.sched[s]) for s in SIDES)
    assert got == want
    check_faults(b, points)


def each(b, fn):
    """fn(side, scheduler) on both sides; the two results must be equal.
    Returns the port's."""
    out = {s: fn(s, b.sched[s]) for s in SIDES}
    assert out["torch"] == out["jax"], out
    return out["torch"]


def _world(n_nodes=8, wave=32, **kw):
    """tests/test_compaction.py's world: n_nodes 32-core nodes in three
    zones, the Caps defaults."""
    b = Both(0, wave=wave, caps=None, sched_kw=kw)
    for i in range(n_nodes):
        b.node(f"n{i}", cpu="32", memory="64Gi", zone=f"z{i % 3}")
    return b


def _pods(b, n, prefix="p", labels=None):
    for i in range(n):
        b.pod(f"{prefix}{i}", cpu="100m", memory="128Mi", labels=labels)


def _churn_generation(b, gen, n_nodes=4, n_pods=6):
    """One epoch of churn: every string is generation-fresh (hostnames,
    zone values, pod label values) — the vocabulary leak."""
    for side, store in b.stores.items():
        pkg = b.pkg(side)
        if gen:
            for p in store.list("pods"):
                if p.metadata.labels.get("rev") == f"r{gen - 1}":
                    store.delete("pods", "default", p.metadata.name)
            for i in range(n_nodes):
                store.delete("nodes", "default", f"g{gen - 1}-n{i}")
        for i in range(n_nodes):
            store.create("nodes", plain_node(
                pkg, f"g{gen}-n{i}", cpu="32", memory="64Gi",
                zone=f"zone-{gen}"))
        for i in range(n_pods):
            store.create("pods", plain_pod(
                pkg, f"g{gen}-p{i}", cpu="100m", memory="128Mi",
                labels={"rev": f"r{gen}", "app": f"app-{gen}"}))


def _housekeep(b):
    for s in SIDES:
        b.sched[s]._housekeep()


# -- the vocabulary leak and its plateau ----------------------------------------


GENS = 10


@pytest.mark.parametrize("interval", [0.0, 50.0])
def test_churned_vocabs_plateau_under_cadence(interval):
    """Generation churn: with the compaction cadence armed only the live
    generations' strings stay interned; without it every retired
    hostname, zone and label value is kept. Bindings, vocabulary sizes,
    caps and bytes equal JAX's after every generation."""
    b = Both(0, wave=16, caps=None, sched_kw=dict(compact_interval=interval))
    for gen in range(GENS):
        _churn_generation(b, gen)
        b.advance(60.0)
        _housekeep(b)
        b.run()
        check_memory(b)
    sizes = b.sched["torch"].snapshot.vocabs.sizes()
    if interval:
        assert sizes["zones"] <= 4, sizes
        assert b.sched["torch"].metrics.snapshot_compactions_total.value(
            trigger="cadence") >= GENS - 2
    else:
        assert sizes["zones"] >= GENS and sizes["label_values"] >= GENS


def test_removals_counter_gates_cadence():
    """The cadence only sweeps when churn retired rows: a static cluster
    pays nothing for an armed interval."""
    b = _world(compact_interval=10.0)
    _pods(b, 8)
    b.run()
    b.advance(1000.0)
    _housekeep(b)
    check_memory(b)
    assert b.sched["torch"].metrics.snapshot_compactions_total.total() == 0
    b.delete("p0")
    b.advance(20.0)
    _housekeep(b)
    check_memory(b)
    assert b.sched["torch"].metrics.snapshot_compactions_total.total() == 1


# -- compaction is invisible to placement ------------------------------------------


@pytest.mark.parametrize("compact_between", [False, True])
def test_placements_bit_equal_across_compaction(compact_between):
    """The same batch places identically with and without a forced sweep
    between the waves, in both packages (node NAMES: indices renumber)."""
    b = _world()
    _pods(b, 16, prefix="warm-")
    b.run()
    for i in range(8):
        b.delete(f"warm-{i}")
    _housekeep(b)
    if compact_between:
        summary = each(b, lambda s, sched: {
            k: v for k, v in sched.scrubber.compact(force=True).items()
            if k != "duration"})
        assert summary["trigger"] == "cadence" and summary["shrunk"] == {}
    check_memory(b)
    _pods(b, 12, prefix="batch-")
    b.run()
    check_memory(b)
    got = bindings(b.stores["torch"])
    assert sum(1 for v in got.values() if v) == 20
    # the placements of a run without the sweep, taken from a fresh pair
    other = _world()
    _pods(other, 16, prefix="warm-")
    other.run()
    for i in range(8):
        other.delete(f"warm-{i}")
    _housekeep(other)
    if not compact_between:
        for s in SIDES:
            other.sched[s].scrubber.compact(force=True)
    _pods(other, 12, prefix="batch-")
    other.run()
    assert bindings(other.stores["torch"]) == got


def test_version_bump_invalidates_featurizer_cache():
    """The vocabulary generation leads the version tuple: a compacted
    vocabulary never serves a featurize cache entry built against the
    old ids."""
    b = _world()
    v0 = each(b, lambda s, sched: sched.snapshot.vocabs.version())
    each(b, lambda s, sched: sched.scrubber.compact(force=True) is None)
    v1 = each(b, lambda s, sched: sched.snapshot.vocabs.version())
    assert v1 != v0 and v1[0] == v0[0] + 1
    check_memory(b)


def test_hysteresis_resists_bucket_thrash():
    """Un-forced sweeps shrink a bucket only when the target is a full
    power-of-two rung below the live one."""
    b = _world()
    _pods(b, 100)
    b.run()
    grown = b.sched["torch"].snapshot.caps.M
    assert grown > 64
    for i in range(10):
        b.delete(f"p{i}")
    _housekeep(b)
    each(b, lambda s, sched: sched.scrubber.compact()["shrunk"])
    check_memory(b)
    assert b.sched["torch"].snapshot.caps.M == grown
    for i in range(10, 90):
        b.delete(f"p{i}")
    _housekeep(b)
    shrunk = each(b, lambda s, sched: sched.scrubber.compact()["shrunk"])
    check_memory(b)
    assert shrunk["M"] == (grown, b.sched["torch"].snapshot.caps.M)
    assert b.sched["torch"].snapshot.caps.M < grown


def test_staged_rows_defer_compaction():
    """A round holds staged row indices: a sweep then would renumber them
    under it. The request parks and the next pass (rows unstaged) serves
    it."""
    b = _world()
    staged = {s: plain_pod(b.pkg(s), "staged", cpu="100m", memory="128Mi")
              for s in SIDES}
    each(b, lambda s, sched: sched.snapshot.stage_pending([staged[s]])[0]
         .tolist())
    assert each(b, lambda s, sched: sched.snapshot.has_staged_rows())
    assert each(b, lambda s, sched: sched.scrubber.compact(force=True)) \
        is None
    check_memory(b)
    each(b, lambda s, sched: sched.snapshot.unstage(staged[s]))
    assert each(b, lambda s, sched: sched.scrubber.maybe_compact()
                is not None)
    check_memory(b)
    assert not b.sched["torch"].snapshot.compaction_requested


# -- the budget governor ----------------------------------------------------------


def test_over_budget_grow_demands_compaction():
    """A grow past a budget set just above the footprint lands (never a
    throw) but demands a compaction, which the next housekeeping pass
    serves with trigger governor."""
    b = _world()
    _pods(b, 8)
    b.run()
    assert b.sched["torch"].snapshot.hbm_headroom_bytes() is None
    budget = each(b, lambda s, sched: sched.snapshot.projected_hbm_bytes()) + 1
    for s in SIDES:
        b.sched[s].snapshot.hbm_budget_bytes = budget
    assert b.sched["torch"].snapshot.hbm_headroom_bytes() == 1
    _pods(b, int(b.sched["torch"].snapshot.caps.M), prefix="burst-")
    b.run()
    check_memory(b)
    _housekeep(b)
    check_memory(b)
    assert b.sched["torch"].metrics.snapshot_compactions_total.value(
        trigger="governor") >= 1


def test_headroom_gauge_exported():
    b = _world(hbm_budget_bytes=1 << 30)
    b.run()
    for s in SIDES:
        b.sched[s].export_queue_gauges()
    check_memory(b)
    m = b.sched["torch"].metrics
    assert 0 < m.hbm_headroom_bytes.value <= 1 << 30
    assert m.snapshot_vocab_size.value(vocab="zones") >= 1


# -- golden rows and row deltas across a sweep -------------------------------------


def _settled():
    b = _world()
    _pods(b, 24)
    b.run()
    for i in range(12):
        b.delete(f"p{i}")
    _housekeep(b)
    return b


def test_scrub_finds_compacted_snapshot_clean():
    b = _settled()
    each(b, lambda s, sched: sched.scrubber.compact(force=True) is None)
    rep = each(b, lambda s, sched: (
        lambda r: (r.clean, r.repaired, r.nodes_checked, r.pods_checked))(
            sched.scrubber.scrub()))
    assert rep[:2] == (True, 0)
    check_memory(b)


def test_delta_uploads_reengage_after_compaction():
    """The first upload after a sweep is a full one; the next bind's rows
    ride the row-delta path again, the same bytes as JAX's, and the
    port's device tensors equal a fresh full upload."""
    b = _settled()
    t = b.sched["torch"].snapshot
    t.to_device("cpu")
    b.sched["jax"].snapshot.to_device()
    each(b, lambda s, sched: sched.scrubber.compact(force=True) is None)

    def upload(s, sched):
        snap = sched.snapshot
        before = snap.upload_bytes_total
        snap.to_device("cpu") if s == "torch" else snap.to_device()
        return snap.upload_bytes_total - before

    moved_full = each(b, upload)
    full = each(b, lambda s, sched: sum(sched.snapshot._group_bytes.values()))
    assert moved_full >= full > 0
    node = t.node_names[0]
    for s in SIDES:
        sched = b.sched[s]
        p = plain_pod(b.pkg(s), "delta-probe", cpu="100m", node_name=node)
        sched.cache.add_pod(p)
        sched.snapshot.refresh_node_resources(sched.cache.node_infos[node])
        sched.snapshot.add_pod(p)
    moved = each(b, upload)
    assert 0 < moved < full // 4, (moved, full)
    got = {g: [a.clone() for a in t._device_cache[g]]
           for g in ("res", "topo", "pods", "terms")}
    t.invalidate_device()
    t.to_device("cpu")
    for g, tensors in got.items():
        for a, want in zip(tensors, t._device_cache[g]):
            torch.testing.assert_close(a, want, rtol=0, atol=0,
                                       equal_nan=True, msg=g)


# -- the capacity classifier --------------------------------------------------------


def _wrapped():
    try:
        try:
            raise MemoryError("backend alloc")
        except MemoryError as inner:
            raise RuntimeError("wrapper") from inner
    except RuntimeError as e:
        return e


def _cycle():
    a, c = RuntimeError("a"), RuntimeError("b")
    a.__cause__, c.__cause__ = c, a
    return a


@pytest.mark.parametrize("make, want", [
    (lambda bm: MemoryError("alloc"), True),
    (lambda bm: bm.ResourceExhausted("hbm"), True),
    (lambda bm: RuntimeError("RESOURCE_EXHAUSTED: Out of memory while "
                             "trying to allocate 2.1G"), True),
    (lambda bm: RuntimeError("OOM when allocating"), True),
    (lambda bm: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (lambda bm: ValueError("bad shape"), False),
    (lambda bm: RuntimeError("device lost"), False),
    (lambda bm: _wrapped(), True),
    (lambda bm: _cycle(), False),
])
def test_capacity_classifier_matches_jax(make, want):
    assert tbreaker.is_capacity_error(make(tbreaker)) is want
    assert jbreaker.is_capacity_error(make(jbreaker)) is want


def test_raise_mode_fault_point_classifies():
    """device.oom=raise lands in the capacity class without a custom
    corrupt fn, in both packages; oom_fault is a no-op with no device
    registered and raises ResourceExhausted with one."""
    for fp, bm in ((tfp, tbreaker), (jfp, jbreaker)):
        fp.activate("device.oom", "raise", times=1)
        with pytest.raises(fp.FaultInjected) as ei:
            fp.fire("device.oom", payload=("cuda:0",))
        assert bm.is_capacity_error(ei.value)
        fn = bm.oom_fault()
        fn(None)
        with pytest.raises(bm.ResourceExhausted):
            fn(("cuda:0",))
    assert tfp.hits("device.oom") == jfp.hits("device.oom") == 1


# -- capacity-fault recovery --------------------------------------------------------


def _never_convicts(sched):
    assert sched.breaker.state == tbreaker.CLOSED
    assert int(sched.metrics.device_path_trips.value) == 0
    assert sched.poison_convictions == 0
    assert sched.queue.quarantine_count() == 0


@pytest.mark.parametrize("times", [1, 2])
def test_device_oom_storm_never_convicts(times):
    """device.oom on the round's dispatch: compacted and retried, every
    pod placed, no breaker trip, no conviction; the strikes reset by the
    round that succeeded."""
    b = _world()
    _pods(b, 32)
    arm("device.oom", "raise", times=times)
    assert b.run() == 32
    check_memory(b)
    t = b.sched["torch"]
    _never_convicts(t)
    assert int(t.metrics.capacity_faults.value) == times
    assert t.metrics.snapshot_compactions_total.value(trigger="oom") == times
    assert t._capacity_strikes == 0
    assert t.wave_path() == "torch-cpu"


def test_third_strike_halves_the_wave_and_takes_the_twin():
    """Three faults in a row: strike 2 halves the wave cap, strike 3
    salvages the round through the numpy twin; the same placements and
    state as JAX's."""
    b = _world()
    _pods(b, 32)
    arm("device.oom", "raise", times=3)
    assert b.run() == 32
    check_memory(b)
    t = b.sched["torch"]
    _never_convicts(t)
    assert int(t.metrics.capacity_faults.value) == 3
    assert t._wave_cap == 16 and t._capacity_strikes == 3
    assert t.metrics.waves_total.value(path="host") >= 1


def test_device_oom_at_a_per_wave_dispatch():
    """run_once: the per-wave dispatch's capacity fault is compacted and
    the wave retried."""
    b = _world(wave=16)
    _pods(b, 16)
    arm("device.oom", "raise", times=1)
    assert each(b, lambda s, sched: sched.run_once()) == 16
    b.check()
    check_memory(b)
    _never_convicts(b.sched["torch"])


def test_device_oom_at_a_gang_dispatch():
    """A gang's capacity fault is compacted and the gang placed all or
    nothing through the twin's gang plane."""
    b = _world()
    for i in range(4):
        b.pod(f"g{i}", cpu="1", gang="g", min_avail=4)
    arm("device.oom", "raise", times=1)
    assert b.run() == 4
    check_memory(b)
    _never_convicts(b.sched["torch"])
    assert b.bound("g") == 4


def test_memoryerror_at_featurize_is_capacity_not_poison():
    """featurize propagates a MemoryError raw (an environment fault, not
    the pod's): the capacity ladder takes it, never a conviction."""
    b = _world()
    _pods(b, 16)
    for s in SIDES:
        feat = b.sched[s].featurizer
        orig = feat.featurize
        state = {"raised": False}

        def flaky(pods, *a, _orig=orig, _state=state, **kw):
            if not _state["raised"]:
                _state["raised"] = True
                raise MemoryError("host arena exhausted featurizing")
            return _orig(pods, *a, **kw)

        feat.featurize = flaky
    assert b.run() == 16
    check_memory(b)
    _never_convicts(b.sched["torch"])
    assert int(b.sched["torch"].metrics.capacity_faults.value) == 1


def test_breaker_charged_only_when_headroom_stays_negative():
    """A budget no compaction can meet: the fault is charged to the
    breaker (not tripped) and the round degrades to the twin and
    places."""
    b = _world()
    _pods(b, 16)
    for s in SIDES:
        b.sched[s].snapshot.hbm_budget_bytes = 1
    arm("device.oom", "raise", times=1)
    assert b.run() == 16
    check_memory(b)
    t = b.sched["torch"]
    assert t.breaker.failures >= 1
    assert int(t.metrics.device_path_trips.value) == 0
    assert t.poison_convictions == 0


def test_healthy_budget_keeps_breaker_unchanged():
    b = _world(hbm_budget_bytes=1 << 30)
    _pods(b, 16)
    arm("device.oom", "raise", times=1)
    assert b.run() == 16
    check_memory(b)
    t = b.sched["torch"]
    assert t.breaker.failures == 0
    _never_convicts(t)


def test_compaction_crash_under_oom_still_places():
    """snapshot.compact raising with device.oom armed: the ladder's sweep
    crashes, _compact_guarded swallows it (the live snapshot unchanged),
    the round degrades to the twin and places everyone."""
    b = _world()
    _pods(b, 16)
    arm("device.oom", "raise", times=1)
    arm("snapshot.compact", "raise")
    assert b.run() == 16
    disarm("snapshot.compact")
    check_memory(b)
    t = b.sched["torch"]
    _never_convicts(t)
    assert t.metrics.snapshot_compactions_total.total() == 0
    assert tfp.hits("snapshot.compact") == 1


SEAMS = ("device.oom", "kernel.hang", "device.lost", "snapshot.write")


def test_seams_fire_as_often_as_jax():
    """device.oom beside kernel.hang and device.lost in record_dispatch,
    and snapshot.write in refresh_node_resources, armed as no-op corrupt
    faults (counted, never failing) through rounds, a gang dispatch, a
    preemption what-if and a per-wave dispatch: the same hits in both
    packages."""
    b = Both(6, wave=4, cpu="2")
    for name in SEAMS:
        arm(name, "corrupt", make=lambda pkg: (lambda payload: None))
    for i in range(4):
        b.pod(f"hog-{i}", cpu="2", priority=1)
    assert b.run() == 4
    for i in range(2):
        b.pod(f"g{i}", cpu="1", gang="g", min_avail=2)
    assert b.run() == 2
    for i in range(2):
        b.pod(f"vip-{i}", cpu="2", priority=100)
    b.run()
    b.pod("late", cpu="100m")
    assert each(b, lambda s, sched: sched.run_once()) == 1
    b.check()
    check_faults(b, SEAMS)
    assert tfp.hits("device.oom") == tfp.hits("kernel.hang") >= 4
    assert tfp.hits("snapshot.write") > 0


# -- the what-if's capacity fault (ROADMAP queue 3) ---------------------------------


def _saturated(n_nodes=4, wave=4):
    """n_nodes 2-cpu nodes, each full with one priority-1 hog."""
    b = Both(n_nodes, wave=wave, cpu="2")
    for i in range(n_nodes):
        b.pod(f"hog-{i}", cpu="2", priority=1)
    assert b.run() == n_nodes
    return b


def test_whatif_oom_is_salvaged_on_the_twin(monkeypatch):
    """device.oom (raise, once) at the first preemption chunk's what-if
    dispatch. Both what-ifs dispatch through ops/kernel.py
    record_dispatch, where the point fires; it is armed by a wrapper
    around each package's what-if entry (the JAX scheduler imports
    ops.preempt.preemption_stats inside _preempt_chunk, the port's
    scheduler holds its own name), just before the call, so that the
    round's dispatch is not hit. JAX charges the breaker and salvages the
    chunk through preemption_stats_host; so does the port: the same
    nominations, victims, bindings and fault state, and one device.oom
    hit in each."""
    b = _saturated(4, wave=4)
    for i in range(4):
        b.pod(f"vip-{i}", cpu="2", priority=100)

    def arming(fn, fp):
        armed = []

        def call(*a, **kw):
            if not armed:
                armed.append(1)
                fp.activate("device.oom", "raise", times=1)
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(jpreempt, "preemption_stats",
                        arming(jpreempt.preemption_stats, jfp))
    monkeypatch.setattr(tsched, "preemption_stats",
                        arming(tsched.preemption_stats, tfp))
    b.run()
    check_faults(b, ("device.oom",))
    t = b.sched["torch"]
    assert tfp.hits("device.oom") == 1
    # charged once, then cleared by the next successful round
    assert t.metrics.scheduling_errors.value(stage="wave") == 1
    assert t.breaker.state == tbreaker.CLOSED and t.breaker.trips == 0
    assert t.pipeline_preemptions == 4
    assert t.metrics.capacity_faults.value == 0
