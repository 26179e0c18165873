"""The port's cluster-invariant checker (kubernetes_tpu_torch/chaos/
invariants.py) and its Scheduler hooks against the JAX package's.

The checker's mutation cases (tests/test_campaign.py:170-287) run on
both packages: each seeds one bug class into a live scheduler's state
(a lost pod, a double-booked pod, a cache double-bind, a split gang, a
corrupted snapshot row, an illegal breaker state, an over-committed
node) and both checkers must name the same invariants with the same
details and digests, at the same check (the eventually-consistent
invariants fire at the second). `Scheduler(invariants=True)` drains the
worlds of tests/torch_worlds.py clean in both, after as many checks;
and with the broken-build hook `_journal_replay_enabled` off, a store
outage's spooled intent that outlives the outage is caught as
`conservation` in both (tests/test_outage.py:445-470's scenario, driven
through the checker without the campaign).
"""

import importlib

import numpy as np
import pytest

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import SCHED_CAPS, Both, arm
from torch_worlds import (FakeClock, bindings, plain_node, plain_pod,
                          spread_store_world, store_world)

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def test_the_invariant_names_and_exports_are_the_jax_ones():
    j = mod("kubernetes_tpu", "chaos.invariants")
    t = mod("kubernetes_tpu_torch", "chaos.invariants")
    assert t.INVARIANTS == j.INVARIANTS
    assert t._DIGEST_CAP == j._DIGEST_CAP
    chaos = mod("kubernetes_tpu_torch", "chaos")
    assert chaos.__all__ == [
        "InvariantChecker", "InvariantViolation", "SAMPLABLE", "NASTY_PAIRS",
        "FaultSpec", "ReplayOutcome", "Finding", "CampaignResult",
        "env_string", "sample_schedule", "replay", "shrink", "run_campaign"]
    assert issubclass(chaos.InvariantViolation, AssertionError)
    decl = mod("kubernetes_tpu_torch", "utils.metrics").Metrics() \
        .invariant_violations.decl
    assert set(decl.values["invariant"]) == set(t.INVARIANTS)


# -- the mutation cases (tests/test_campaign.py:170-287) ----------------------


def _world(pkg, n_nodes=2, strict=False):
    """A scheduler on the CPU over `n_nodes` 16-core nodes with a
    collecting (or strict) checker attached, as _mk_world does."""
    store = mod(pkg, "runtime.store").ObjectStore()
    kw = dict(device="cpu") if pkg == "kubernetes_tpu_torch" else {}
    sched = mod(pkg, "sched.scheduler").Scheduler(
        store, wave_size=8, caps=mod(pkg, "ops.encoding").Caps(**SCHED_CAPS),
        clock=FakeClock(), **kw)
    checker = mod(pkg, "chaos.invariants").InvariantChecker(
        metrics=sched.metrics, strict=strict)
    sched.invariants = checker
    for i in range(n_nodes):
        store.create("nodes", plain_node(pkg, f"n{i}", cpu="16",
                                         memory="32Gi"))
    return store, sched, checker


def _check(sched, checker):
    with sched._mu:
        return checker.check(sched)


def _found(vs):
    return [(v.invariant, v.detail, v.digest) for v in vs]


def _pod(pkg, name, **kw):
    kw.setdefault("cpu", "100m")
    kw.setdefault("memory", "64Mi")
    return plain_pod(pkg, name, **kw)


def _lost(pkg, store, sched):
    pod = _pod(pkg, "lost-1")
    store.create("pods", pod)
    # the seeded bug: the pod vanishes from every queue area while still
    # Pending in the store
    sched.queue.delete(pod)


def _double_booked(pkg, store, sched):
    pod = _pod(pkg, "dbl-1")
    store.create("pods", pod)  # sits in the active area
    # bound in the store but never removed from the queue
    pod.spec.node_name = "n0"


def _cache_double_bind(pkg, store, sched):
    pod = _pod(pkg, "twice-1", node_name="n0")
    store.create("pods", pod)
    sched.cache.node_infos["n1"].pods.append(pod)


def _split_gang(pkg, store, sched):
    # one member committed, the rest abandoned
    store.create("pods", _pod(pkg, "gs-0", gang="gsplit", min_avail=3,
                              node_name="n0"))
    for i in (1, 2):
        store.create("pods", _pod(pkg, f"gs-{i}", gang="gsplit",
                                  min_avail=3))


def _snapshot_row(pkg, store, sched):
    # a host-only write to one node row of the usage plane: the checker
    # reads the host planes in both packages (nothing dispatches after)
    store.create("pods", _pod(pkg, "res-1", node_name="n1"))
    row = sched.snapshot.node_index["n1"]
    sched.snapshot.requested[row, 0] += 4000.0


def _snapshot_count(pkg, store, sched):
    store.create("pods", _pod(pkg, "res-1", node_name="n0"))
    sched.snapshot.pod_count[sched.snapshot.node_index["n0"]] += 1


def _snapshot_nan(pkg, store, sched):
    sched.snapshot.requested[sched.snapshot.node_index["n1"], 1] = np.nan


def _over_capacity(pkg, store, sched):
    for i in range(3):
        store.create("pods", _pod(pkg, f"big-{i}", cpu="7", node_name="n0"))


def _bad_breaker(pkg, store, sched):
    sched.breaker.state = "wedged"
    sched.storehealth.failures = -1


MUTATIONS = {
    # name -> (seed the bug, invariants at the first and second check)
    "lost_pod": (_lost, [], ["conservation"]),
    "double_booked": (_double_booked, [], ["conservation"]),
    "cache_double_bind": (_cache_double_bind, ["double_bind"],
                          ["double_bind"]),
    "split_gang": (_split_gang, [], ["gang_atomic"]),
    "snapshot_row": (_snapshot_row, ["snapshot_usage"], ["snapshot_usage"]),
    "snapshot_count": (_snapshot_count, ["snapshot_usage"],
                       ["snapshot_usage"]),
    "snapshot_nan": (_snapshot_nan, ["snapshot_usage"], ["snapshot_usage"]),
    "over_capacity": (_over_capacity, ["capacity"], ["capacity"]),
    "bad_breaker": (_bad_breaker, ["state_machine", "state_machine"],
                    ["state_machine", "state_machine"]),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_a_seeded_bug_fires_the_same_invariant_in_both(case):
    seed, first, second = MUTATIONS[case]
    got = {}
    for pkg in PKGS:
        store, sched, checker = _world(pkg)
        try:
            seed(pkg, store, sched)
            v1 = _found(_check(sched, checker))
            v2 = _found(_check(sched, checker))
            got[pkg] = (v1, v2, checker.checks,
                        {c.name: c.value for c in
                         sched.metrics.invariant_violations.children()})
        finally:
            sched.close()
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    v1, v2, _, counted = got["kubernetes_tpu_torch"]
    assert [v[0] for v in v1] == first
    assert [v[0] for v in v2] == second
    assert sum(counted.values()) == len(first) + len(second)


def test_the_offenders_are_named_in_the_digests():
    """The evidence each mutation leaves (test_campaign.py's asserts),
    read from the port's findings."""
    pkg = "kubernetes_tpu_torch"
    seen = {}
    for case in ("lost_pod", "double_booked", "cache_double_bind",
                 "split_gang", "snapshot_row"):
        store, sched, checker = _world(pkg)
        try:
            MUTATIONS[case][0](pkg, store, sched)
            first = _check(sched, checker)
            seen[case] = first or _check(sched, checker)
        finally:
            sched.close()
    assert "lost-1" in seen["lost_pod"][0].digest["lost"]
    assert "lost" in seen["lost_pod"][0].detail
    assert any("dbl-1" in b and "placed+" in b
               for b in seen["double_booked"][0].digest["double_booked"])
    assert any("twice-1" in d for d in
               seen["cache_double_bind"][0].digest["cache_dupes"])
    assert any("gsplit" in g and "(1/3)" in g for g in
               seen["split_gang"][0].digest["partial_gangs"])
    assert seen["snapshot_row"][0].digest["diverged_rows"] == ["1"]


def test_a_clean_drain_is_clean_in_both():
    got = {}
    for pkg in PKGS:
        store, sched, checker = _world(pkg)
        try:
            for i in range(4):
                store.create("pods", _pod(pkg, f"ok-{i}"))
            sched.schedule_pending()
            assert not _check(sched, checker)
            got[pkg] = (checker.checks, bindings(store))
        finally:
            sched.close()
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    assert got["kubernetes_tpu_torch"][0] > 1  # schedule_pending checked


@pytest.mark.parametrize("pkg", PKGS)
def test_strict_raises_and_counts_the_metric(pkg):
    inv = mod(pkg, "chaos.invariants")
    store, sched, checker = _world(pkg, strict=True)
    try:
        _lost(pkg, store, sched)
        _check(sched, checker)
        with pytest.raises(inv.InvariantViolation) as ei:
            _check(sched, checker)
        assert ei.value.invariant == "conservation"
        assert sched.metrics.invariant_violations.value(
            invariant="conservation") == 1
        with pytest.raises(inv.InvariantViolation):
            checker.assert_clean()
    finally:
        sched.close()


# -- Scheduler(invariants=True) over the parity worlds --------------------------


WORLDS = {
    "density": lambda pkg: store_world(pkg, 5, 16, 40),
    "spread": lambda pkg: spread_store_world(pkg, 7, 12, 30, 3),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_a_checked_scheduler_drains_the_worlds_clean(world):
    """A strict checker after every round of the drain, then a later
    batch through run_once: no violation in either package, as many
    checks, the same bindings."""
    got = {}
    for pkg in PKGS:
        store, _ = WORLDS[world](pkg)
        kw = dict(device="cpu") if pkg == "kubernetes_tpu_torch" else {}
        sched = mod(pkg, "sched.scheduler").Scheduler(
            store, wave_size=16, invariants=True, clock=FakeClock(),
            caps=mod(pkg, "ops.encoding").Caps(**SCHED_CAPS), **kw)
        try:
            assert sched.invariants.strict
            sched.schedule_pending()
            for i in range(3):
                store.create("pods", _pod(pkg, f"late-{i}"))
            while sched.run_once():
                pass
            got[pkg] = (sched.invariants.checks,
                        len(sched.invariants.violations), bindings(store))
        finally:
            sched.close()
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    checks, violations, bound = got["kubernetes_tpu_torch"]
    assert checks >= 3 and violations == 0
    assert all(bound[f"late-{i}"] for i in range(3))


def test_invariants_off_costs_no_check():
    store, sched, _ = _world("kubernetes_tpu_torch")
    sched.invariants = None
    try:
        store.create("pods", _pod("kubernetes_tpu_torch", "p0"))
        assert sched.schedule_pending() == 1  # no checker, nothing raised
    finally:
        sched.close()


# -- the broken-build hook: a spool that outlives the outage ----------------------


def _outage(tmp_path, replay_enabled):
    """Both schedulers (a journal each, the store plane pinned, a
    collecting checker attached), `_journal_replay_enabled` as given.
    store.outage raises four times: the first bind's three POSTs trip
    the breaker and its truth GET fails, so the intent spools, and the
    other pods of the wave spool behind it. Past the probe deadline a
    late pod's bind is the probe and reconnects the store; two checks
    follow. Returns Both and each side's findings."""
    from test_torch_storeplane import pin

    b = Both(wave=8, caps=SCHED_CAPS,
             sched_kw=dict(store_breaker_cooldown=2.0),
             side_kw=lambda side: dict(
                 bind_journal_path=str(tmp_path / f"{side}.journal")))
    checkers = {}
    for side, s in b.sched.items():
        pin(s)
        s._journal_replay_enabled = replay_enabled
        inv = mod(b.pkg(side), "chaos.invariants")
        checkers[side] = s.invariants = inv.InvariantChecker(
            metrics=s.metrics, strict=False)
    for i in range(2):
        b.node(f"n{i}", cpu="16", memory="32Gi")
    arm("store.outage", "raise", times=4)
    for i in range(4):
        b.pod(f"p{i}", cpu="100m", memory="64Mi")
    for s in b.sched.values():
        assert s.run_once() == 4
        assert s.storehealth.state == "disconnected"
        assert s.spool_count() == 4
    b.advance(2.5)
    b.pod("late", cpu="100m", memory="64Mi")
    for s in b.sched.values():
        s.run_once()
        _check(s, s.invariants)
    b.check()
    found = {side: _found(c.violations) for side, c in checkers.items()}
    return b, found


def test_a_spool_outliving_the_outage_is_caught_as_conservation(tmp_path):
    b, found = _outage(tmp_path, replay_enabled=False)
    assert found["torch"] == found["jax"]
    assert [v[0] for v in found["torch"]] == ["conservation"]
    assert "outlived the outage" in found["torch"][0][1]
    assert found["torch"][0][2]["spool_stale"] == ["p0", "p1", "p2", "p3"]
    t = b.sched["torch"]
    assert t.storehealth.state == "connected" and t.spool_count() == 4
    assert bindings(b.stores["torch"])["late"]


def test_the_healthy_build_drains_the_same_schedule_clean(tmp_path):
    b, found = _outage(tmp_path, replay_enabled=True)
    assert found == {"jax": [], "torch": []}
    t = b.sched["torch"]
    assert t.spool_count() == 0 and t.journal.unresolved() == []
    assert all(bindings(b.stores["torch"]).values())


@pytest.mark.parametrize("pkg", PKGS)
def test_the_hook_also_stops_the_journal_replay(pkg, tmp_path):
    store = mod(pkg, "runtime.store").ObjectStore()
    kw = dict(device="cpu") if pkg == "kubernetes_tpu_torch" else {}
    sched = mod(pkg, "sched.scheduler").Scheduler(
        store, wave_size=8, bind_journal_path=str(tmp_path / "j"),
        clock=FakeClock(), **kw)
    try:
        sched.journal.append_intent(_pod(pkg, "ghost"), "n0")
        sched._journal_replay_enabled = False
        assert sched.recover_from_journal() == {
            "adopted": 0, "respooled": 0, "requeued": 0, "gone": 0,
            "unreachable": 0}
        sched._journal_replay_enabled = True
        assert sched.recover_from_journal()["gone"] == 1
    finally:
        sched.close()
