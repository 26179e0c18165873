"""The snapshot scrubber of kubernetes_tpu_torch (state/scrubber.py)
against the JAX package's (tests/test_scrubber.py's detect, repair,
ghost, trigger and rebuild cases): the same world is built in both
packages from the same store writes, the same rows are corrupted in
both, and the scrub reports (divergent rows and fields, repairs, rows
checked), the repaired snapshots' host arrays, the scrub series and the
`snapshot.write` hit counts must be equal. The port's repaired mirror
also equals a from-scratch rebuild, and its next upload rides the row
deltas.
"""

import os
import signal

import numpy as np
import pytest

from kubernetes_tpu.utils import faultpoints as jfp
from kubernetes_tpu_torch.runtime.store import ObjectStore
from kubernetes_tpu_torch.sched.scheduler import Scheduler
from kubernetes_tpu_torch.state.snapshot import SNAPSHOT_ARRAYS
from kubernetes_tpu_torch.utils import faultpoints as tfp

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both, arm
from torch_worlds import FakeClock, plain_node, plain_pod

SIDES = ("jax", "torch")
TORCH = "kubernetes_tpu_torch"


def _cluster(n_nodes=4, n_pods=8, cpu="4", **kw):
    """n_nodes nodes of `cpu` cores and n_pods bound 1-core pods, in both
    packages."""
    b = Both(0, wave=16, caps=None, sched_kw=kw)
    for i in range(n_nodes):
        b.node(f"n{i}", cpu=cpu)
    for i in range(n_pods):
        b.pod(f"p{i}", cpu="1")
    assert b.run() == n_pods
    return b


def _report(rep):
    return ([(d.node, list(d.fields), d.repaired) for d in rep.divergences],
            rep.nodes_checked, rep.pods_checked, rep.repaired, rep.clean)


def scrub(b, **kw):
    """Scrub both packages' snapshots; the reports must agree. Returns
    the port's report."""
    reps = {s: b.sched[s].scrubber.scrub(**kw) for s in SIDES}
    assert _report(reps["torch"]) == _report(reps["jax"])
    return reps["torch"]


def check_arrays(b):
    """Every host plane of the two snapshots equal, and the registries
    and scrub series."""
    j, t = (b.sched[s].snapshot for s in SIDES)
    for name in SNAPSHOT_ARRAYS:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert t.node_index == j.node_index and t.pod_slot == j.pod_slot
    mj, mt = (b.sched[s].metrics for s in SIDES)
    for name in ("snapshot_scrub_runs", "snapshot_scrub_divergences",
                 "snapshot_scrub_repairs"):
        assert getattr(mt, name).value == getattr(mj, name).value, name
    assert mt.snapshot_scrub_duration.total == \
        mj.snapshot_scrub_duration.total


def corrupt(b, fn):
    """fn(snapshot) on both packages' snapshots."""
    for s in SIDES:
        fn(b.sched[s].snapshot)


# -- clean ---------------------------------------------------------------------


def test_settled_cluster_reports_zero_divergence():
    b = _cluster()
    rep = scrub(b)
    assert rep.clean, rep.summary()
    assert (rep.nodes_checked, rep.pods_checked, rep.repaired) == (4, 8, 0)
    check_arrays(b)


def test_scrub_metrics():
    b = _cluster(n_nodes=2, n_pods=2)
    scrub(b)
    check_arrays(b)
    corrupt(b, lambda snap: snap.requested.__setitem__(
        (snap.node_index["n0"], 0),
        snap.requested[snap.node_index["n0"], 0] + 512.0))
    scrub(b)
    check_arrays(b)
    m = b.sched["torch"].metrics
    assert (m.snapshot_scrub_runs.value, m.snapshot_scrub_divergences.value,
            m.snapshot_scrub_repairs.value) == (2, 1, 1)


# -- detect and repair -----------------------------------------------------------


def _bump(field, node, col, by):
    def fn(snap):
        getattr(snap, field)[snap.node_index[node], col] += by
    return fn


def test_single_corrupt_row_detected_and_repaired_in_one_cycle():
    b = _cluster()
    corrupt(b, _bump("requested", "n2", 0, 1000.0))
    rep = scrub(b)
    assert [(d.node, d.fields, d.repaired) for d in rep.divergences] == [
        ("n2", ["requested"], True)]
    assert scrub(b).clean
    check_arrays(b)


def test_corrupt_topology_row():
    b = _cluster()

    def fn(snap):
        idx = snap.node_index["n1"]
        snap.alloc[idx, 0] += 4000.0
        snap.cond[idx, 0] = True

    corrupt(b, fn)
    rep = scrub(b)
    assert len(rep.divergences) == 1
    assert set(rep.divergences[0].fields) == {"alloc", "cond"}
    assert scrub(b).clean
    check_arrays(b)


def test_repaired_snapshot_matches_from_scratch_rebuild():
    """After corrupt -> scrub every node row of the port's snapshot
    equals what a fresh port scheduler builds from the same store, and
    the next batch places as in JAX."""
    b = _cluster()

    def fn(snap):
        idx = snap.node_index["n0"]
        snap.alloc[idx, 0] += 4000.0
        snap.pod_count[idx] += 3

    corrupt(b, fn)
    rep = scrub(b)
    assert not rep.clean and rep.repaired >= 1
    check_arrays(b)
    fresh = Scheduler(b.stores["torch"], device="cpu")
    a, c = b.sched["torch"].snapshot, fresh.snapshot
    for name in a.node_index:
        ia, ic = a.node_index[name], c.node_index[name]
        for f in ("alloc", "requested", "nonzero", "pod_count",
                  "allowed_pods", "labels", "taint_key", "cond",
                  "zone_id", "avoid"):
            np.testing.assert_array_equal(np.atleast_1d(getattr(a, f)[ia]),
                                          np.atleast_1d(getattr(c, f)[ic]))
    for i in range(8):
        b.pod(f"x{i}", cpu="1")
    assert b.run() == 8


def test_pod_row_divergence():
    b = _cluster(n_nodes=2, n_pods=2)
    pod = next(p for p in b.stores["torch"].list("pods") if p.spec.node_name)

    def fn(snap):
        right = snap.node_index[pod.spec.node_name]
        snap.ep_node[snap.pod_slot[pod.uid]] = (right + 1) % 2

    corrupt(b, fn)
    rep = scrub(b)
    assert any("pod-node" in d.fields for d in rep.divergences)
    assert scrub(b).clean
    check_arrays(b)


def test_stale_pod_request_row():
    """ep_req rows feed the preemption what-if; a stale row silently skews
    victim accounting."""
    b = _cluster(n_nodes=2, n_pods=2)
    pod = next(p for p in b.stores["torch"].list("pods") if p.spec.node_name)
    corrupt(b, lambda snap: snap.ep_req.__setitem__(
        (snap.pod_slot[pod.uid], 0), snap.ep_req[snap.pod_slot[pod.uid], 0]
        * 7))
    rep = scrub(b)
    assert any("pod-req" in d.fields for d in rep.divergences)
    assert scrub(b).clean
    check_arrays(b)


def test_ghost_pod_row_removed():
    b = _cluster(n_nodes=2, n_pods=2)

    def fn(snap):
        slot = snap._alloc_slot("ghost-uid")
        snap.ep_valid[slot] = True
        snap.ep_alive[slot] = True
        snap.ep_node[slot] = 0

    corrupt(b, fn)
    rep = scrub(b)
    assert any(d.fields == ["ghost-pod"] for d in rep.divergences)
    assert "ghost-uid" not in b.sched["torch"].snapshot.pod_slot
    assert scrub(b).clean
    check_arrays(b)


def test_ghost_node_row_removed():
    b = _cluster(n_nodes=3, n_pods=0)
    for s in SIDES:
        assert b.sched[s].cache.node_infos.pop("n2") is not None
    rep = scrub(b)
    assert any(d.fields == ["ghost-node"] for d in rep.divergences)
    assert "n2" not in b.sched["torch"].snapshot.node_index
    assert scrub(b).clean
    check_arrays(b)


def test_missing_node_row_restored():
    b = _cluster(n_nodes=3, n_pods=0)
    corrupt(b, lambda snap: snap.remove_node("n1"))
    rep = scrub(b)
    assert any("missing-node" in d.fields for d in rep.divergences)
    t = b.sched["torch"].snapshot
    assert t.valid[t.node_index["n1"]]
    assert scrub(b).clean
    check_arrays(b)


def test_scrub_is_immune_to_unbounded_corrupt_fault():
    """The golden-row build and the repair writes run with the fault
    points suppressed: an unbounded snapshot.write corrupt fault neither
    blinds the compare nor re-corrupts the repaired row."""
    b = _cluster(n_nodes=2, n_pods=2)
    corrupt(b, _bump("alloc", "n0", 0, 4000.0))
    arm("snapshot.write", "corrupt")
    rep = scrub(b)
    assert len(rep.divergences) == 1 and rep.repaired == 1
    assert scrub(b).clean
    check_arrays(b)
    assert tfp.hits("snapshot.write") == jfp.hits("snapshot.write") == 0


def test_audit_only_mode_repairs_nothing():
    b = _cluster(n_nodes=2, n_pods=0)
    corrupt(b, _bump("alloc", "n0", 0, 4000.0))
    rep = scrub(b, repair=False)
    assert not rep.clean and rep.repaired == 0
    assert not scrub(b, repair=False).clean
    check_arrays(b)


def test_snapshot_write_corruption_of_eight_rows():
    """snapshot.write in its default corrupt mode (4 cores of phantom
    allocatable CPU on the row just written), bounded to 8 fires, while
    the resource rows of 8 of 40 nodes are refreshed: the same 8 hits in
    both packages, a scrub reports exactly those 8 rows (alloc) and
    repairs them, and the port's next upload is row deltas."""
    b = _cluster(n_nodes=40, n_pods=12, cpu="4")
    t = b.sched["torch"].snapshot
    t.to_device("cpu")
    b.sched["jax"].snapshot.to_device()
    hit = [f"n{i}" for i in range(0, 40, 5)]
    arm("snapshot.write", "corrupt", times=8)
    for s in SIDES:
        sched = b.sched[s]
        for name in hit:
            sched.snapshot.refresh_node_resources(sched.cache.node_infos[name])
    assert tfp.hits("snapshot.write") == jfp.hits("snapshot.write") == 8
    rep = scrub(b)
    assert sorted(d.node for d in rep.divergences) == sorted(hit)
    assert all(d.fields == ["alloc"] and d.repaired
               for d in rep.divergences)
    assert scrub(b).clean
    check_arrays(b)
    before = t.upload_bytes_total
    t.to_device("cpu")
    moved = t.upload_bytes_total - before
    assert 0 < moved < t.hbm_bytes() // 4, (moved, t.hbm_bytes())
    for i in range(8):
        b.pod(f"x{i}", cpu="1")
    assert b.run() == 8


# -- triggers ---------------------------------------------------------------------


def test_periodic_cadence():
    b = Both(0, caps=None, sched_kw=dict(scrub_interval=60.0))
    b.node("n0")
    assert all(b.sched[s].scrubber.maybe_scrub() is None for s in SIDES)
    b.advance(61.0)
    reps = {s: b.sched[s].scrubber.maybe_scrub() for s in SIDES}
    assert _report(reps["torch"]) == _report(reps["jax"])
    assert reps["torch"].nodes_checked == 1
    assert all(b.sched[s].scrubber.maybe_scrub() is None for s in SIDES)


def test_request_flag_drained_by_run_loop():
    b = _cluster(n_nodes=1, n_pods=0)
    for s in SIDES:
        b.sched[s].scrubber.request()
        b.sched[s].run_once()
    check_arrays(b)
    assert b.sched["torch"].metrics.snapshot_scrub_runs.value == 1


@pytest.mark.skipif(not hasattr(signal, "SIGUSR2"),
                    reason="no SIGUSR2 on this platform")
def test_sigusr2_requests_scrub():
    store = ObjectStore()
    sched = Scheduler(store, device="cpu", clock=FakeClock())
    store.create("nodes", plain_node(TORCH, "n0"))
    if not sched.scrubber.install_signal():
        pytest.skip("not on the main thread")
    try:
        os.kill(os.getpid(), signal.SIGUSR2)
        assert sched.scrubber.due()
        rep = sched.scrubber.maybe_scrub()
        assert rep is not None and rep.clean
    finally:
        signal.signal(signal.SIGUSR2, signal.SIG_DFL)


def test_rebuild_resets_device_cache_and_matrices():
    """rebuild (the breaker's recovery action) rewrites every row from
    host truth and drops the device tensors; both packages end with the
    same arrays, and the next drain places as in JAX."""
    b = _cluster()
    b.sched["torch"].snapshot.to_device("cpu")

    def fn(snap):
        idx = snap.node_index["n3"]
        snap.alloc[idx, :] = 0
        snap.requested[idx, :] = 99.0

    corrupt(b, fn)
    for s in SIDES:
        b.sched[s].scrubber.rebuild()
    t = b.sched["torch"].snapshot
    assert t.dirty_pods and "res" not in t._device_cache
    assert scrub(b).clean
    check_arrays(b)
    b.pod("post-rebuild", cpu="1")
    assert b.run() == 1


def test_breaker_recovery_rebuilds_the_mirror():
    """The port's breaker recovers through scrubber.rebuild, as the JAX
    scheduler's does: after a trip and the half-open probe both packages
    close, place alike, and scrub clean. (The rows are not corrupted
    while the breaker is open: the JAX CPU backend's device arrays may
    alias the host planes, so a host-only corruption reaches JAX's
    device copy and not the port's.)"""
    b = _cluster(n_nodes=4, n_pods=0, breaker_threshold=1,
                 breaker_cooldown=5.0)
    t = b.sched["torch"]
    assert t.breaker.on_recover == t.scrubber.rebuild
    arm("kernel.round", "raise", times=1)
    arm("kernel.wave", "raise", times=1)
    b.pod("a", cpu="1")
    assert b.run() == 1
    assert t.breaker.state == "open"
    t.snapshot.to_device("cpu")
    b.advance(6.0)
    b.pod("c", cpu="1")
    assert b.run() == 1
    assert t.breaker.state == "closed"
    assert scrub(b).clean
    check_arrays(b)
