"""Poison-work isolation in the port's scheduler against the JAX
scheduler's (tests/test_poison.py's scenarios, each run through both
packages in lockstep): typed featurizer convictions, the numeric-
integrity sentinel, wave bisection within log2(wave)+1 input-fault
rounds, gang-atomic conviction, the quarantine area's re-probe ladder
and spec-edit release, and the lost-conviction fallback. After every
step the bindings, PodScheduled conditions, the quarantine, the breaker
(which must stay CLOSED: bad work never blames the card) and the
metrics are equal.

`test_nan_spec_regression` is the fault the port had before its
fault plane: a pod whose cpu request is NaN made the port's
`schedule_pending` raise PodFeaturizeError and place nothing, where the
JAX scheduler quarantines it and places the other 63 bit-equal to a
clean run.
"""

import copy
import math

import numpy as np
import torch

from kubernetes_tpu.ops import hostwave as jhw
from kubernetes_tpu.ops import kernel as jk
from kubernetes_tpu.state.featurize import poison_pod_fault as jpoison
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import hostwave as thw
from kubernetes_tpu_torch.ops import kernel as tk
from kubernetes_tpu_torch.runtime.store import ObjectStore
from kubernetes_tpu_torch.sched import breaker as breaker_mod
from kubernetes_tpu_torch.sched.queue import SchedulingQueue
from kubernetes_tpu_torch.sched.scheduler import Scheduler
from kubernetes_tpu_torch.state.featurize import poison_pod_fault

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both, arm, check_faults
from torch_worlds import FakeClock, bindings, plain_node, plain_pod

WAVE = 64
TORCH = "kubernetes_tpu_torch"
POINTS = ("featurize.poison", "wave.poison", "queue.quarantine",
          "kernel.round", "kernel.wave")


def poisoned(pod):
    """A malformed spec: a NaN cpu quantity (resource_list rejects one,
    so this models a corrupted or hand-built object)."""
    pod.spec.containers[0].resources.requests["cpu"] = float("nan")
    return pod


def _world(n_nodes=16, **kw):
    return Both(n_nodes, wave=WAVE, sched_kw=kw, cpu="32", memory="64Gi",
                zone="z0")


def _pods(b, n, poison_idx=(), prefix="p"):
    for i in range(n):
        name = f"{prefix}{i}"
        if i in poison_idx:
            b.create("pods", lambda pkg, name=name: poisoned(plain_pod(
                pkg, name, cpu="100m", memory="128Mi")))
        else:
            b.pod(name, cpu="100m", memory="128Mi")


def _placed(b):
    return {k: v for k, v in bindings(b.stores["torch"]).items() if v}


def _clean_run(n, skip_idx, n_nodes=16):
    """The same world drained WITHOUT the poison pods."""
    b = _world(n_nodes)
    _pods(b, n)
    for i in skip_idx:
        b.delete(f"p{i}")
    b.run()
    return _placed(b)


def _unblamed(b):
    for s in b.sched.values():
        assert s.breaker.state == breaker_mod.CLOSED
        assert int(s.metrics.device_path_trips.value) == 0


def _poison_fn(uid, kind):
    """make(pkg) for arm(): each package's own poison_pod_fault."""
    return lambda pkg: (jpoison if pkg == "kubernetes_tpu"
                        else poison_pod_fault)(uid, kind)


# -- the regression: a NaN spec ------------------------------------------------


def test_nan_spec_regression():
    """16 nodes, 64 pods, p7's cpu NaN, one Scheduler(wave_size=64) on
    the CPU: p7 is quarantined and the other 63 are placed (the port
    raised PodFeaturizeError here and placed none before its fault
    plane; TestFeaturizeConviction holds the same world to the JAX
    scheduler and to a clean run without p7)."""
    store = ObjectStore()
    sched = Scheduler(store, wave_size=64, device="cpu", clock=FakeClock())
    for i in range(16):
        store.create("nodes", plain_node(TORCH, f"n{i}"))
    for i in range(64):
        pod = plain_pod(TORCH, f"p{i}", cpu="100m", memory="128Mi")
        store.create("pods", poisoned(pod) if i == 7 else pod)
    assert sched.schedule_pending() == 63
    assert [p.metadata.name for p in sched.queue.quarantined_pods()] == [
        "p7"]
    assert sum(1 for v in bindings(store).values() if v) == 63
    assert sched.breaker.state == breaker_mod.CLOSED


# -- direct attribution: the featurizer ---------------------------------------


class TestFeaturizeConviction:
    def test_nan_spec_convicted_direct_innocents_bit_equal(self):
        b = _world()
        _pods(b, WAVE, poison_idx={7})
        assert b.run() == WAVE - 1
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.queue.quarantine_count() == 1
        assert t.queue.quarantined_pods()[0].uid == "p7"
        assert t.metrics.poison_pods.value(reason="featurize") == 1
        assert t.metrics.scheduling_errors.value(stage="poison") <= 1
        _unblamed(b)
        assert _placed(b) == _clean_run(WAVE, {7})
        conds = {c[0]: c[1] for c in b.stores["torch"].get(
            "pods", "default", "p7").status.conditions}
        assert "poisoned" in conds["PodScheduled"]

    def test_featurize_crash_fault_point(self):
        b = _world()
        _pods(b, 16)
        arm("featurize.poison", "corrupt", make=_poison_fn("p3", "crash"))
        assert b.run() == 15
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.queue.quarantine_count() == 1
        assert t.metrics.poison_pods.value(reason="featurize") == 1
        _unblamed(b)


# -- the numeric-integrity sentinel --------------------------------------------


class TestSentinel:
    def test_nan_score_pod_sentinel_conviction(self):
        """Post-featurize corruption: the round's sentinel flags the pod,
        the whole round is discarded, the survivors re-run bit-equal to a
        clean run; the breaker never moves."""
        b = _world()
        _pods(b, WAVE)
        arm("wave.poison", "corrupt", make=_poison_fn("p5", "nan"))
        assert b.run() == WAVE - 1
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.queue.quarantined_pods()[0].uid == "p5"
        assert t.metrics.poison_pods.value(reason="sentinel") == 1
        _unblamed(b)
        assert _placed(b) == _clean_run(WAVE, {5})

    def test_sentinel_plane_twin_parity(self):
        """The sentinel plane of the port's wave, the port's twin and the
        JAX twin: all-True on a clean batch, flagging exactly the
        corrupted row of a poisoned one."""
        store = ObjectStore()
        sched = Scheduler(store, wave_size=16, device="cpu",
                          clock=FakeClock())
        for i in range(8):
            store.create("nodes", plain_node(TORCH, f"n{i}"))
        pods = [plain_pod(TORCH, f"q{i}", cpu="100m", memory="128Mi")
                for i in range(12)]
        pb = sched.featurizer.featurize(pods)
        nt, pm, tt = sched.snapshot.host_tensors()
        zl = dict(num_zones=sched.snapshot.caps.Z,
                  num_label_values=sched.snapshot.num_label_values)
        extra = np.ones((pb.req.shape[0], nt.valid.shape[0]), bool)

        def three():
            got, _ = thw.schedule_wave_host(nt, pm, tt, pb, extra, 0, None,
                                            weights=tk.Weights(), **zl)
            want, _ = jhw.schedule_wave_host(nt, pm, tt, pb, extra, 0, None,
                                             weights=jk.Weights(), **zl)
            ntt, pmt, ttt, pbt = tenc.to_torch(nt, pm, tt, pb, "cpu")
            dev = tk.schedule_wave(ntt, pmt, ttt, pbt,
                                   torch.from_numpy(extra),
                                   torch.tensor(0, dtype=torch.int32), None,
                                   weights=tk.Weights(), **zl)
            return np.asarray(got.finite), np.asarray(want.finite), \
                dev.finite.numpy(), (got, dev)

        fin_h, fin_j, fin_d, (got, dev) = three()
        np.testing.assert_array_equal(fin_h, fin_j)
        np.testing.assert_array_equal(fin_h, fin_d)
        np.testing.assert_array_equal(got.chosen, dev.chosen.numpy())
        assert fin_h.all()
        pb.req[3] = np.nan
        fin_h, fin_j, fin_d, _ = three()
        np.testing.assert_array_equal(fin_h, fin_j)
        np.testing.assert_array_equal(fin_h, fin_d)
        assert not fin_h[3] and fin_h[:3].all() and fin_h[4:12].all()


# -- wave bisection ------------------------------------------------------------


class TestBisection:
    def test_crash_poison_bisected_within_log2_rounds(self):
        """A crash-kind poison carries no uid: bisection along the pod
        axis convicts it in at most log2(64)+1 input-fault rounds while
        every innocent half places; equal to the JAX scheduler."""
        b = _world()
        _pods(b, WAVE)
        arm("wave.poison", "corrupt", make=_poison_fn("p41", "crash"))
        assert b.run() == WAVE - 1
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.queue.quarantined_pods()[0].uid == "p41"
        assert t.metrics.poison_pods.value(reason="bisect") == 1
        assert (t.metrics.scheduling_errors.value(stage="poison")
                <= math.log2(WAVE) + 1)
        _unblamed(b)
        assert _placed(b) == _clean_run(WAVE, {41})

    def test_device_fault_still_blames_the_runtime(self):
        """A genuine device fault (a kernel entry raising; the twin
        replay runs clean) convicts nobody and is charged to the device
        plane."""
        b = _world()
        _pods(b, 32)
        arm("kernel.round", times=1)
        arm("kernel.wave", times=1)
        assert b.run() == 32
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.queue.quarantine_count() == 0
        assert t.poison_convictions == 0
        assert t.metrics.scheduling_errors.value(stage="poison") == 0
        assert t.metrics.scheduling_errors.value(stage="wave") >= 1


# -- gang-atomic conviction ----------------------------------------------------


def _gang(b, name, n, poison_member=None):
    for j in range(n):
        pname = f"{name}-m{j}"

        def make(pkg, pname=pname, bad=(j == poison_member)):
            pod = plain_pod(pkg, pname, cpu="100m", memory="128Mi",
                            gang=name, min_avail=n)
            return poisoned(pod) if bad else pod

        b.create("pods", make)


def _fix(b, name, **kw):
    """A genuine spec edit of pod `name` in both stores (a clean spec)."""
    for side, store in b.stores.items():
        cur = store.get("pods", "default", name)
        fixed = plain_pod(b.pkg(side), name, cpu="100m", memory="128Mi",
                          **kw)
        fixed.metadata.uid = cur.uid
        fixed.metadata.resource_version = cur.metadata.resource_version
        store.update("pods", fixed)


class TestGangConviction:
    def test_poison_member_quarantines_gang_atomically(self):
        b = _world()
        _gang(b, "g1", 8, poison_member=2)
        _pods(b, 16, prefix="solo")
        assert b.run() == 16
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.queue.quarantine_count() == 8
        assert t.metrics.poison_pods.value(reason="featurize") == 1
        assert t.metrics.poison_pods.value(reason="gang") == 7
        placed = _placed(b)
        assert not any(k.startswith("g1-") for k in placed)
        assert all(f"solo{i}" in placed for i in range(16))
        _unblamed(b)

    def test_spec_fix_releases_gang_as_unit(self):
        b = _world()
        _gang(b, "g2", 4, poison_member=0)
        b.run()
        assert b.sched["torch"].queue.quarantine_count() == 4
        _fix(b, "g2-m0", gang="g2", min_avail=4)
        for s in b.sched.values():
            assert s.queue.quarantine_count() == 0  # released whole
        assert b.run() == 4  # places as a unit
        check_faults(b, POINTS)


# -- the quarantine lifecycle ---------------------------------------------------


class TestQuarantineLifecycle:
    def test_reprobe_escalates_capped_backoff(self):
        b = _world()
        _pods(b, 8, poison_idx={0})
        b.run()
        t = b.sched["torch"]
        assert t.queue.quarantine_count() == 1
        d0 = t.poison_backoff.get("p0")
        # past the deadline the pod re-probes: still poisoned, it is
        # re-convicted with a doubled deadline (capped)
        b.advance(t.poison_backoff.initial + 0.1)
        b.run()
        check_faults(b, POINTS)
        assert t.queue.quarantine_count() == 1
        assert t.metrics.poison_pods.value(reason="featurize") == 2
        assert t.poison_backoff.get("p0") >= d0
        assert t.metrics.pending_pods.value(queue="quarantine") == 1
        _unblamed(b)

    def test_spec_fix_releases_and_recovers(self):
        b = _world()
        _pods(b, 8, poison_idx={0})
        b.run()
        _fix(b, "p0")
        t = b.sched["torch"]
        assert t.queue.quarantine_count() == 0
        assert b.run() == 1
        check_faults(b, POINTS)
        assert _placed(b)["p0"]
        # a successful bind clears the poison ladder
        assert t.poison_backoff.get("p0") == t.poison_backoff.initial

    def test_lost_conviction_degrades_to_backoff_park(self):
        """queue.quarantine dropped: the pod still leaves the wave on a
        plain backoff park, and scheduling goes on."""
        b = _world()
        _pods(b, 8, poison_idx={0})
        arm("queue.quarantine", "drop")
        assert b.run() == 7
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.queue.quarantine_count() == 0
        assert (t.queue.unschedulable_count()
                + t.queue.backoff_count()) >= 1
        _unblamed(b)


# -- the degraded (breaker-open) path --------------------------------------------


class TestDegradedPoison:
    def test_twin_path_convicts_and_places_innocents(self):
        b = _world()
        _pods(b, WAVE)
        arm("wave.poison", "corrupt", make=_poison_fn("p9", "nan"))
        for s in b.sched.values():
            s.breaker.record_hang()  # wedge-tripped: OPEN
        assert b.run() == WAVE - 1
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.queue.quarantined_pods()[0].uid == "p9"
        assert t.metrics.poison_pods.value(reason="sentinel") == 1
        assert t.wave_path() == "host"


# -- the queue ------------------------------------------------------------------


class TestQuarantineQueue:
    def _pod(self, i=0):
        return plain_pod(TORCH, f"qq{i}", cpu="100m")

    def test_area_isolated_from_flushes(self):
        clock = FakeClock()
        q = SchedulingQueue(clock=clock)
        p = self._pod()
        q.add(p)
        assert q.quarantine(p, until=clock() + 30.0)
        assert q.active_count() == 0
        assert q.quarantine_count() == 1
        assert q.pending_count() == 1
        # event-driven flushes must NOT resurrect a convicted pod
        q.move_all_to_active()
        q.assigned_pod_added(self._pod(1))
        assert q.active_count() == 0
        # re-adds are no-ops while quarantined
        q.add_if_not_present(p)
        q.add_unschedulable_if_not_present(p)
        q.add(p)
        assert q.quarantine_count() == 1 and q.active_count() == 0
        # the re-probe deadline releases it into the active heap
        clock.advance(30.1)
        assert q.active_count() == 1
        assert q.quarantine_count() == 0
        assert q.pop_wave(4)[0].uid == p.uid

    def test_delete_cleans_up(self):
        clock = FakeClock()
        q = SchedulingQueue(clock=clock)
        p1, p2 = self._pod(1), self._pod(2)
        for p in (p1, p2):
            q.add(p)
            q.quarantine(p, until=clock() + 30.0)
        q.delete(p1)
        q.delete(p2)
        assert q.quarantine_count() == 0
        clock.advance(60.0)
        assert q.active_count() == 0

    def test_status_only_update_stays_quarantined(self):
        clock = FakeClock()
        q = SchedulingQueue(clock=clock)
        p = poisoned(self._pod())
        q.add(p)
        q.quarantine(p, until=clock() + 30.0)
        newer = copy.deepcopy(p)
        newer.metadata.resource_version += 1
        newer.status.conditions = [("PodScheduled", "False:poisoned")]
        q.update(p, newer)
        assert q.quarantine_count() == 1  # NaN-tolerant: no release
        fixed = copy.deepcopy(newer)
        fixed.spec.containers[0].resources.requests["cpu"] = 200
        q.update(newer, fixed)
        assert q.quarantine_count() == 0  # a spec edit releases at once
        assert q.active_count() == 1
