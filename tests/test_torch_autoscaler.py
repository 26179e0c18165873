"""The port's cluster autoscaler (kubernetes_tpu_torch/controllers/
clusterautoscaler.py over ops/simulate.py) against the JAX package's, in
lockstep on the CPU.

Every scenario runs in both packages at once (`CA`): the same store
writes, the same fake clocks, each package's own Scheduler, FakeCloud
and ClusterAutoscaler. After every step the two must agree bit for bit:
run_once results, the scale-up verdict (`chosen` and `feasible`, element
for element, and n_real), group sizes and instances, last_scale_up /
last_scale_down, the events, the nodes (cordons, drain annotations),
the bindings, the autoscaler series and the scheduler series of
tests/torch_parity.py. The scenarios mirror tests/test_autoscaler.py's
TestScaleUp, TestBoundsAndCooldown and TestScaleDown, plus a tainted
template, a failing cloud (FakeCloud.fail_next, and the `cloud.resize`
fault point, in both packages), the `autoscaler.simulate` fault point,
the what-ifs on the numpy twin while the scheduler's breaker is OPEN and
the shadow's isolation from the live snapshot. The ReplicaSet controller is not
ported: drained replicas are re-created by the test, as it would.
"""

import copy

import numpy as np
import pytest
import torch

from kubernetes_tpu.cloud import provider as jcloud
from kubernetes_tpu.controllers import clusterautoscaler as jca
from kubernetes_tpu.ops import encoding as jenc
from kubernetes_tpu.ops import simulate as jsim
from kubernetes_tpu.runtime.store import ObjectStore as JaxStore
from kubernetes_tpu.sched import scheduler as jsched
from kubernetes_tpu_torch.cloud import provider as tcloud
from kubernetes_tpu_torch.controllers import clusterautoscaler as tca
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import simulate as tsim
from kubernetes_tpu_torch.runtime.store import ObjectStore as TorchStore
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TorchScheduler

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import SCHED_CAPS, arm, metric_state
from torch_worlds import FakeClock, _mods, bindings

SIDES = ("jax", "torch")
PKG = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}
CLOUD = {"jax": jcloud, "torch": tcloud}
CA_MOD = {"jax": jca, "torch": tca}
SIM = {"jax": jsim, "torch": tsim}
BATCH = [{"key": "dedicated", "operator": "Equal", "value": "batch",
          "effect": "NoSchedule"}]


def mk_node(pkg, name, cpu="4", taints=()):
    """A Ready node (tests/helpers.py make_node) in either package."""
    api, _ = _mods(pkg)
    alloc = api.resource_list(cpu=cpu, memory="8Gi", pods=110,
                              ephemeral_storage="100Gi")
    return api.Node(
        metadata=api.ObjectMeta(name=name, uid=f"node-{name}"),
        spec=api.NodeSpec(taints=[api.Taint(**t) for t in taints]),
        status=api.NodeStatus(
            capacity=dict(alloc), allocatable=alloc,
            conditions=[api.NodeCondition(api.NODE_READY, api.COND_TRUE)]))


def mk_pod(pkg, name, cpu="1", owner="", labels=None, tolerations=(),
           node_name=""):
    """A pod (tests/helpers.py make_pod) in either package; owner names
    its controlling ReplicaSet (a replicated pod), none makes it bare."""
    api, _ = _mods(pkg)
    owners = ([api.OwnerReference(kind="ReplicaSet", name=owner, uid=owner,
                                  controller=True)] if owner else [])
    return api.Pod(
        metadata=api.ObjectMeta(name=name, uid=name, labels=dict(labels or {}),
                                owner_references=owners),
        spec=api.PodSpec(
            node_name=node_name,
            tolerations=[api.Toleration(**t) for t in tolerations],
            containers=[api.Container(
                name="c", resources=api.ResourceRequirements(
                    requests=api.resource_list(cpu=cpu, memory="64Mi")))]))


def events(store):
    return [(e.metadata.name, e.involved_kind, e.involved_name, e.reason,
             e.message, e.type, e.count) for e in store.list("events")]


def nodes(store):
    return {n.metadata.name: (n.spec.unschedulable,
                              dict(n.metadata.annotations or {}),
                              dict(n.metadata.labels or {}))
            for n in store.list("nodes")}


def groups(cloud):
    return [(g.name, g.target_size, g.min_size, g.max_size)
            for g in cloud.groups()]


class CA:
    """One autoscaler scenario driven through both packages in lockstep.
    `check()` runs after every step that changes anything."""

    def __init__(self, n_nodes=0, node_cpu="4", joiner=True):
        self.clock = {s: FakeClock() for s in SIDES}
        self.store = {"jax": JaxStore(), "torch": TorchStore()}
        self.sched = {
            "jax": jsched.Scheduler(self.store["jax"], wave_size=16,
                                    clock=self.clock["jax"],
                                    caps=jenc.Caps(**SCHED_CAPS)),
            "torch": TorchScheduler(self.store["torch"], wave_size=16,
                                    clock=self.clock["torch"], device="cpu",
                                    caps=tenc.Caps(**SCHED_CAPS)),
        }
        self.cloud = {s: CLOUD[s].FakeCloud() for s in SIDES}
        if joiner:
            for s in SIDES:
                self.cloud[s].joiner = (
                    lambda g, name, s=s: self.store[s].create(
                        "nodes", CLOUD[s].node_from_template(g, name)))
        self.ca = {}
        for i in range(n_nodes):
            self.node(f"n{i}", cpu=node_cpu)

    def node(self, name, **kw):
        for s in SIDES:
            self.store[s].create("nodes", mk_node(PKG[s], name, **kw))

    def pod(self, name, **kw):
        for s in SIDES:
            self.store[s].create("pods", mk_pod(PKG[s], name, **kw))

    def delete_pod(self, name):
        for s in SIDES:
            self.store[s].delete("pods", "default", name)

    def group(self, name, cpu, taints=(), **kw):
        """A node group in both clouds whose template is a `cpu`-core
        node; returns the torch side's NodeGroup."""
        out = {s: self.cloud[s].add_node_group(
            name, mk_node(PKG[s], f"t-{name}", cpu=cpu, taints=taints), **kw)
            for s in SIDES}
        return out["torch"]

    def grow(self, name, delta):
        for s in SIDES:
            self.cloud[s].increase_size(name, delta)

    def autoscaler(self, **kw):
        for s in SIDES:
            self.ca[s] = CA_MOD[s].ClusterAutoscaler(
                self.store[s], self.cloud[s], self.sched[s],
                clock=self.clock[s], **kw)

    def fail_next(self, call):
        for s in SIDES:
            self.cloud[s].fail_next[call] = RuntimeError(f"{call} refused")

    def advance(self, d):
        for c in self.clock.values():
            c.advance(d)

    def drain(self):
        got = {s: self.sched[s].schedule_pending() for s in SIDES}
        assert got["jax"] == got["torch"], got
        self.check()
        return got["torch"]

    def run_once(self):
        got = {s: self.ca[s].run_once() for s in SIDES}
        assert got["torch"] == got["jax"], got
        self.check()
        return got["torch"]

    def check(self):
        j, t = self.store["jax"], self.store["torch"]
        assert bindings(t) == bindings(j)
        assert nodes(t) == nodes(j)
        assert events(t) == events(j)
        assert groups(self.cloud["torch"]) == groups(self.cloud["jax"])
        assert (sorted(self.cloud["torch"].instances_by_name)
                == sorted(self.cloud["jax"].instances_by_name))
        assert self.cloud["torch"].calls == self.cloud["jax"].calls
        js, ts = self.sched["jax"], self.sched["torch"]
        assert ts.queue.pending_count() == js.queue.pending_count()
        assert metric_state(ts.metrics) == metric_state(js.metrics)
        for name in ("autoscaler_scale_ups", "autoscaler_scale_downs"):
            assert (getattr(ts.metrics, name).value
                    == getattr(js.metrics, name).value)
        if self.ca:
            jc, tc = self.ca["jax"], self.ca["torch"]
            assert tc.last_scale_up == jc.last_scale_up
            assert tc.last_scale_down == jc.last_scale_down
            jv, tv = jc.last_verdict, tc.last_verdict
            assert (jv is None) == (tv is None)
            if tv is not None:
                assert tv.n_real == jv.n_real
                for f in ("chosen", "feasible"):
                    a, b = getattr(jv, f), getattr(tv, f)
                    assert a.dtype == b.dtype and a.shape == b.shape, f
                    np.testing.assert_array_equal(a, b, err_msg=f)

    @property
    def t(self):
        """The torch side's (store, scheduler, cloud, autoscaler)."""
        return (self.store["torch"], self.sched["torch"],
                self.cloud["torch"], self.ca.get("torch"))


class TestScaleUp:
    def test_scale_up_e2e_device_verdict(self):
        """Unschedulable pods -> the group whose template hosts them ->
        nodes join -> pods placed; the verdict's helped rows are virtual
        and no real row is feasible for them."""
        w = CA(2, node_cpu="2")
        small = w.group("small", "2", max_size=4, price=1.0)
        big = w.group("big", "8", max_size=4, price=3.0)
        w.autoscaler()
        for i in range(3):
            w.pod(f"p{i}", cpu="3")
        assert w.drain() == 0
        r = w.run_once()
        assert 1 <= r["scaled_up"] <= 3
        assert big.target_size == r["scaled_up"] and small.target_size == 0
        v = w.t[3].last_verdict
        assert v.n_real == 2 and (v.chosen[:3] >= v.n_real).all()
        assert not v.feasible[:3, :v.n_real].any()
        assert sum(e[3] == "TriggeredScaleUp"
                   for e in events(w.t[0])) == 3
        w.advance(2.0)
        assert w.drain() == 3
        assert all(n.startswith("big-") for n in bindings(w.t[0]).values())

    def test_tainted_template_hosts_only_tolerating_pods(self):
        """A tainted template's virtual rows are infeasible for pods
        without the toleration: those buy the untainted group, the
        tolerating ones the cheaper-per-pod tainted group."""
        w = CA(1, node_cpu="1")
        w.group("std", "4", max_size=8, price=1.0)
        w.group("batch", "16", max_size=8, price=2.0,
                taints=[{"key": "dedicated", "value": "batch",
                         "effect": "NoSchedule"}])
        w.autoscaler()
        for i in range(6):
            w.pod(f"tol{i}", cpu="3", owner="rs-a", tolerations=BATCH)
        for i in range(3):
            w.pod(f"plain{i}", cpu="3", owner="rs-b")
        assert w.drain() == 0
        for _ in range(4):
            w.run_once()
            w.advance(11.0)
            w.drain()
        placed = bindings(w.t[0])
        assert all(placed.values())
        assert all(placed[f"plain{i}"].startswith("std-") for i in range(3))

    def test_no_scale_up_when_pods_fit_nowhere(self):
        w = CA(1, node_cpu="1")
        grp = w.group("small", "2", max_size=4)
        w.autoscaler()
        w.pod("huge", cpu="64")
        assert w.drain() == 0
        assert w.run_once()["scaled_up"] == 0 and grp.target_size == 0

    def test_no_scale_up_for_pod_with_a_real_home(self):
        """A pod parked although a real node fits it buys no machines."""
        w = CA(1, node_cpu="4")
        grp = w.group("g", "4", max_size=4)
        w.autoscaler()
        for s in SIDES:
            sched = w.sched[s]
            sched.queue.add(mk_pod(PKG[s], "fits", cpu="1"))
            sched._park_with_backoff(sched.queue.pop_wave(16)[0])
        assert w.run_once()["scaled_up"] == 0 and grp.target_size == 0

    def test_a_real_home_wins_over_a_better_virtual_row(self):
        """The wave scores an empty virtual node above the nearly full
        real one, but the real row is feasible: the pod buys nothing
        (the verdict's feasible[:, :n_real] rule)."""
        w = CA(1, node_cpu="4")
        grp = w.group("g", "8", max_size=4)
        w.autoscaler()
        w.pod("resident", cpu="3", owner="rs-x", node_name="n0")
        for s in SIDES:
            sched = w.sched[s]
            sched.queue.add(mk_pod(PKG[s], "fits", cpu="1"))
            sched._park_with_backoff(sched.queue.pop_wave(16)[0])
        assert w.run_once()["scaled_up"] == 0 and grp.target_size == 0
        v = w.t[3].last_verdict
        assert v.chosen[0] >= v.n_real and v.feasible[0, :v.n_real].all()

    def test_pick_expansion_prefers_helped_then_price(self):
        for s in SIDES:
            t = mk_node(PKG[s], "t")
            a = CLOUD[s].NodeGroup("a", t, price=5.0)
            b = CLOUD[s].NodeGroup("b", t, price=1.0)
            pick = CA_MOD[s].pick_expansion
            g, n = pick([(a, 4, 2), (b, 2, 1)])
            assert (g.name, n) == ("a", 2)
            assert pick([(a, 3, 1), (b, 3, 2)])[0].name == "b"
            assert pick([(a, 0, 0)]) is None


class TestBoundsAndCooldown:
    def test_max_bound_clamps_and_cooldown_blocks(self):
        w = CA(1, node_cpu="1", joiner=False)
        grp = w.group("g", "8", max_size=1)
        w.autoscaler(scale_up_cooldown=10.0)
        for i in range(5):
            w.pod(f"p{i}", cpu="2")
        assert w.drain() == 0
        assert w.run_once()["scaled_up"] == 1 and grp.target_size == 1
        assert w.run_once()["scaled_up"] == 0
        w.advance(11.0)
        assert w.run_once()["scaled_up"] == 0 and grp.target_size == 1

    def test_min_bound_blocks_scale_down(self):
        w = CA(0)
        grp = w.group("g", "4", min_size=1, max_size=4)
        w.grow("g", 1)
        w.autoscaler(utilization_threshold=0.5)
        w.advance(100.0)
        assert w.run_once()["scaled_down"] == 0 and grp.target_size == 1
        for s in SIDES:
            w.cloud[s].groups_by_name["g"].min_size = 0
        assert w.run_once()["scaled_down"] == 1 and grp.target_size == 0
        assert w.t[0].list("nodes") == []

    def test_failed_increase_backs_off_and_never_doubles(self):
        """increase_size raising mutates nothing; the group backs off, so
        the next pass inside the backoff makes no call, and the pass
        after it resizes once."""
        w = CA(2, node_cpu="2")
        big = w.group("big", "8", max_size=4)
        w.autoscaler()
        for i in range(3):
            w.pod(f"p{i}", cpu="3")
        assert w.drain() == 0
        w.fail_next("increase-size")
        assert w.run_once()["scaled_up"] == 0
        assert big.target_size == 0 and not w.t[2].instances_by_name
        calls = len(w.t[2].calls)
        assert w.run_once()["scaled_up"] == 0
        assert len(w.t[2].calls) == calls
        assert w.sched["torch"].metrics.scheduling_errors.value(
            stage="autoscaler") == 1
        w.advance(1.1)
        first = w.run_once()["scaled_up"]
        assert first >= 1 and big.target_size == first
        w.advance(2.0)
        assert w.drain() == 3
        assert big.target_size == first


class TestFaultSeams:
    def test_cloud_resize_fault_backs_off_and_never_doubles(self):
        """cloud.resize raising once (before FakeCloud mutates anything):
        the group backs off as with fail_next, then resizes once."""
        from kubernetes_tpu_torch.utils import faultpoints as tfp

        w = CA(2, node_cpu="2")
        big = w.group("big", "8", max_size=4)
        w.autoscaler()
        for i in range(3):
            w.pod(f"p{i}", cpu="3")
        assert w.drain() == 0
        arm("cloud.resize", times=1)
        assert w.run_once()["scaled_up"] == 0
        assert big.target_size == 0 and not w.t[2].instances_by_name
        assert tfp.hits("cloud.resize") == 1
        w.advance(1.1)
        first = w.run_once()["scaled_up"]
        assert first >= 1 and big.target_size == first

    def test_autoscaler_simulate_fault_skips_the_pass(self):
        """autoscaler.simulate raising once: the what-if pass is skipped
        (counted on scheduling_errors{stage=autoscaler}), nothing is
        bought; the next pass scales up."""
        w = CA(2, node_cpu="2")
        big = w.group("big", "8", max_size=4)
        w.autoscaler()
        for i in range(3):
            w.pod(f"p{i}", cpu="3")
        assert w.drain() == 0
        arm("autoscaler.simulate", times=1)
        assert w.run_once()["scaled_up"] == 0
        assert big.target_size == 0
        assert w.sched["torch"].metrics.scheduling_errors.value(
            stage="autoscaler") == 1
        assert w.run_once()["scaled_up"] >= 1

    def test_open_breaker_runs_the_what_ifs_on_the_twin(self):
        """With both schedulers' breakers OPEN the autoscaler takes
        backend="host": its scale-up verdict and resize equal the JAX
        package's, and the joined nodes host the pods."""
        w = CA(2, node_cpu="2")
        big = w.group("big", "8", max_size=4)
        w.autoscaler()
        for i in range(3):
            w.pod(f"p{i}", cpu="3")
        assert w.drain() == 0
        for s in SIDES:
            w.sched[s].breaker.record_hang()
        assert w.ca["torch"]._simulate_backend(False) == "host"
        r = w.run_once()
        assert r["scaled_up"] >= 1 and big.target_size == r["scaled_up"]
        v = w.t[3].last_verdict
        assert v.n_real == 2 and (v.chosen[:3] >= v.n_real).all()
        w.advance(2.0)
        assert w.drain() == 3


class TestScaleDown:
    def _replicas(self, w, n, cpu="1", prefix="r"):
        for i in range(n):
            w.pod(f"{prefix}{i}", cpu=cpu, owner="rs1",
                  labels={"app": "w"})

    def test_scale_down_e2e_refit_cordon_drain_delete(self):
        w = CA(0)
        grp = w.group("small", "4", max_size=10)
        w.grow("small", 3)
        w.autoscaler(utilization_threshold=0.6)
        self._replicas(w, 4)
        assert w.drain() == 4
        store, sched, cloud, ca = w.t
        assert w.run_once()["scaled_down"] == 1
        removed = ca.last_scale_down
        assert grp.target_size == 2 and removed not in cloud.instances_by_name
        assert store.get("nodes", "default", removed) is None
        # the removed row: out of the live index, invalid in the next
        # upload, and no pod left on it in the cache
        assert removed not in sched.snapshot.node_index
        assert removed not in sched.cache.node_infos
        valid = sched.snapshot.to_device("cpu")[0].valid
        assert int(valid.sum()) == 2
        # the ReplicaSet re-creates what the drain deleted
        gone = [f"r{i}" for i in range(4)
                if f"r{i}" not in bindings(store)]
        for k, name in enumerate(gone):
            w.pod(f"{name}-again{k}", cpu="1", owner="rs1",
                  labels={"app": "w"})
        w.advance(2.0)
        w.drain()
        placed = bindings(store)
        assert len(placed) == 4 and all(placed.values())
        assert removed not in placed.values()

    def test_refit_failure_keeps_the_node(self):
        w = CA(0)
        grp = w.group("g", "4", max_size=4)
        w.grow("g", 2)
        w.autoscaler(utilization_threshold=0.9)
        for i in range(2):
            w.pod(f"p{i}", cpu="3", owner="rs-x")
        assert w.drain() == 2
        assert w.run_once()["scaled_down"] == 0
        assert grp.target_size == 2
        assert not any(u for u, _, _ in nodes(w.t[0]).values())

    def test_bare_pod_pins_the_node(self):
        w = CA(0)
        w.group("g", "8", max_size=4)
        w.grow("g", 2)
        w.autoscaler(utilization_threshold=0.9)
        w.pod("bare", cpu="1")
        assert w.drain() == 1
        w.advance(100.0)
        for _ in range(3):
            w.run_once()
            w.advance(100.0)
        assert bindings(w.t[0])["bare"]
        assert len(w.t[0].list("nodes")) == 1

    def test_pdb_exhausted_pins_the_node(self):
        w = CA(0)
        w.group("g", "8", max_size=4)
        w.grow("g", 2)
        w.autoscaler(utilization_threshold=0.9)
        w.pod("guarded", cpu="1", owner="rs-x", labels={"app": "w"})
        assert w.drain() == 1
        for s in SIDES:
            api, lbl = _mods(PKG[s])
            w.store[s].create("poddisruptionbudgets", api.PodDisruptionBudget(
                metadata=api.ObjectMeta(name="pdb"),
                selector=lbl.LabelSelector(match_labels={"app": "w"}),
                disruptions_allowed=0))
        w.advance(100.0)
        for _ in range(3):
            w.run_once()
            w.advance(100.0)
        assert bindings(w.t[0])["guarded"]
        assert len(w.t[0].list("nodes")) == 1

    def test_late_binding_pod_aborts_the_drain(self):
        """A pod bound to the candidate between the refit proof and the
        cordon was never proved: the drain aborts and uncordons. The
        bind lands inside that window from a wrapper around each
        package's simulate_refit (the reference drives it through its
        `autoscaler.simulate` fault point, which the port lacks)."""
        w = CA(0)
        w.group("g", "8", max_size=4)
        w.grow("g", 1)
        gnode = w.t[0].list("nodes")[0].name
        w.node("spare", cpu="16")
        w.pod("resident", cpu="1", owner="rs-x", node_name=gnode)
        w.autoscaler(utilization_threshold=0.9)
        w.advance(100.0)
        saved = {s: SIM[s].simulate_refit for s in SIDES}

        def late(s):
            def refit(*a, **kw):
                w.store[s].create("pods", mk_pod(PKG[s], "latecomer",
                                                 owner="rs-y"))
                w.store[s].bind(w.store[s].get("pods", "default",
                                               "latecomer"), gnode)
                SIM[s].simulate_refit = saved[s]
                return saved[s](*a, **kw)
            return refit

        try:
            for s in SIDES:
                SIM[s].simulate_refit = late(s)
            assert w.run_once()["scaled_down"] == 0
        finally:
            for s in SIDES:
                SIM[s].simulate_refit = saved[s]
        unsched, ann, _ = nodes(w.t[0])[gnode]
        assert not unsched and tca.ANN_SCALE_DOWN not in ann
        assert bindings(w.t[0])["latecomer"] == gnode

    def test_resumed_drain_aborts_when_refit_no_longer_holds(self):
        w = CA(0)
        w.group("g", "8", max_size=4)
        w.grow("g", 1)
        name = w.t[0].list("nodes")[0].name
        w.pod("resident", cpu="4", owner="rs-x")
        assert w.drain() == 1
        for s in SIDES:
            node = w.store[s].get("nodes", "default", name)
            node.spec.unschedulable = True
            node.metadata.annotations[CA_MOD[s].ANN_SCALE_DOWN] = "true"
            w.store[s].update("nodes", node)
        w.autoscaler()
        w.advance(100.0)
        assert w.run_once()["scaled_down"] == 0
        unsched, ann, _ = nodes(w.t[0])[name]
        assert not unsched and tca.ANN_SCALE_DOWN not in ann
        assert bindings(w.t[0])["resident"] == name

    def test_failed_delete_stays_cordoned_then_resumes_after_restart(self):
        """delete_nodes raising after the cordon leaves the node present
        and cordoned with its drain annotation; inside the backoff no
        retry; a fresh autoscaler (a restart) resumes and removes it; a
        cordon the autoscaler did not place stays hands-off."""
        w = CA(0)
        grp = w.group("g", "4", max_size=4)
        w.grow("g", 2)
        w.autoscaler(utilization_threshold=0.5)
        w.advance(100.0)
        w.fail_next("delete-nodes")
        assert w.run_once()["scaled_down"] == 0
        assert grp.target_size == 2
        assert sum(u for u, _, _ in nodes(w.t[0]).values()) == 1
        assert w.run_once()["scaled_down"] == 0
        w.advance(1.1)
        w.autoscaler(utilization_threshold=0.5)  # the restart
        assert w.run_once()["scaled_down"] == 1
        assert grp.target_size == 1 and len(w.t[0].list("nodes")) == 1
        for s in SIDES:
            survivor = w.store[s].list("nodes")[0]
            survivor.spec.unschedulable = True
            w.store[s].update("nodes", survivor)
        w.advance(100.0)
        assert w.run_once()["scaled_down"] == 0


def test_what_if_leaves_the_live_snapshot_alone():
    """A scale-up what-if builds its own tensors, and its virtual rows
    grow the shadow's node bucket past the live one: the live snapshot's
    upload, caps, device cache and row-delta state are the same before
    and after it, so the next live round uploads only what changed.
    (No joiner: the joins would rightly mark new live rows.)"""
    w = CA(10, node_cpu="2", joiner=False)
    w.group("big", "8", max_size=8)
    w.autoscaler()
    for i in range(8):
        w.pod(f"p{i}", cpu="3")
    assert w.drain() == 0
    _, sched, _, ca = w.t
    snap = sched.snapshot
    before = [t.clone() for tup in snap.to_device("cpu") for t in tup]
    state = (copy.deepcopy(snap._dirty_rows), snap.dirty_resources,
             snap.dirty_topology, snap.dirty_pods, snap.upload_bytes_total,
             dict(vars(snap.caps)))
    cache_ids = {k: id(v) for k, v in snap._device_cache.items()}
    assert w.run_once()["scaled_up"] >= 1
    assert ca.last_verdict.n_real == 10
    assert ca.last_verdict.feasible.shape[1] == 32 and snap.caps.N == 16
    assert (snap._dirty_rows, snap.dirty_resources, snap.dirty_topology,
            snap.dirty_pods, snap.upload_bytes_total,
            dict(vars(snap.caps))) == state
    assert {k: id(v) for k, v in snap._device_cache.items()} == cache_ids
    after = [t for tup in snap.to_device("cpu") for t in tup]
    # bit for bit (label_nums holds NaN, which torch.equal never equals)
    assert [a.numpy().tobytes() for a in before] == [
        b.numpy().tobytes() for b in after]
    assert snap.upload_bytes_total == state[4]


def test_host_backend_is_not_ported():
    """backend="host" no longer raises NotImplementedError: it runs the
    numpy twin (ops/hostwave.py), the JAX package's OPEN-breaker branch,
    and both what-ifs answer as the JAX package's host backend does on
    the same cluster."""
    w = CA(3, node_cpu="2")
    w.group("big", "8", max_size=4)
    for i in range(3):
        w.pod(f"p{i}", cpu="3")
    assert w.drain() == 0
    got = {}
    for s in SIDES:
        sched = w.sched[s]
        pending = sched.pending_unschedulable()
        shadow, n_real = SIM[s].shadow_snapshot(sched.cache, sched.snapshot)
        pb = sched.shadow_featurizer(shadow).featurize(pending)
        kw = dict(weights=sched.profile.weights(), num_zones=shadow.caps.Z,
                  num_label_values=shadow.num_label_values,
                  backend="host")
        v = SIM[s].simulate_placements(shadow, pb, **kw)
        ok, chosen = SIM[s].simulate_refit(shadow, pb, 1, **kw)
        got[s] = (v.chosen, v.feasible, ok, chosen)
    for a, b in zip(got["jax"], got["torch"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_capacity_errors_of_the_card_are_classified():
    """The breaker copy's is_capacity_error sees a CUDA out-of-memory
    error as a capacity fault, raised bare or wrapped."""
    from kubernetes_tpu.sched import breaker as jbreaker
    from kubernetes_tpu_torch.sched import breaker as tbreaker

    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)")
    try:
        try:
            raise oom
        except RuntimeError as e:
            raise RuntimeError("wave dispatch failed") from e
    except RuntimeError as wrapped:
        by_cause = wrapped
    try:
        try:
            raise oom
        except RuntimeError:
            raise ValueError("while staging the round")
    except ValueError as wrapped:
        by_context = wrapped
    for exc in (oom, by_cause, by_context):
        assert tbreaker.is_capacity_error(exc)
        assert tbreaker.is_capacity_error(exc) == jbreaker.is_capacity_error(exc)
    assert not tbreaker.is_capacity_error(RuntimeError("CUDA error: "
                                                       "device-side assert"))
    assert tbreaker.is_capacity_error(tbreaker.ResourceExhausted("x"))
    assert tbreaker.is_capacity_error(MemoryError())
