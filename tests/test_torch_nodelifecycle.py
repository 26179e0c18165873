"""The port's node-lifecycle controller (kubernetes_tpu_torch/controllers/
nodelifecycle.py over ops/zonehealth.py) against the JAX package's, in
lockstep on the CPU.

Every scenario runs in both packages at once (`NL`): the same store
writes, the same clock, each package's own NodeLifecycleController (the
port's with device="cpu"). After every monitor pass the two must agree
exactly: the zone states, every node's Ready condition and taints, the
pods left, the events, the eviction counters, the due-but-held queue and
the zone series. The scenarios mirror tests/test_controllers.py
TestNodeLifecycle and the zone cases of tests/test_partition.py: a full
zone partition, partial ones in a large and a small zone, a zone whose
size crosses the large-cluster threshold, the 300 s default toleration
and a short blip (the tolerations DefaultTolerationSeconds admits are
set on the pods here: the admission chain is not ported). A scheduler
on each store then places pods around the controller's NoExecute
taints. The zone tally itself is held to both JAX forms over seeded
columns, and an open breaker sends it to the host, counted. The fault
points `nodelifecycle.tally` and `nodelifecycle.evict` are armed alike
in both packages (their hits compared).
"""

import numpy as np
import pytest

from kubernetes_tpu.controllers import nodelifecycle as jnl
from kubernetes_tpu.ops import encoding as jenc
from kubernetes_tpu.ops import zonehealth as jzh
from kubernetes_tpu.runtime.store import ObjectStore as JaxStore
from kubernetes_tpu.sched import scheduler as jsched
from kubernetes_tpu_torch.controllers import nodelifecycle as tnl
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import zonehealth as tzh
from kubernetes_tpu_torch.runtime.store import ObjectStore as TorchStore
from kubernetes_tpu_torch.sched import breaker as tbreaker
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TorchScheduler

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import SCHED_CAPS, arm
from torch_worlds import _mods, bindings

SIDES = ("jax", "torch")
PKG = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}
NLMOD = {"jax": jnl, "torch": tnl}
HB = tnl.HEARTBEAT_ANNOTATION
ZA = ":\x00:zone-a"


def mk_node(pkg, name, zone=None, hb=None, ready=True):
    """tests/test_controllers.py mknode / test_partition.py zone_node in
    either package."""
    api, _ = _mods(pkg)
    labels = {api.LABEL_ZONE: zone} if zone is not None else {}
    return api.Node(
        metadata=api.ObjectMeta(
            name=name, uid=f"node-{name}", labels=labels,
            annotations={HB: str(hb)} if hb is not None else {}),
        status=api.NodeStatus(
            allocatable=api.resource_list(cpu="8", memory="16Gi", pods=110),
            conditions=[api.NodeCondition(
                api.NODE_READY, api.COND_TRUE if ready else api.COND_FALSE)]))


def mk_pod(pkg, name, node_name="", wait=None, tolerations=()):
    """A pod in either package; wait=S gives it the NoExecute
    not-ready/unreachable tolerations of S seconds that the
    DefaultTolerationSeconds admission plugin stamps (wait=300)."""
    api, _ = _mods(pkg)
    tols = [api.Toleration(**t) for t in tolerations]
    if wait is not None:
        tols += [api.Toleration(key=k, operator="Exists",
                                effect=api.NO_EXECUTE, toleration_seconds=wait)
                 for k in (tnl.TAINT_NOT_READY, tnl.TAINT_UNREACHABLE)]
    return api.Pod(
        metadata=api.ObjectMeta(name=name, uid=name),
        spec=api.PodSpec(
            node_name=node_name, tolerations=tols,
            containers=[api.Container(
                name="c", resources=api.ResourceRequirements(
                    requests=api.resource_list(cpu="1", memory="64Mi")))]))


def family(m):
    return {c.name: c.value for c in m.children()}


def node_state(store):
    return {n.metadata.name: (
        sorted((t.key, t.effect) for t in n.spec.taints),
        [(c.type, c.status) for c in n.status.conditions],
        (n.metadata.annotations or {}).get(HB))
        for n in store.list("nodes")}


def events(store):
    return [(e.metadata.name, e.involved_kind, e.involved_name, e.reason,
             e.message, e.type, e.count) for e in store.list("events")]


class NL:
    """One node-lifecycle scenario in both packages in lockstep; with
    scheduler=True a Scheduler watches each store too."""

    def __init__(self, scheduler=False, **kw):
        self.now = 1000.0
        clock = lambda: self.now  # noqa: E731
        self.store = {"jax": JaxStore(), "torch": TorchStore()}
        self.ctrl = {
            "jax": jnl.NodeLifecycleController(self.store["jax"], clock=clock,
                                               **kw),
            "torch": tnl.NodeLifecycleController(self.store["torch"],
                                                 clock=clock, device="cpu",
                                                 **kw),
        }
        self.sched = {}
        if scheduler:
            self.sched = {
                "jax": jsched.Scheduler(self.store["jax"], wave_size=16,
                                        clock=clock,
                                        caps=jenc.Caps(**SCHED_CAPS)),
                "torch": TorchScheduler(self.store["torch"], wave_size=16,
                                        clock=clock, device="cpu",
                                        caps=tenc.Caps(**SCHED_CAPS)),
            }

    def node(self, name, zone=None, ready=True, hb=True):
        for s in SIDES:
            self.store[s].create("nodes", mk_node(
                PKG[s], name, zone, self.now if hb else None, ready))

    def pod(self, name, **kw):
        for s in SIDES:
            self.store[s].create("pods", mk_pod(PKG[s], name, **kw))

    def refresh(self, names, ready=True):
        """kubelet heartbeats: bump the annotation (and Ready=True)."""
        for s in SIDES:
            api, _ = _mods(PKG[s])
            for name in names:
                n = self.store[s].get("nodes", "default", name)
                n.metadata.annotations = dict(n.metadata.annotations or {})
                n.metadata.annotations[HB] = str(self.now)
                if ready:
                    n.status.conditions = [
                        c for c in n.status.conditions
                        if c.type != api.NODE_READY
                    ] + [api.NodeCondition(api.NODE_READY, api.COND_TRUE)]
                self.store[s].update("nodes", n)

    def monitor(self):
        for s in SIDES:
            self.ctrl[s].monitor()
        self.check()

    def drain(self):
        got = {s: self.sched[s].schedule_pending() for s in SIDES}
        assert got["jax"] == got["torch"], got
        self.check()
        return got["torch"]

    def check(self):
        j, t = self.store["jax"], self.store["torch"]
        assert node_state(t) == node_state(j)
        assert bindings(t) == bindings(j)
        assert events(t) == events(j)
        jc, tc = self.ctrl["jax"], self.ctrl["torch"]
        assert tc.zone_states == jc.zone_states
        assert tc.evictions == jc.evictions
        assert tc.queue_depth() == jc.queue_depth()
        assert tc._evict_at == jc._evict_at
        for name in ("zone_health", "zone_evictions", "eviction_queue_depth"):
            assert (family(getattr(tc.metrics, name))
                    == family(getattr(jc.metrics, name))), name
        assert (tc.metrics.eviction_suspensions.value
                == jc.metrics.eviction_suspensions.value)

    @property
    def t(self):
        return self.store["torch"], self.ctrl["torch"]

    def alive(self, prefix):
        return sorted(p.metadata.name for p in self.store["torch"].list("pods")
                      if p.metadata.name.startswith(prefix))


class TestNodeLifecycle:
    def test_unreachable_taint_and_eviction(self):
        w = NL(grace_period=40.0)
        w.node("n1")
        w.node("n2")
        w.pod("p1", node_name="n1", tolerations=[dict(
            key=tnl.TAINT_UNREACHABLE, operator="Exists",
            effect="NoExecute", toleration_seconds=30)])
        w.monitor()
        w.now += 100
        w.refresh(["n2"])
        w.monitor()
        assert (tnl.TAINT_UNREACHABLE, "NoExecute") in node_state(
            w.t[0])["n1"][0]
        assert w.alive("p") == ["p1"]
        w.now += 31
        w.refresh(["n2"])
        w.monitor()
        assert w.alive("p") == []

    def test_recovery_removes_taint_and_not_ready_taint(self):
        w = NL()
        w.node("n1")
        w.node("n2", ready=False)
        w.monitor()
        assert node_state(w.t[0])["n2"][0] == [(tnl.TAINT_NOT_READY,
                                                "NoExecute")]
        w.now += 100
        w.monitor()
        w.refresh(["n1", "n2"])
        w.monitor()
        assert all(not s[0] for s in node_state(w.t[0]).values())

    def test_swap_taints_preserves_other_effects(self):
        w = NL()
        for s in SIDES:
            api, _ = _mods(PKG[s])
            node = mk_node(PKG[s], "n1", hb=w.now, ready=False)
            node.spec.taints = [
                api.Taint(key=tnl.TAINT_NOT_READY, effect=api.NO_SCHEDULE),
                api.Taint(key="user/custom", effect=api.NO_EXECUTE)]
            w.store[s].create("nodes", node)
        w.monitor()
        w.refresh(["n1"])
        w.monitor()
        assert node_state(w.t[0])["n1"][0] == sorted([
            (tnl.TAINT_NOT_READY, "NoSchedule"), ("user/custom", "NoExecute")])


class TestZones:
    def test_full_disruption_suspends_then_recovers(self):
        w = NL(grace_period=30.0, eviction_rate_qps=100.0,
               eviction_burst=100.0)
        a = [f"a{i}" for i in range(5)]
        b = [f"b{i}" for i in range(5)]
        for n in a:
            w.node(n, "zone-a")
        for n in b:
            w.node(n, "zone-b")
        for i, n in enumerate(a):
            for j in range(2):
                w.pod(f"w-{i}-{j}", node_name=n)
        w.monitor()
        w.now += 60
        w.refresh(b)
        w.monitor()
        assert w.t[1].zone_states[ZA] == tnl.ZONE_FULL
        for _ in range(30):
            w.now += 10
            w.refresh(b)
            w.monitor()
        assert len(w.alive("w-")) == 10 and w.t[1].queue_depth() == 10
        w.now += 10
        w.refresh(a + b)
        w.monitor()
        assert w.t[1].zone_states[ZA] == tnl.ZONE_NORMAL
        assert len(w.alive("w-")) == 10 and w.t[1].queue_depth() == 0

    def test_minority_partition_drains_at_primary_rate(self):
        w = NL(grace_period=30.0, eviction_rate_qps=0.5, eviction_burst=1.0)
        nodes = [f"n{i}" for i in range(10)]
        for n in nodes:
            w.node(n, "zone-a")
        for i, n in enumerate(nodes[:4]):
            for j in range(2):
                w.pod(f"v-{i}-{j}", node_name=n)
        w.monitor()
        w.now += 31
        t_taint = w.now
        while w.alive("v-") and w.now < t_taint + 60:
            w.refresh(nodes[4:])
            w.monitor()
            evicted = 8 - len(w.alive("v-"))
            assert evicted <= 1.0 + (w.now - t_taint) * 0.5 + 1e-9
            w.now += 1
        assert w.alive("v-") == []
        assert w.t[1].zone_states[ZA] == tnl.ZONE_NORMAL

    @pytest.mark.parametrize("n_nodes,severed,threshold,halted", [
        (12, 8, 10, False),  # a large zone: the secondary rate
        (4, 3, 50, True),  # a small zone: evictions halt
    ])
    def test_partial_disruption(self, n_nodes, severed, threshold, halted):
        w = NL(grace_period=30.0, eviction_rate_qps=100.0,
               secondary_eviction_rate_qps=0.5, eviction_burst=1.0,
               large_cluster_threshold=threshold)
        nodes = [f"n{i}" for i in range(n_nodes)]
        for n in nodes:
            w.node(n, "zone-a")
        for i, n in enumerate(nodes[:severed]):
            w.pod(f"v-{i}", node_name=n)
        w.monitor()
        w.now += 31
        for _ in range(8):
            w.refresh(nodes[severed:])
            w.monitor()
            w.now += 1
        assert w.t[1].zone_states[ZA] == tnl.ZONE_PARTIAL
        gone = severed - len(w.alive("v-"))
        assert gone == 0 if halted else 1 <= gone <= 1 + 8 * 0.5

    def test_partial_zone_crossing_size_threshold_rerates(self):
        w = NL(grace_period=30.0, eviction_rate_qps=100.0,
               secondary_eviction_rate_qps=2.0, eviction_burst=1.0,
               large_cluster_threshold=6)
        nodes = [f"n{i}" for i in range(6)]
        for n in nodes:
            w.node(n, "zone-a")
        for i, n in enumerate(nodes[:5]):
            w.pod(f"v-{i}", node_name=n)
        w.monitor()
        w.now += 31
        alive = nodes[5:]
        w.refresh(alive)
        w.monitor()
        for _ in range(5):
            w.now += 5
            w.refresh(alive)
            w.monitor()
        assert len(w.alive("v-")) == 5
        for n in ("n6", "n7"):
            w.node(n, "zone-a")
        alive = alive + ["n6", "n7"]
        for _ in range(10):
            w.now += 5
            w.refresh(alive)
            w.monitor()
        assert w.t[1].zone_states[ZA] == tnl.ZONE_PARTIAL
        assert w.alive("v-") == []

    def test_evicted_only_after_300s_of_not_ready(self):
        w = NL(grace_period=30.0, eviction_rate_qps=1000.0,
               eviction_burst=10.0)
        w.node("n-bad", "zone-a")
        w.node("n-ok", "zone-a")
        w.pod("app", node_name="n-bad", wait=300)
        w.monitor()
        w.now += 31
        w.refresh(["n-ok"])
        w.monitor()
        t_taint = w.now
        for at in (60, 120, 180, 240, 299):
            w.now = t_taint + at
            w.refresh(["n-ok"])
            w.monitor()
        assert w.alive("app") == ["app"]
        w.now = t_taint + 301
        w.refresh(["n-ok"])
        w.monitor()
        assert w.alive("app") == []

    def test_short_blip_never_evicts(self):
        w = NL(grace_period=30.0, eviction_rate_qps=1000.0,
               eviction_burst=10.0)
        w.node("n-bad", "zone-a")
        w.node("n-ok", "zone-a")
        w.pod("app", node_name="n-bad", wait=300)
        w.monitor()
        w.now += 31
        w.refresh(["n-ok"])
        w.monitor()
        t_taint = w.now
        w.now = t_taint + 100
        w.refresh(["n-ok", "n-bad"])
        w.monitor()
        w.now = t_taint + 600
        w.refresh(["n-ok", "n-bad"])
        w.monitor()
        assert w.alive("app") == ["app"]

    def test_scheduler_places_around_the_controller_taints(self):
        """A scheduler on each store sees the NoExecute taints the
        controller lays on a severed zone: new pods land only on the
        healthy zone, in both packages alike, and on every node again
        once the heartbeats resume."""
        w = NL(scheduler=True, grace_period=30.0, eviction_rate_qps=0.0)
        a = [f"a{i}" for i in range(3)]
        b = [f"b{i}" for i in range(3)]
        for n in a:
            w.node(n, "zone-a")
        for n in b:
            w.node(n, "zone-b")
        w.monitor()
        w.now += 40
        w.refresh(b)
        w.monitor()
        for i in range(12):
            w.pod(f"new-{i}")
        assert w.drain() == 12
        assert all(n.startswith("b") for n in bindings(w.t[0]).values())
        w.now += 5
        w.refresh(a + b)
        w.monitor()
        for i in range(12):
            w.pod(f"more-{i}")
        assert w.drain() == 12
        assert any(n.startswith("a") for n in bindings(w.t[0]).values())


def _columns(seed, cap, n, z):
    rng = np.random.RandomState(seed)
    zone_id = np.zeros((cap,), np.int32)
    zone_id[:n] = rng.randint(0, z, size=n)
    bad = np.zeros((cap,), bool)
    bad[:n] = rng.rand(n) < 0.4
    valid = np.zeros((cap,), bool)
    valid[:n] = rng.rand(n) < 0.9
    return zone_id, bad, valid


@pytest.mark.parametrize("seed,cap,n,z,nz", [
    (0, 8, 5, 3, 8),  # padded rows
    (1, 64, 64, 16, 16),  # no padding
    (2, 1024, 700, 5, 32),  # empty zones past the used ids
    (3, 16, 0, 1, 8),  # no node at all
])
def test_tally_matches_both_jax_forms(seed, cap, n, z, nz):
    zone_id, bad, valid = _columns(seed, cap, n, z)
    got = tzh._tally_device(zone_id, bad, valid, nz, tenc.resolve_device("cpu"))
    want_dev = jzh._tally_device(zone_id, bad, valid, nz)
    want_host = jzh.zone_tally_host(zone_id, bad, valid, nz)
    for g, a, b in zip(got, want_dev, want_host):
        assert g.dtype == np.int32 and g.shape == (nz,)
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, b)
    np.testing.assert_array_equal(
        tzh.zone_tally_host(zone_id, bad, valid, nz)[0], want_host[0])


def test_tally_paths_are_counted_and_an_open_breaker_takes_the_host():
    zone_id, bad, valid = _columns(5, 32, 20, 4)
    now = [0.0]
    br = tbreaker.DevicePathBreaker(threshold=1, cooldown=30.0,
                                    clock=lambda: now[0])
    want = tzh.zone_tally_host(zone_id, bad, valid, 8)
    tzh.reset_counts()
    got = tzh.zone_tally(zone_id, bad, valid, 8, breaker=br, device="cpu")
    assert tzh.TALLY_COUNTS == {"device": 1, "host": 0, "device_failures": 0}
    br.record_failure()  # trips at threshold 1
    assert br.state == tbreaker.OPEN
    got_open = tzh.zone_tally(zone_id, bad, valid, 8, breaker=br,
                              device="cpu")
    assert tzh.TALLY_COUNTS == {"device": 1, "host": 1, "device_failures": 0}
    for g, h, w in zip(got, got_open, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(h, w)
    # past the cooldown the probe takes the device and closes it
    now[0] = 31.0
    tzh.zone_tally(zone_id, bad, valid, 8, breaker=br, device="cpu")
    assert br.state == tbreaker.CLOSED
    assert tzh.TALLY_COUNTS["device"] == 2
    tzh.reset_counts()


def test_a_failing_device_tally_is_answered_by_the_host_and_counted(
        monkeypatch, caplog):
    zone_id, bad, valid = _columns(6, 16, 10, 3)
    br = tbreaker.DevicePathBreaker(threshold=3)

    def broken(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(tzh, "_tally_device", broken)
    tzh.reset_counts()
    got = tzh.zone_tally(zone_id, bad, valid, 8, breaker=br, device="cpu")
    for g, w in zip(got, tzh.zone_tally_host(zone_id, bad, valid, 8)):
        np.testing.assert_array_equal(g, w)
    assert tzh.TALLY_COUNTS == {"device": 0, "host": 1, "device_failures": 1}
    assert br.failures == 1
    assert "device lost" in caplog.text
    tzh.reset_counts()


def test_tally_fault_point_is_a_device_failure_in_both_packages():
    """nodelifecycle.tally raising: both packages answer on the host and
    charge their breaker one failure; equal answers, equal hits."""
    from kubernetes_tpu.sched import breaker as jbreaker
    from kubernetes_tpu.utils import faultpoints as jfp
    from kubernetes_tpu_torch.utils import faultpoints as tfp

    zone_id, bad, valid = _columns(7, 16, 12, 3)
    arm("nodelifecycle.tally", times=1)
    tbr = tbreaker.DevicePathBreaker(threshold=3)
    jbr = jbreaker.DevicePathBreaker(threshold=3)
    tzh.reset_counts()
    got = tzh.zone_tally(zone_id, bad, valid, 8, breaker=tbr, device="cpu")
    want = jzh.zone_tally(zone_id, bad, valid, 8, breaker=jbr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tbr.failures == jbr.failures == 1
    assert tzh.TALLY_COUNTS == {"device": 0, "host": 1, "device_failures": 1}
    assert tfp.hits("nodelifecycle.tally") == jfp.hits(
        "nodelifecycle.tally") == 1
    # the budget spent, the next tally takes the device again
    tzh.zone_tally(zone_id, bad, valid, 8, breaker=tbr, device="cpu")
    assert tbr.failures == 0 and tzh.TALLY_COUNTS["device"] == 1
    tzh.reset_counts()


def test_evict_drop_fault_keeps_the_eviction_queued():
    """nodelifecycle.evict dropped once: the eviction call is lost, the
    entry stays queued (queue depth counts it) and the next pass evicts,
    equal in both packages at every pass."""
    from kubernetes_tpu.utils import faultpoints as jfp
    from kubernetes_tpu_torch.utils import faultpoints as tfp

    w = NL(grace_period=40.0)
    w.node("n1")
    w.node("n2")
    w.pod("p1", node_name="n1", tolerations=[dict(
        key=tnl.TAINT_UNREACHABLE, operator="Exists",
        effect="NoExecute", toleration_seconds=30)])
    w.monitor()
    w.now += 100
    w.refresh(["n2"])
    w.monitor()
    w.now += 31
    w.refresh(["n2"])
    arm("nodelifecycle.evict", "drop", times=1)
    w.monitor()
    assert w.alive("p") == ["p1"]
    assert tfp.hits("nodelifecycle.evict") == jfp.hits(
        "nodelifecycle.evict") == 1
    w.now += 1
    w.refresh(["n2"])
    w.monitor()
    assert w.alive("p") == []
    assert w.t[1].evictions == 1


def test_controller_without_a_card_raises():
    """device=None means the CUDA card; where there is none the
    controller refuses to start instead of tallying on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tnl.NodeLifecycleController(TorchStore())
