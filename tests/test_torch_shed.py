"""Load shedding in kubernetes_tpu_torch (the queue's shed area and the
scheduler's shed series) against the JAX package (tests/test_storm.py's
TestShedPlane and TestStormSLO): the same arrivals go to both packages'
queues, or through torch_parity.Both to both schedulers on the same
virtual clock, and the shed decisions (the on_shed classes in order),
the shed area in order, the waves popped, the class counts, the
bindings, the per-class latencies and the shed series must be equal, as
must the `queue.shed` hit counts. With watermark 0 (the default) the
queue sheds nothing.
"""

import pytest

from kubernetes_tpu.sched import queue as jqueue
from kubernetes_tpu.utils import faultpoints as jfp
from kubernetes_tpu_torch.sched import queue as tqueue
from kubernetes_tpu_torch.utils import faultpoints as tfp

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both, arm, disarm
from torch_worlds import FakeClock, plain_pod

SIDES = ("jax", "torch")
PKGS = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}


class Queues:
    """Both packages' SchedulingQueue on one virtual clock each, fed the
    same pods; every query must answer alike."""

    def __init__(self, watermark=10, age=5.0, gangs=None):
        self.clock = {s: FakeClock() for s in SIDES}
        self.sheds = {s: [] for s in SIDES}
        self.q = {}
        self.pods = {s: {} for s in SIDES}
        for s, mod in (("jax", jqueue), ("torch", tqueue)):
            q = mod.SchedulingQueue(clock=self.clock[s],
                                    shed_watermark=watermark,
                                    shed_age_s=age)
            q.on_shed = self.sheds[s].append
            if gangs is not None:
                q.gang_lookup = gangs
            self.q[s] = q

    def add(self, name, prio):
        for s in SIDES:
            p = plain_pod(PKGS[s], name, cpu="100m", memory="64Mi",
                          priority=prio)
            self.pods[s][name] = p
            self.q[s].add(p)

    def advance(self, d):
        for c in self.clock.values():
            c.advance(d)

    def ask(self, fn):
        out = {s: fn(self.q[s]) for s in SIDES}
        assert out["torch"] == out["jax"], out
        return out["torch"]

    def pop_wave(self, n):
        out = {"jax": [p.metadata.name for p in
                       self.q["jax"].pop_wave(n, timeout=0)],
               "torch": [p.metadata.name for p in
                         self.q["torch"].pop_wave(n)]}
        assert out["torch"] == out["jax"], out
        return out["torch"]

    def check(self):
        assert self.sheds["torch"] == self.sheds["jax"]
        self.ask(lambda q: [p.metadata.name for p in q.shed_pods()])
        self.ask(lambda q: q.class_counts())
        self.ask(lambda q: q.pending_count())


# -- the queue's shed plane ------------------------------------------------------


def test_class_bands():
    for prio in (2_000_000_000, 1000, 999, 5, 1, 0, -10):
        assert tqueue.pod_class(prio) == jqueue.pod_class(prio)
    assert tqueue.QUEUE_CLASSES == jqueue.QUEUE_CLASSES
    assert tqueue.HIGH_PRIORITY_BAND == jqueue.HIGH_PRIORITY_BAND
    assert tqueue.SYSTEM_PRIORITY_BAND == jqueue.SYSTEM_PRIORITY_BAND


def test_watermark_sheds_sub_threshold_only():
    qs = Queues()
    for i in range(15):
        qs.add(f"low-{i}", 0)
    assert qs.ask(lambda q: q.shed_count()) == 5
    assert qs.sheds["torch"] == ["low"] * 5
    for i in range(5):
        qs.add(f"hi-{i}", 2000)
    qs.add("sys-0", 2_000_000_000)
    assert qs.ask(lambda q: q.shed_count()) == 5
    assert qs.ask(lambda q: q.pending_count()) == 21
    qs.check()


def test_wave_composition_high_first():
    """A 5x low-class storm, high pods arriving last: the next wave leads
    with every system/high pod."""
    qs = Queues(watermark=20)
    for i in range(100):
        qs.add(f"low-{i}", 0)
    for i in range(3):
        qs.add(f"hi-{i}", 2000)
    qs.add("sys-0", 2_000_000_000)
    names = qs.pop_wave(8)
    assert names[0] == "sys-0"
    assert set(names[1:4]) == {"hi-0", "hi-1", "hi-2"}
    assert all(n.startswith("low-") for n in names[4:])
    qs.check()


def test_shed_ages_back_even_mid_storm():
    """Shed pods age back into the active heap after shed_age_s even with
    the working set pinned at the watermark, with a one-wave re-shed
    exemption."""
    qs = Queues(watermark=4, age=5.0)
    for i in range(8):
        qs.add(f"a-{i}", 0)
    assert qs.ask(lambda q: q.shed_count()) == 4
    qs.advance(6.0)
    qs.add("fresh-0", 0)
    assert qs.ask(lambda q: q.shed_count()) >= 1
    assert qs.ask(lambda q: q.active_count()) >= 8
    assert len(qs.pop_wave(16)) >= 8
    qs.check()


def test_shed_releases_oldest_first_under_watermark():
    qs = Queues(watermark=2, age=100.0)
    for i in range(5):
        qs.add(f"p-{i}", 0)
        qs.advance(0.01)
    assert qs.ask(lambda q: q.shed_count()) == 3
    assert qs.pop_wave(2) == ["p-0", "p-1"]
    assert qs.pop_wave(2) == ["p-2", "p-3"]
    qs.check()


def test_queue_shed_fault_point_forces():
    """queue.shed (drop) sheds a sheddable pod far from the watermark and
    holds the shed area while armed; disarmed, the quiet watermark
    releases it. The same hits in both packages."""
    qs = Queues(watermark=1000)
    arm("queue.shed", "drop")
    qs.add("low-0", 0)
    qs.add("hi-0", 2000)
    assert qs.ask(lambda q: q.shed_count()) == 1
    assert qs.ask(lambda q: q.active_count()) == 1
    disarm("queue.shed")
    assert qs.ask(lambda q: q.active_count()) == 2
    assert qs.ask(lambda q: q.shed_count()) == 0
    assert tfp.hits("queue.shed") == jfp.hits("queue.shed") == 1
    qs.check()


def test_times_bounded_shed_fault_counts_alike():
    """A times-bounded queue.shed fault: the release probe (is_armed)
    spends none of its budget, in either package."""
    qs = Queues(watermark=1000)
    arm("queue.shed", "drop", times=3)
    for i in range(5):
        qs.add(f"low-{i}", 0)
        qs.ask(lambda q: q.active_count())
    assert tfp.hits("queue.shed") == jfp.hits("queue.shed") == 3
    qs.check()


def test_gang_members_never_shed():
    qs = Queues(watermark=2, gangs=lambda pod: (
        ("g1", 3) if pod.metadata.name.startswith("gm") else None))
    for i in range(4):
        qs.add(f"low-{i}", 0)
    assert qs.ask(lambda q: q.shed_count()) == 2
    for i in range(3):
        qs.add(f"gm-{i}", 0)
    assert qs.ask(lambda q: q.shed_count()) == 2
    assert set(qs.pop_wave(16)) >= {"gm-0", "gm-1", "gm-2"}
    qs.check()


def test_class_counts_span_all_areas():
    qs = Queues(watermark=2)
    for i in range(3):
        qs.add(f"low-{i}", 0)
    qs.add("hi-0", 5000)
    qs.add("norm-0", 5)
    counts = qs.ask(lambda q: q.class_counts())
    assert counts == {"system": 0, "high": 1, "normal": 1, "low": 3}
    qs.check()


def test_delete_and_update_reach_shed_pods():
    qs = Queues(watermark=1)
    qs.add("a", 0)
    qs.add("b", 0)
    assert qs.ask(lambda q: q.shed_count()) == 1
    for s in SIDES:
        b2 = plain_pod(PKGS[s], "b", cpu="100m", memory="64Mi", priority=0)
        qs.q[s].update(qs.pods[s]["b"], b2)
        qs.pods[s]["b2"] = b2
    assert qs.ask(lambda q: q.shed_count()) == 1
    for s in SIDES:
        qs.q[s].delete(qs.pods[s]["b2"])
    assert qs.ask(lambda q: q.shed_count()) == 0
    assert qs.ask(lambda q: q.pending_count()) == 1
    qs.check()


def test_watermark_zero_sheds_nothing():
    """The default (watermark 0): no pod is shed, whatever the depth, and
    the queue pops exactly what it popped before the shed area existed."""
    qs = Queues(watermark=0)
    for i in range(50):
        qs.add(f"low-{i}", 0)
    qs.add("hi-0", 2000)
    assert qs.ask(lambda q: q.shed_count()) == 0
    assert qs.sheds["torch"] == []
    assert qs.pop_wave(4) == ["hi-0", "low-0", "low-1", "low-2"]
    qs.check()


# -- the storm SLO through both schedulers ---------------------------------------


def _storm(wave, watermark, age, nodes=8):
    b = Both(0, wave=wave, caps=None,
             sched_kw=dict(shed_watermark=watermark, shed_age_s=age))
    for i in range(nodes):
        b.node(f"n{i}", cpu="64", memory="64Gi", pods=110)
    return b


def _run_once(b):
    got = {"jax": b.sched["jax"].run_once(timeout=0.0),
           "torch": b.sched["torch"].run_once()}
    assert got["torch"] == got["jax"]
    b.check()
    return got["torch"]


def _shed_series(sched):
    m = sched.metrics
    return ({c.name: c.value for c in m.shed_total.children()},
            {c.name: c.value for c in m.queue_class_pods.children()},
            m.pending_pods.value(queue="shed"))


def test_burst_protects_high_classes_and_recovers_low():
    """A 5x-capacity low-class burst against a 16-wide wave on a virtual
    clock, one wave a tick: every system/high pod binds within its
    arrival tick, no high-class pod is shed, low-class pods shed and
    later age back, and after the storm every pod is placed; the same in
    both packages, latencies and shed series included."""
    wave = 16
    b = _storm(wave, 2 * wave, 10.0)
    created = {}
    seq = [0]
    lat = {"system": [], "high": [], "low": []}
    bound = set()

    def arrive(cls, prio, count):
        for _ in range(count):
            name = f"{cls}-{seq[0]}"
            seq[0] += 1
            b.pod(name, cpu="100m", memory="64Mi", priority=prio)
            created[name] = (cls, b.clock["torch"]())

    def account():
        for p in b.stores["torch"].list("pods"):
            name = p.metadata.name
            if name in created and name not in bound and p.spec.node_name:
                cls, t0 = created[name]
                bound.add(name)
                lat[cls].append(b.clock["torch"]() - t0)

    for _tick in range(10):
        b.advance(1.0)
        arrive("low", 0, 5 * wave)
        arrive("high", 10_000, 2)
        arrive("system", 2_000_000_000, 1)
        _run_once(b)
        account()
        for name, (cls, _t) in created.items():
            if cls in ("system", "high"):
                assert name in bound, f"{cls} pod waited a tick"
    m = b.sched["torch"].metrics
    assert m.shed_total.value(**{"class": "high"}) == 0
    assert m.shed_total.value(**{"class": "system"}) == 0
    assert m.shed_total.value(**{"class": "low"}) > 0
    assert all(v == 0.0 for v in lat["system"] + lat["high"])
    for _ in range(60):
        b.advance(1.0)
        if b.run() == 0 and b.sched["torch"].pending_count() == 0:
            break
    account()
    assert len(bound) == len(created)
    for s in SIDES:
        b.sched[s].export_queue_gauges()
    want, got = (_shed_series(b.sched[s]) for s in SIDES)
    assert got == want
    assert m.pending_pods.value(queue="shed") == 0
    assert m.queue_class_pods.value(**{"class": "low"}) == 0


def test_aged_low_pods_schedule_during_sustained_storm():
    """No permanent starvation during an unending storm: a marked
    early-storm low pod is placed once it ages back in, at the same tick
    in both packages."""
    wave = 8
    b = _storm(wave, wave, 3.0)
    for i in range(wave * 2):
        b.pod(f"pre-{i}", cpu="100m", memory="64Mi", priority=0)
    b.pod("marked", cpu="100m", memory="64Mi", priority=0)
    assert b.sched["torch"].queue.shed_count() >= 1
    placed_at = None
    for tick in range(12):
        b.advance(1.0)
        for i in range(wave):
            b.pod(f"s{tick}-{i}", cpu="100m", memory="64Mi", priority=0)
        _run_once(b)
        got = b.stores["torch"].get("pods", "default", "marked")
        if got is not None and got.spec.node_name:
            placed_at = tick
            break
    assert placed_at is not None, "aged shed pod starved through the storm"
    want, got = (_shed_series(b.sched[s]) for s in SIDES)
    assert got == want


def test_shed_pod_event_when_tracing():
    """_pod_shed files one pod_shed event a shed decision with the
    port's flight recorder on."""
    from kubernetes_tpu_torch.utils import tracing

    rec = tracing.enable()
    try:
        b = _storm(4, 4, 30.0, nodes=2)
        for i in range(6):
            b.pod(f"low-{i}", cpu="100m", memory="64Mi", priority=0)
        events = [e for e in rec.background.events if e.name == "pod_shed"]
        assert len(events) == 2
        assert b.sched["torch"].metrics.shed_total.value(
            **{"class": "low"}) == 2
    finally:
        tracing.disable()


@pytest.mark.parametrize("watermark", [0, 6])
def test_shed_depth_gauges_match_jax(watermark):
    """pending_pods{queue="shed"} and the banded class gauges after a
    drain, watermark off and on."""
    b = _storm(4, watermark, 30.0, nodes=2)
    for i in range(10):
        b.pod(f"low-{i}", cpu="100m", memory="64Mi", priority=0)
    b.pod("hi-0", cpu="100m", memory="64Mi", priority=5000)
    for s in SIDES:
        b.sched[s].export_queue_gauges()
    want, got = (_shed_series(b.sched[s]) for s in SIDES)
    assert got == want
    assert got[2] == (0 if watermark == 0 else 4)
    b.run()
    want, got = (_shed_series(b.sched[s]) for s in SIDES)
    assert got == want
