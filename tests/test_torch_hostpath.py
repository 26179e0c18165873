"""The exact host path of kubernetes_tpu_torch's Scheduler against the
JAX Scheduler: pods whose required pod (anti-)affinity terms of one kind
span two topology keys (the zone of an `app=db` pod and the host of a
`tier=cache` pod, torch_worlds.multikey_affinity) go through
plugins/golden.py one pod at a time, from the pipeline, from the
per-wave loop and as gang members, and place where the JAX Scheduler
places them (torch_parity.Both: bindings,
nominations, victims, queue and metrics after every step, on a virtual
clock). Also: every placed pod satisfies both of its terms, read back
from the store; the JAX default profile's volume predicates pass these
volume-free pods; a pod whose spec crashes the golden pass is convicted
into the quarantine and the drain goes on, a batch whose every pod
crashes is parked as a systemic fault, both as in the JAX Scheduler,
and an infrastructure error parks the pod.
"""

from kubernetes_tpu.plugins import golden as jgolden
from kubernetes_tpu.plugins import volumes as jvolumes
from kubernetes_tpu_torch.plugins import golden as tgolden
from kubernetes_tpu_torch.runtime.store import ObjectStore
from kubernetes_tpu_torch.sched.scheduler import Scheduler

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both, check_faults
from torch_worlds import (FakeClock, bindings, multikey_affinity, plain_node,
                          plain_pod)

TORCH = "kubernetes_tpu_torch"


def _zoned(n_nodes, cpu="4"):
    """Both with n_nodes nodes n{i} in zones z{i % 3}."""
    b = Both()
    for i in range(n_nodes):
        b.node(f"n{i}", cpu=cpu, zone=f"z{i % 3}")
    return b


def _anchors(b, both=("n3", "n1"), app_only=("n0", "n4"),
             tier_only=("n8",), priority=None):
    """Bound pods with no requests: `app=db, tier=cache` (the only pods
    that anchor both terms of multikey_affinity), and decoys that match
    one term each."""
    for labels, nodes in (({"app": "db", "tier": "cache"}, both),
                          ({"app": "db"}, app_only),
                          ({"tier": "cache"}, tier_only)):
        for node in nodes:
            name = "-".join(labels.values()) + f"-{node}"
            b.pod(name, labels=labels, node_name=node, priority=priority)


def _check_terms(store):
    """Every bound pod with required (anti-)affinity over two topology
    keys holds its terms, read back from the store in the 1.11 semantics:
    some bound pod matches every term's selector and shares every term's
    domain with the pod's node (none may, for anti-affinity). Returns the
    number of such pods bound."""
    labels = {n.metadata.name: n.metadata.labels for n in store.list("nodes")}
    bound = [p for p in store.list("pods") if p.spec.node_name]
    checked = 0
    for p in bound:
        aff = p.spec.affinity
        if aff is None:
            continue
        group = aff.pod_affinity or aff.pod_anti_affinity
        if len({t.topology_key for t in group.required}) < 2:
            continue
        checked += 1
        mine = labels[p.spec.node_name]
        anchored = any(
            q is not p and all(
                q.namespace == p.namespace
                and t.label_selector.matches(q.metadata.labels)
                and mine.get(t.topology_key) is not None
                and labels[q.spec.node_name].get(t.topology_key)
                == mine.get(t.topology_key)
                for t in group.required)
            for q in bound)
        assert anchored == (aff.pod_affinity is not None), p.metadata.name
    return checked


def _multikey_pods(b):
    """The JAX side's pending and bound pods with multi-key terms."""
    return [p for p in b.stores["jax"].list("pods")
            if p.spec.affinity is not None
            and (p.spec.affinity.pod_affinity
                 or p.spec.affinity.pod_anti_affinity)]


def test_multikey_pods_mixed_with_device_pods_and_a_gang():
    """16 multi-key affinity pods, 6 multi-key anti-affinity pods, 20
    plain pods and a gang of 3 multi-key members and one plain member
    (min-available 4): the host-path members place one at a time, with no
    atomicity; the plain member's dispatch fails short of 4 and parks,
    and places after its backoff once a new node moves it, its 3 bound
    mates counting toward minMember."""
    b = _zoned(12)
    _anchors(b)
    for i in range(20):
        b.pod(f"plain-{i}", cpu="1")
    for i in range(16):
        b.pod(f"near-{i}", cpu="500m", affinity=multikey_affinity())
    for i in range(6):
        b.pod(f"far-{i}", cpu="1", affinity=multikey_affinity(anti=True))
    for i in range(3):
        b.pod(f"gang-{i}", cpu="500m", gang="mk", min_avail=4,
              affinity=multikey_affinity())
    b.pod("gang-3", cpu="500m", gang="mk", min_avail=4)
    b.run()
    assert b.bound("mk") == 3
    b.advance(2.0)
    b.node("n12", cpu="4", zone="z0")
    b.run()
    store = b.stores["torch"]
    assert b.bound("mk") == 4
    assert _check_terms(store) >= 10
    m = b.sched["torch"].metrics
    assert m.waves_total.value(path="host") >= 25
    assert m.gang_schedule_attempts.value >= 2


def test_multikey_pod_places_by_preempting():
    """Every node is full of priority-1 pods; a priority-100 pod whose
    terms only n3 satisfies evicts n3's pod through the host path's
    preemption, is nominated there and binds in the same drain (its
    nomination's store write re-queues it before the park, as in the JAX
    scheduler: ROADMAP queue 3). The anchors outrank it: a lower-priority anchor would be a victim of the
    what-if too, which then fails the pod's own affinity (1.11's
    selectVictimsOnNode, in both packages)."""
    b = _zoned(6, cpu="2")
    _anchors(b, both=("n3",), app_only=("n0",), tier_only=("n4",),
             priority=1000)
    for i in range(6):
        b.pod(f"low-{i}", cpu="2", priority=1)
    assert b.run() == 6
    b.pod("vip", cpu="2", priority=100, affinity=multikey_affinity())
    assert b.run() == 1
    store = b.stores["torch"]
    assert bindings(store)["vip"] == "n3"
    assert len([p for p in store.list("pods")
                if p.metadata.name.startswith("low-")]) == 5
    m = b.sched["torch"].metrics
    assert m.pod_preemption_victims.value == 1
    assert m.waves_total.value(path="host") == 2
    assert _check_terms(b.stores["torch"]) == 1


def test_multikey_pods_through_the_per_wave_loop():
    """run_once on both schedulers: each wave sends its multi-key pods
    through the host path and the rest through the device wave."""
    b = _zoned(9)
    _anchors(b, both=("n3", "n5"), app_only=("n0",), tier_only=("n1",))
    for i in range(12):
        b.pod(f"plain-{i}", cpu="1")
        if i % 2:
            b.pod(f"near-{i}", cpu="1", affinity=multikey_affinity())
        else:
            b.pod(f"far-{i}", cpu="1", affinity=multikey_affinity(anti=True))
    for _ in range(3):
        got = [b.sched[s].run_once() for s in ("jax", "torch")]
        assert got[0] == got[1]
        b.check()
    assert _check_terms(b.stores["torch"]) >= 6


def test_volume_predicates_pass_the_multikey_pods():
    """The JAX default profile's volume predicates
    (plugins/volumes.py default_volume_predicates: the ones the port does
    not run yet) pass every multi-key pod of these worlds on every node,
    so leaving them out changes no placement."""
    b = _zoned(12)
    _anchors(b)
    for i in range(4):
        b.pod(f"near-{i}", cpu="500m", affinity=multikey_affinity())
        b.pod(f"far-{i}", cpu="1", affinity=multikey_affinity(anti=True))
        b.pod(f"gang-{i}", cpu="500m", gang="mk", min_avail=4,
              affinity=multikey_affinity())
    b.run()
    preds = jvolumes.default_volume_predicates(b.stores["jax"])
    assert preds
    infos = b.sched["jax"].cache.node_infos
    pods = _multikey_pods(b)
    assert len(pods) == 12
    for pod in pods:
        for name, fn in preds.items():
            for ni in infos.values():
                ok, reasons = fn(pod, ni)
                assert ok, (name, pod.metadata.name, reasons)


def _torch_world(clock):
    store = ObjectStore()
    sched = Scheduler(store, device="cpu", clock=clock)
    for i in range(6):
        store.create("nodes", plain_node(TORCH, f"n{i}", zone=f"z{i % 3}"))
    store.create("pods", plain_pod(TORCH, "db-cache",
                                   labels={"app": "db", "tier": "cache"},
                                   node_name="n3"))
    for i in range(3):
        store.create("pods", plain_pod(TORCH, f"near-{i}", cpu="1",
                                       affinity=multikey_affinity()))
        store.create("pods", plain_pod(TORCH, f"plain-{i}", cpu="1"))
    return store, sched


def _golden_crash_world(monkeypatch, crash):
    """The world of ROADMAP queue 3's golden-pass fault, in both packages:
    12 zoned nodes with their anchors, pods near-0..3 (multikey_affinity,
    500m) and plain-0..3 (500m), and golden.pod_fits_on_node patched in
    both packages to raise ValueError for the pods named in `crash`."""
    b = _zoned(12)
    _anchors(b)
    for i in range(4):
        b.pod(f"near-{i}", cpu="500m", affinity=multikey_affinity())
        b.pod(f"plain-{i}", cpu="500m")
    for mod in (jgolden, tgolden):
        def crashing(pod, ni, _fits=mod.pod_fits_on_node, **kw):
            if pod.metadata.name in crash:
                raise ValueError("golden pass crashed")
            return _fits(pod, ni, **kw)

        monkeypatch.setattr(mod, "pod_fits_on_node", crashing)
    return b


def test_golden_crash_convicts_the_pod_and_drains_on(monkeypatch):
    """A pod whose spec crashes the golden pass is convicted (reason
    golden, into the quarantine) and the drain goes on, as in the JAX
    Scheduler: 7 of the 8 pods bound in both packages, the same
    quarantine, poison_pods{reason="golden"} 1 and the same fault
    state."""
    b = _golden_crash_world(monkeypatch, {"near-1"})
    assert b.run() == 7
    check_faults(b)
    t = b.sched["torch"]
    assert [p.metadata.name for p in t.queue.quarantined_pods()] == [
        "near-1"]
    assert t.metrics.poison_pods.value(reason="golden") == 1
    assert t.poison_convictions == 1
    assert not bindings(b.stores["torch"])["near-1"]
    assert bindings(b.stores["torch"])["near-2"]


def test_golden_crash_of_every_pod_parks_the_batch(monkeypatch):
    """When every pod of a host-path batch of two or more crashes the
    golden pass, the fault is systemic, not poison: the batch is parked
    with backoff and nobody is convicted; the device pods place. Both
    packages alike."""
    b = _golden_crash_world(monkeypatch, {f"near-{i}" for i in range(4)})
    assert b.run() == 4
    check_faults(b)
    t = b.sched["torch"]
    assert t.queue.quarantine_count() == 0 and t.poison_convictions == 0
    assert t.metrics.scheduling_errors.value(stage="wave") == 1
    assert t.queue.backoff_count() + t.queue.unschedulable_count() == 4
    got = bindings(b.stores["torch"])
    assert all(got[f"plain-{i}"] for i in range(4))
    assert not any(got[f"near-{i}"] for i in range(4))


def test_golden_infrastructure_error_parks_the_pod(monkeypatch):
    """A store error inside the golden pass (KeyError, OSError, Conflict,
    TimeoutError) parks the pod with backoff, is counted as a bind
    error, and the rest of the drain goes on."""
    fits = tgolden.pod_fits_on_node

    def flaky(pod, ni, **kw):
        if pod.metadata.name == "near-1":
            raise OSError("store unreachable")
        return fits(pod, ni, **kw)

    clock = FakeClock()
    store, sched = _torch_world(clock)
    monkeypatch.setattr(tgolden, "pod_fits_on_node", flaky)
    assert sched.schedule_pending() == 5
    assert sched.metrics.scheduling_errors.value(stage="bind") == 1
    assert not bindings(store)["near-1"]
    assert bindings(store)["near-0"] == "n3"
    monkeypatch.setattr(tgolden, "pod_fits_on_node", fits)
    clock.advance(2.0)
    store.create("nodes", plain_node(TORCH, "n6", zone="z0"))  # an event
    assert sched.schedule_pending() == 1
    assert bindings(store)["near-1"] == "n3"
