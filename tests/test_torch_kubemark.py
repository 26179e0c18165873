"""The port's kubemark hollow cluster (kubernetes_tpu_torch/kubemark/,
with its copies of kubelet/, proxy/ and volume/) and its two fault
seams, `heartbeat.deliver` (kubelet/kubelet.py heartbeat) and
`watch.deliver` (runtime/store.py _notify), in lockstep with the JAX
package's on the CPU.

Each case drives one scenario through both packages on a virtual clock
and compares what a user of the cluster reads: the node and pod objects
in the store (encoded by each package's api/scheme.py, uids masked),
the proxy rules, the node-lifecycle controller's zone states, taints
and evictions, the hit counts of the fault points, and, with the gang
rollback hook off, the assumed members a failed gang commit leaves.
The scenarios are tests/test_kubemark.py's load-and-churn and
zones-and-proxy, tests/test_partition.py:287-330's partition and heal,
and tests/test_partition.py:334's heartbeat drop.
"""

import dataclasses
import importlib
import re

import numpy as np
import pytest

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import SCHED_CAPS
from torch_worlds import FakeClock, plain_node, plain_pod

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")
_UID = re.compile(r"uid-\d+")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _dev(pkg):
    return {"device": "cpu"} if pkg == "kubernetes_tpu_torch" else {}


def strip(x):
    """x with pod and node uids masked, recursively."""
    if isinstance(x, str):
        return _UID.sub("uid-*", x)
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k != "uid"}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def objects(pkg, store, kind):
    enc = mod(pkg, "api.scheme").encode
    return strip([enc(o) for o in store.list(kind)])


def hits(pkg, name):
    return mod(pkg, "utils.faultpoints").hits(name)


def arm(pkg, name, mode, **kw):
    """Arm one package's point only: the other package's run must not
    find it armed."""
    mod(pkg, "utils.faultpoints").activate(name, mode, **kw)


def both(run):
    """run(pkg) for each package; the two results must be equal."""
    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    return got["kubernetes_tpu_torch"]


def _scheduler(pkg, store, clock, **kw):
    return mod(pkg, "sched.scheduler").Scheduler(
        store, wave_size=16, caps=mod(pkg, "ops.encoding").Caps(**SCHED_CAPS),
        clock=clock, **_dev(pkg), **kw)


def _load(pkg, prefix):
    """HollowCluster.create_pods' default pod, with its uid set to its
    name: the kubelet's hash-ip plugin derives the pod IP from the uid,
    and minted uids (a process-wide counter) differ between the
    packages' runs."""
    api = mod(pkg, "api.types")

    def make(i):
        return api.Pod(
            metadata=api.ObjectMeta(name=f"{prefix}-{i}", uid=f"{prefix}-{i}",
                                    labels={"type": prefix}),
            spec=api.PodSpec(containers=[api.Container(
                resources=api.ResourceRequirements(
                    requests=api.resource_list(cpu="100m",
                                               memory="128Mi")))]))
    return make


def _drain(sched, want):
    placed = 0
    for _ in range(10):
        placed += sched.run_once()
        if placed >= want:
            break
    sched.wait_for_binds()
    return placed


# -- tests/test_kubemark.py ---------------------------------------------------


def test_load_and_churn_as_in_jax():
    def run(pkg):
        clock = FakeClock()
        store = mod(pkg, "runtime.store").ObjectStore()
        hc = mod(pkg, "kubemark").HollowCluster(store, n_nodes=5,
                                                clock=clock)
        sched = _scheduler(pkg, store, clock, invariants=True)
        try:
            assert store.count("nodes") == 5
            hc.create_pods(20, pod_factory=_load(pkg, "load"))
            first = _drain(sched, 20)
            hc.sync_once()
            running = [p for p in store.list("pods")
                       if p.status.phase == "Running"]
            assert len(running) == 20
            assert len({p.spec.node_name for p in running}) == 5
            before = objects(pkg, store, "pods")
            deleted = hc.churn(6, np.random.default_rng(0))
            hc.create_pods(6, pod_factory=_load(pkg, "replacement"))
            second = _drain(sched, 6)
            clock.advance(1.0)
            hc.sync_once()
            assert sched.invariants.checks > 0
            assert not sched.invariants.violations
            return dict(placed=(first, deleted, second), before=before,
                        pods=objects(pkg, store, "pods"),
                        nodes=objects(pkg, store, "nodes"),
                        checks=sched.invariants.checks)
        finally:
            sched.close()
            hc.stop()

    got = both(run)
    assert got["placed"] == (20, 6, 6)
    assert sum(p["status"]["phase"] == "Running" for p in got["pods"]) == 20


def _service(pkg):
    api = mod(pkg, "api.types")
    svc = api.Service(
        metadata=api.ObjectMeta(name="web"),
        spec=api.ServiceSpec(
            selector={"app": "w"}, cluster_ip="10.96.0.10", type="NodePort",
            ports=[api.ServicePort(name="http", port=80, target_port=8080,
                                   node_port=30080)]))
    eps = api.Endpoints(
        metadata=api.ObjectMeta(name="web"),
        subsets=[api.EndpointSubset(
            addresses=[api.EndpointAddress(ip="10.0.0.1",
                                           node_name="hollow-0"),
                       api.EndpointAddress(ip="10.0.0.2",
                                           node_name="hollow-1")],
            not_ready_addresses=[api.EndpointAddress(
                ip="10.0.0.3", node_name="hollow-2")],
            ports=[api.EndpointPort(name="http", port=8080)])])
    return svc, eps


def test_zones_and_proxy_as_in_jax():
    def run(pkg):
        api = mod(pkg, "api.types")
        store = mod(pkg, "runtime.store").ObjectStore()
        hc = mod(pkg, "kubemark").HollowCluster(
            store, n_nodes=6, zones=3, racks=2, generations=2,
            with_proxy=True, clock=FakeClock())
        try:
            zones = sorted({n.metadata.labels[api.LABEL_ZONE]
                            for n in store.list("nodes")})
            assert hc.nodes[0].proxy is not None
            assert all(n.proxy is None for n in hc.nodes[1:])
            svc, eps = _service(pkg)
            store.create("services", svc)
            store.create("endpoints", eps)
            hc.sync_once()
            px = hc.nodes[0].proxy
            rules = {k: dataclasses.asdict(r) for k, r in px.rules.items()}
            routes = [px.resolve_vip("10.96.0.10", 80) for _ in range(4)]
            node_port = px.resolve_node_port(30080)
            return dict(zones=zones, rules=rules, routes=routes,
                        node_port=node_port, health=px.health(),
                        nodes=objects(pkg, store, "nodes"))
        finally:
            hc.stop()

    got = both(run)
    assert got["zones"] == ["zone-0", "zone-1", "zone-2"]
    assert set(got["routes"]) == {("10.0.0.1", 8080), ("10.0.0.2", 8080)}
    assert got["health"]["rules"] == 1


# -- tests/test_partition.py:287-330 ------------------------------------------


def _lifecycle(pkg, store, clock, **kw):
    nlc = mod(pkg, "controllers.nodelifecycle")
    return nlc, nlc.NodeLifecycleController(
        store, clock=clock, grace_period=10.0, eviction_rate_qps=100.0,
        eviction_burst=100.0, **_dev(pkg), **kw)


def _taints(store):
    return {n.metadata.name: sorted((t.key, t.effect)
                                    for t in n.spec.taints or [])
            for n in store.list("nodes")}


def _pods(store):
    return sorted(p.metadata.name for p in store.list("pods"))


@pytest.mark.parametrize("zone,fraction,n_nodes,eviction_wait", [
    ("zone-0", 1.0, 6, 300.0),    # a whole zone: FullDisruption, no evictions
    ("zone-0", 0.34, 9, 1.0),     # a third of a zone: the node drains
])
def test_partition_and_heal_under_the_ports_nodelifecycle_as_in_jax(
        zone, fraction, n_nodes, eviction_wait):
    def run(pkg):
        clock = FakeClock()
        store = mod(pkg, "runtime.store").ObjectStore()
        hc = mod(pkg, "kubemark").HollowCluster(store, n_nodes=n_nodes,
                                                zones=3, clock=clock)
        nlc, ctrl = _lifecycle(pkg, store, clock,
                               eviction_wait=eviction_wait)
        try:
            for i in range(0, n_nodes, 3):  # zone-0's members
                store.create("pods", plain_pod(pkg, f"w-hollow-{i}",
                                               node_name=f"hollow-{i}"))
            cut = hc.partition(zone=zone, fraction=fraction)
            steps = []
            for _ in range(5):
                clock.advance(5)
                for n in hc.nodes:
                    n.kubelet.heartbeat(clock.t)  # severed ones no-op
                ctrl.monitor()
                steps.append((dict(ctrl.zone_states), _taints(store),
                              _pods(store)))
            hc.heal(cut)
            clock.advance(5)
            for n in hc.nodes:
                n.kubelet.heartbeat(clock.t)
            ctrl.monitor()
            steps.append((dict(ctrl.zone_states), _taints(store),
                          _pods(store)))
            return dict(cut=cut, steps=steps,
                        nodes=objects(pkg, store, "nodes"),
                        full=nlc.ZONE_FULL)
        finally:
            hc.stop()

    got = both(run)
    zk = ":\x00:zone-0"
    unreachable = [("node.kubernetes.io/unreachable", "NoExecute")]
    states, taints, pods = got["steps"][-2]
    assert all(taints[c] == unreachable for c in got["cut"])
    if fraction == 1.0:
        assert got["cut"] == ["hollow-0", "hollow-3"]
        assert states[zk] == got["full"]
        assert pods == ["w-hollow-0", "w-hollow-3"]  # suspended
    else:
        assert got["cut"] == ["hollow-0"]
        assert pods == ["w-hollow-3", "w-hollow-6"]  # evicted at the rate
    # healed: every taint gone, nothing more evicted
    states, taints, healed = got["steps"][-1]
    assert not any(taints.values()) and healed == pods


# -- the fault seams ----------------------------------------------------------


@pytest.mark.parametrize("mode,arg", [("drop", 0.0), ("latency", 0.001)])
def test_heartbeat_deliver_as_in_jax(mode, arg):
    """tests/test_partition.py:334 in both packages: a dropped heartbeat
    never reaches the store (the annotation stays stale), a delayed one
    lands; the hits count once a heartbeat."""
    def run(pkg):
        clock = FakeClock(100.0)
        store = mod(pkg, "runtime.store").ObjectStore()
        kl = mod(pkg, "kubelet").Kubelet(store, "n1", clock=clock,
                                         heartbeat_period=1.0)
        kl.heartbeat(clock.t)
        clock.advance(50)
        arm(pkg, "heartbeat.deliver", mode, arg=arg, times=2)
        kl.heartbeat(clock.t)
        after_one = objects(pkg, store, "nodes")
        kl.heartbeat(clock.t + 1)
        kl.heartbeat(clock.t + 2)  # the budget is spent: delivers
        return dict(after_one=after_one, hits=hits(pkg, "heartbeat.deliver"),
                    nodes=objects(pkg, store, "nodes"))

    got = both(run)
    assert got["hits"] == 2
    beat = got["after_one"][0]["metadata"]["annotations"]["heartbeat"]
    assert beat == ("100.0" if mode == "drop" else "150.0")
    assert got["nodes"][0]["metadata"]["annotations"]["heartbeat"] == "152.0"


@pytest.mark.parametrize("mode,arg", [("drop", 0.0), ("latency", 0.001)])
def test_watch_deliver_as_in_jax(mode, arg):
    """A dropped delivery leaves every watcher stale, the scheduler's
    too: the pod stays pending in the store, unseen, while the next one
    places; a delayed delivery is a plain delivery. A relisting informer
    converges (tests/test_faults.py:80)."""
    def run(pkg):
        clock = FakeClock()
        store = mod(pkg, "runtime.store").ObjectStore()
        hc = mod(pkg, "kubemark").HollowCluster(store, n_nodes=2,
                                                clock=clock)
        inf = mod(pkg, "runtime.informer").SharedInformer(store, "pods")
        sched = _scheduler(pkg, store, clock)
        try:
            arm(pkg, "watch.deliver", mode, arg=arg, times=1)
            store.create("pods", plain_pod(pkg, "px", cpu="100m",
                                           memory="64Mi"))
            store.create("pods", plain_pod(pkg, "py", cpu="100m",
                                           memory="64Mi"))
            placed = _drain(sched, 2)
            seen = inf.get("default", "px") is not None
            relist = mod(pkg, "runtime.informer").SharedInformer(
                store, "pods").get("default", "px") is not None
            hc.sync_once()
            return dict(placed=placed, seen=seen, relist=relist,
                        hits=hits(pkg, "watch.deliver"),
                        pending=sched.queue.pending_count(),
                        pods=objects(pkg, store, "pods"))
        finally:
            sched.close()
            hc.stop()

    got = both(run)
    assert got["hits"] == 1 and got["relist"]
    phases = [(p["metadata"]["name"], p["spec"]["nodeName"],
               p["status"]["phase"]) for p in got["pods"]]
    if mode == "drop":
        assert (got["placed"], got["seen"]) == (1, False)
        assert phases == [("px", "", "Pending"),
                          ("py", "hollow-0", "Running")]
    else:
        assert (got["placed"], got["seen"]) == (2, True)
        assert phases == [("px", "hollow-0", "Running"),
                          ("py", "hollow-1", "Running")]


# -- the gang rollback hook ---------------------------------------------------


@pytest.mark.parametrize("rollback", [True, False])
def test_a_failed_gang_commit_leaves_the_same_assumed_members_as_jax(
        rollback):
    """A gang commit whose second member fails the exact recheck: with
    the rollback the first member is forgotten; with the hook off (the
    broken build) it stays assumed, in both packages."""
    def run(pkg):
        store = mod(pkg, "runtime.store").ObjectStore()
        store.create("nodes", plain_node(pkg, "big", cpu="4"))
        store.create("nodes", plain_node(pkg, "small", cpu="1"))
        sched = _scheduler(pkg, store, FakeClock())
        sched._gang_rollback_enabled = rollback
        try:
            pods = [plain_pod(pkg, f"g{i}", cpu="2", memory="64Mi",
                              gang="g", min_avail=2) for i in range(2)]
            with sched._mu:
                ok = sched._commit_gang([(pods[0], "big"),
                                         (pods[1], "small")])
            assumed = sorted((p.metadata.name, p.spec.node_name)
                             for p in sched.cache.assumed_pods())
            used = {n: ni.requested.milli_cpu
                    for n, ni in sched.cache.node_infos.items()}
            return dict(ok=ok, assumed=assumed, used=used)
        finally:
            sched.close()

    got = both(run)
    assert got["ok"] is False
    assert got["assumed"] == ([] if rollback else [("g0", "big")])
    assert got["used"] == {"big": 0 if rollback else 2000, "small": 0}
