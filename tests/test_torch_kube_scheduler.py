"""kubernetes_tpu_torch's deployed kube-scheduler (cli/kube_scheduler.py)
against kubernetes_tpu's, each over HTTP against its package's own
APIServer.

- The repairs the CLI loop needs: the queue's `pop_wave(max_n,
  timeout=...)` waits on the JAX queue's condition variable (a pod added
  from another thread while it waits is returned, an empty queue answers
  [] after the timeout) and `run_once(timeout=...)` passes it on; the
  Scheduler takes JAX's `metrics`, `bind_workers`, `racecheck`,
  `mesh_min_devices` and `invariants` keywords (a shared registry, the
  bind pool, the lock-order watcher under JAX's lock names; a mesh of
  more than one device and the invariant checker raise
  NotImplementedError).
- The deployed drain, lockstep: JAX's `run(cfg, url, once=True)` against
  a JAX APIServer and the port's `run(..., device="cpu")` against the
  port's APIServer, over one world built once in the JAX package and
  carried to the port through the wire codec (uids kept): 24 nodes in
  three zones and a dedicated tainted node with a low-priority hog,
  density pods, pods with required pod affinity and anti-affinity, a gang
  of 4, and a pod whose priority is above the hog's only, which places
  only by preempting the hog (it sorts last, so it fails in the last
  wave); waves of 16, tracing on, the bind pool binding over REST. The
  bindings read back over REST, the nominations, the pods left, /metrics
  (less the wall-clock readings: `untimed`), /debug/store, /debug/score
  (the index and every pod's decision), /debug/shadow and
  /debug/autopilot (404) are equal. Run plainly, with a Policy file and
  under --leader-elect. Each side's backoff is pinned at 600 s so that a
  failed pod cannot come back within the run at a moment set by the
  wall clock.
- The truth GET and the bind pool: a bind whose response is lost over
  REST is confirmed once, through a truth GET that goes through the
  REST client (never the reflector mirror), as in JAX; and
  `recover_leadership` resolves the same assumed pods over the pool
  (confirmed, orphaned, deleted) as JAX's does.
"""

import copy
import json
import signal
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

from kubernetes_tpu.api import scheme as jscheme
from kubernetes_tpu.cli import kube_scheduler as jks
from kubernetes_tpu.client import reflector as jrefl
from kubernetes_tpu.client import rest as jrest
from kubernetes_tpu.runtime.store import ObjectStore as JaxStore
from kubernetes_tpu.sched import config as jcfg
from kubernetes_tpu.sched import queue as jqueue
from kubernetes_tpu.sched.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.server import APIServer as JaxAPIServer
from kubernetes_tpu.utils import metrics as jmetrics
from kubernetes_tpu.utils.backoff import PodBackoff as JaxBackoff
from kubernetes_tpu_torch.api import scheme as tscheme
from kubernetes_tpu_torch.cli import kube_scheduler as tks
from kubernetes_tpu_torch.client import reflector as trefl
from kubernetes_tpu_torch.client import rest as trest
from kubernetes_tpu_torch.runtime.store import ObjectStore as TorchStore
from kubernetes_tpu_torch.sched import config as tcfg
from kubernetes_tpu_torch.sched import queue as tqueue
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TorchScheduler
from kubernetes_tpu_torch.server import APIServer as TorchAPIServer
from kubernetes_tpu_torch.utils import metrics as tmetrics
from kubernetes_tpu_torch.utils.backoff import PodBackoff as TorchBackoff

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_worlds import HOSTNAME, ZONE, plain_node, plain_pod

PKG = {
    "jax": SimpleNamespace(
        ks=jks, Store=JaxStore, APIServer=JaxAPIServer,
        Backoff=JaxBackoff, rest=jrest, refl=jrefl, cfg=jcfg,
        queue=jqueue, Scheduler=JaxScheduler, metrics=jmetrics, kw={}),
    "torch": SimpleNamespace(
        ks=tks, Store=TorchStore, APIServer=TorchAPIServer,
        Backoff=TorchBackoff, rest=trest, refl=trefl, cfg=tcfg,
        queue=tqueue, Scheduler=TorchScheduler, metrics=tmetrics,
        kw={"device": "cpu"}),
}

# the /metrics families whose values are wall-clock readings: the
# histograms of seconds (their buckets and sums; the _count lines, the
# number of observations, are compared), the queue's class gauges
# (exported on a one-second cadence of the real clock) and the upload
# bytes (how many rows a wave uploads depends on how many bind echoes of
# the reflector's watch arrived before it; both vary from run to run
# within one package); and the compile-cache series, whose hits and
# misses depend on what the test's process ran before it. Every other
# line of /metrics is compared.
TIME_SERIES = ("binding_latency", "e2e_scheduling_latency",
               "gang_wait_seconds", "pod_scheduling_latency",
               "scheduling_algorithm_latency",
               "scheduling_algorithm_predicate_evaluation",
               "scheduling_algorithm_preemption_evaluation",
               "scheduling_algorithm_priority_evaluation",
               "snapshot_scrub_duration_seconds")
UNTIMED_SKIP = ("scheduler_queue_class_pods", "snapshot_upload_bytes_total",
                "device_jit_cache_events_total", "device_jit_compile_seconds")


def untimed(text: str) -> list:
    """The /metrics lines less the wall-clock readings and the
    compile-cache series."""
    out = []
    for ln in text.splitlines():
        name = ln.split()[2] if ln.startswith("# TYPE") else ln
        family = name.partition("{")[0].split()[0]
        if family.startswith(UNTIMED_SKIP):
            continue
        if any(family in (f"{h}_bucket", f"{h}_sum") for h in TIME_SERIES):
            continue
        out.append(ln)
    return out


# --- the repairs: the queue's wait and the constructor's keywords ---------------


def _pod(side, name, priority=None):
    return plain_pod(side == "jax" and "kubernetes_tpu"
                     or "kubernetes_tpu_torch", name, cpu="100m",
                     memory="64Mi", priority=priority)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_pop_wave_waits_for_a_pod_added_from_another_thread(side):
    q = PKG[side].queue.SchedulingQueue()
    t0 = time.monotonic()
    assert q.pop_wave(4, timeout=0.1) == []
    assert time.monotonic() - t0 >= 0.09
    adder = threading.Timer(0.1, lambda: q.add(_pod(side, "late")))
    adder.start()
    t0 = time.monotonic()
    got = q.pop_wave(4, timeout=10.0)
    adder.join()
    assert [p.metadata.name for p in got] == ["late"]
    assert time.monotonic() - t0 < 5.0  # woken by the add
    # a wave still drains in priority order after the first pod
    for i, prio in enumerate((1, 5, 3)):
        q.add(_pod(side, f"p{i}", priority=prio))
    assert [p.metadata.name for p in q.pop_wave(2, timeout=0.0)] == \
        ["p1", "p2"]
    q.close()
    assert [p.metadata.name for p in q.pop_wave(2)] == ["p0"]
    assert q.pop_wave(2) == []  # closed: no wait


def test_pop_wave_matches_jax_in_lockstep():
    """The same adds and pops on both queues give the same waves; a pod
    whose backoff deadline passes while pop_wave waits is returned, in
    both packages."""
    qs = {side: PKG[side].queue.SchedulingQueue() for side in PKG}
    for side, q in qs.items():
        for i in range(5):
            q.add(_pod(side, f"p{i}", priority=i % 2))
    got = {side: [p.metadata.name for p in q.pop_wave(3, timeout=0.0)]
           for side, q in qs.items()}
    assert got["torch"] == got["jax"] == ["p1", "p3", "p0"]
    got = {}
    for side, q in qs.items():
        assert [p.metadata.name for p in q.pop_wave(8, timeout=0.0)] == \
            ["p2", "p4"]
        parked = _pod(side, "parked")
        q.set_backoff(parked.uid, time.monotonic() + 0.1)
        q.add_unschedulable_if_not_present(parked)
        q.move_all_to_active()  # into the backoff area, not the heap
        assert q.pop_wave(8, timeout=0.0) == []
        t0 = time.monotonic()
        got[side] = [p.metadata.name for p in q.pop_wave(8, timeout=10.0)]
        assert 0.05 <= time.monotonic() - t0 < 5.0
    assert got["torch"] == got["jax"] == ["parked"]


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_run_once_takes_a_timeout(side):
    m = PKG[side]
    sched = m.Scheduler(m.Store(), **m.kw)
    t0 = time.monotonic()
    assert sched.run_once(timeout=0.15) == 0
    assert time.monotonic() - t0 >= 0.14
    assert sched.run_once() == 0  # no wait by default


def test_scheduler_takes_the_jax_keywords():
    shared = tmetrics.Metrics()
    s = TorchScheduler(TorchStore(), device="cpu", metrics=shared,
                       bind_workers=2, racecheck=True, mesh_min_devices=4)
    assert s.metrics is shared and s.mesh_min_devices == 4
    assert s._bind_pool is None  # the in-process store binds inline
    assert shared.mesh_devices.value == 1
    checked = TorchScheduler(TorchStore(), device="cpu", invariants=True)
    assert checked.invariants is not None and checked.invariants.strict
    assert checked.invariants.metrics is checked.metrics
    cfg = tcfg.KubeSchedulerConfiguration(invariants=True)
    assert tks.build_scheduler(cfg, TorchStore(), device="cpu").invariants
    cfg = tcfg.KubeSchedulerConfiguration(mesh_devices=2)
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        tks.build_scheduler(cfg, TorchStore(), device="cpu")
    for n in (0, 1, -1):
        cfg = tcfg.KubeSchedulerConfiguration(mesh_devices=n)
        assert tks.build_scheduler(cfg, TorchStore(), device="cpu")


def test_racecheck_watches_the_jax_lock_names():
    """The same drive under racecheck on both packages records the same
    lock-order edges under the same names, and no inversion."""
    edges = {}
    for side, m in PKG.items():
        pkg = "kubernetes_tpu" if side == "jax" else "kubernetes_tpu_torch"
        store = m.Store()
        for i in range(4):
            store.create("nodes", plain_node(pkg, f"n{i}"))
        sched = m.Scheduler(store, wave_size=4, racecheck=True, **m.kw)
        for i in range(6):
            store.create("pods", plain_pod(pkg, f"p{i}", cpu="100m",
                                           memory="64Mi"))
        while sched.run_once():
            pass
        w = sched.racecheck_watcher
        w.assert_clean()
        edges[side] = w.edges
    assert edges["torch"] == edges["jax"]
    assert ("Scheduler._mu", "SchedulingQueue._lock") in edges["torch"]


# --- the deployed drain -----------------------------------------------------------


def _world():
    """The lockstep world, built once in the JAX package: [(plural,
    object)] in creation order."""
    pkg = "kubernetes_tpu"
    from kubernetes_tpu.api import labels as lbl
    from kubernetes_tpu.api import types as api

    out = []
    for i in range(24):
        out.append(("nodes", plain_node(pkg, f"n{i}", cpu="8",
                                        memory="16Gi", zone=f"z{i % 3}")))
    taint = api.Taint("dedicated", "vip", api.NO_SCHEDULE)
    vip_node = plain_node(pkg, "vip-node", cpu="4", memory="16Gi",
                          taints=[taint], zone="z0")
    vip_node.metadata.labels["dedicated"] = "vip"
    out.append(("nodes", vip_node))
    tol = api.Toleration(key="dedicated", operator="Equal", value="vip",
                         effect=api.NO_SCHEDULE)
    hog = plain_pod(pkg, "hog", cpu="4", memory="1Gi", priority=1,
                    node_name="vip-node")
    hog.spec.tolerations = [tol]
    out.append(("pods", hog))
    for i, node in enumerate(("n0", "n4", "n8")):
        out.append(("pods", plain_pod(pkg, f"anchor-{i}", cpu="500m",
                                      memory="256Mi", labels={"app": "db"},
                                      node_name=node)))
    for i in range(40):
        out.append(("pods", plain_pod(
            pkg, f"dense-{i}", cpu=f"{(i % 4 + 1) * 250}m",
            memory=f"{(i % 3 + 1) * 256}Mi", priority=10)))

    def near_db(api, lbl):
        return api.Affinity(pod_affinity=api.PodAffinity(required=[
            api.PodAffinityTerm(
                label_selector=lbl.LabelSelector(match_labels={"app": "db"}),
                topology_key=ZONE)]))

    def spread_web(api, lbl):
        return api.Affinity(pod_anti_affinity=api.PodAntiAffinity(required=[
            api.PodAffinityTerm(
                label_selector=lbl.LabelSelector(match_labels={"app": "web"}),
                topology_key=HOSTNAME)]))

    for i in range(6):
        out.append(("pods", plain_pod(pkg, f"near-{i}", cpu="500m",
                                      memory="256Mi", priority=10,
                                      affinity=near_db)))
    for i in range(6):
        out.append(("pods", plain_pod(pkg, f"web-{i}", cpu="500m",
                                      memory="256Mi", priority=10,
                                      labels={"app": "web"},
                                      affinity=spread_web)))
    for i in range(4):
        out.append(("pods", plain_pod(pkg, f"gang-{i}", cpu="1",
                                      memory="512Mi", priority=10,
                                      gang="g1", min_avail=4)))
    # the preemptor sorts after every other pending pod (its priority
    # above the hog's only), so it fails in the last wave: its victim's
    # deletion then reaches the scheduler after the drain's last round
    # and gauge export, never between them, in both packages
    vip = plain_pod(pkg, "vip", cpu="4", memory="1Gi", priority=5)
    vip.spec.tolerations = [tol]
    vip.spec.node_selector = {"dedicated": "vip"}
    out.append(("pods", vip))
    assert lbl is not None
    return out


WORLD = _world()

POLICY = json.dumps({
    "kind": "Policy", "apiVersion": "v1",
    "predicates": [{"name": "PodFitsResources"},
                   {"name": "PodToleratesNodeTaints"},
                   {"name": "MatchNodeSelector"},
                   {"name": "MatchInterPodAffinity"},
                   {"name": "PodFitsHostPorts"}],
    "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                   {"name": "BalancedResourceAllocation", "weight": 2},
                   {"name": "InterPodAffinityPriority", "weight": 1}]})


def _copy_world(side):
    """Deep copies of WORLD for one side: the JAX objects themselves, or
    the port's through the wire codec (uids kept)."""
    if side == "jax":
        return [(plural, copy.deepcopy(obj)) for plural, obj in WORLD]
    return [(plural, tscheme.decode_object(jscheme.encode_object(obj)))
            for plural, obj in WORLD]


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Probe:
    """Stands in for a package's HealthServer class: before the server
    stops (the run's end, its scheduler closed and still queryable), GET
    every endpoint once."""

    def __init__(self, base):
        self.base = base
        self.got = {}
        self.sched = None

    def cls(self):
        probe = self

        class Probing(self.base):
            def stop(self):
                sched = self.scheduler_ref()
                probe.sched = sched
                deadline = time.monotonic() + 60
                # under --leader-elect the JAX loop thread may still be in
                # close() (binds settling) when its run() goes on to stop
                # this server
                while (sched is not None and sched._bind_pool is not None
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                for path in ("/healthz", "/metrics", "/debug/store",
                             "/debug/score", "/debug/shadow",
                             "/debug/autopilot", "/debug/trace?format=ledger"):
                    probe.got[path] = _get(self.port, path)
                code, idx = probe.got["/debug/score"]
                if code == 200:
                    for e in json.loads(idx):
                        path = f"/debug/score?uid={e['uid']}"
                        probe.got[path] = _get(self.port, path)
                super().stop()

        return Probing


def _deployed(side, cfg, monkeypatch, via_main=None):
    """One package's deployed drain over a copy of WORLD. Returns what
    is compared."""
    m = PKG[side]
    store = m.Store()
    for plural, obj in _copy_world(side):
        store.create(plural, obj)
    srv = m.APIServer(store).start()
    probe = _Probe(m.ks.HealthServer)
    monkeypatch.setattr(m.ks, "HealthServer", probe.cls())
    real_build = m.ks.build_scheduler

    def build(*a, **kw):
        sched = real_build(*a, **kw)
        sched.backoff = m.Backoff(initial=600.0, maximum=600.0)
        return sched

    monkeypatch.setattr(m.ks, "build_scheduler", build)
    try:
        if via_main is not None:
            saved = {s: signal.getsignal(s)
                     for s in (signal.SIGTERM, signal.SIGINT)}
            try:
                rc = m.ks.main(["--server", srv.url, "--once", "--tracing"]
                               + via_main, **m.kw)
            finally:
                for s, h in saved.items():
                    signal.signal(s, h)
        else:
            rc = m.ks.run(cfg, srv.url, once=True, tracing_enabled=True,
                          **m.kw)
        assert rc == 0
        pods, _ = m.rest.RESTClient(srv.url).list("pods")
    finally:
        for w in list(srv.broadcaster._watchers):
            w.stop()
        srv.stop()
    sched = probe.sched
    got = probe.got
    scores = {p: json.loads(body) for p, (code, body) in got.items()
              if p.startswith("/debug/score?uid=")}
    return dict(
        rc=rc,
        bindings={p.metadata.name: p.spec.node_name for p in pods},
        nominated={p.metadata.name: p.status.nominated_node_name
                   for p in pods if p.status.nominated_node_name},
        healthz=got["/healthz"],
        metrics=(got["/metrics"][0], untimed(got["/metrics"][1])),
        store=(got["/debug/store"][0], json.loads(got["/debug/store"][1])),
        score_index=json.loads(got["/debug/score"][1]),
        scores=scores,
        shadow=got["/debug/shadow"],
        autopilot=got["/debug/autopilot"],
        ledger_rows=len(got["/debug/trace?format=ledger"][1].splitlines()),
        pending=sched.queue.pending_count(),
        overlap=sched.bind_overlap_hwm,
    )


def _check_lockstep(want, got):
    for key in ("rc", "bindings", "nominated", "healthz", "metrics",
                "store", "score_index", "scores", "shadow", "autopilot",
                "ledger_rows", "pending"):
        assert got[key] == want[key], key
    b = got["bindings"]
    assert "hog" not in b  # the preemption's victim
    assert got["nominated"] == {"vip": "vip-node"} and b["vip"] == ""
    assert sum(1 for n in b.values() if n) == len(b) - 1
    assert len({b[f"web-{i}"] for i in range(6)}) == 6
    assert {b[f"gang-{i}"] != "" for i in range(4)} == {True}
    assert got["autopilot"] == (404, "no autopilot controller attached\n")
    assert got["scores"] and got["overlap"] >= 1


def _cfg(pkg_cfg, tmp_path, **kw):
    cfg = pkg_cfg.KubeSchedulerConfiguration(wave_size=16, healthz_port=0)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_deployed_drain_matches_jax(tmp_path, monkeypatch):
    got = {side: _deployed(side, _cfg(PKG[side].cfg, tmp_path), monkeypatch)
           for side in PKG}
    _check_lockstep(got["jax"], got["torch"])


def test_deployed_drain_with_a_policy_file_matches_jax(tmp_path,
                                                       monkeypatch):
    path = tmp_path / "policy.json"
    path.write_text(POLICY)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"waveSize": 16, "healthzPort": 0}))
    got = {side: _deployed(side, None, monkeypatch, via_main=[
        "--config", str(cfg_path), "--policy-config-file", str(path)])
        for side in PKG}
    _check_lockstep(got["jax"], got["torch"])


def test_deployed_drain_under_leader_election_matches_jax(tmp_path,
                                                          monkeypatch):
    got = {}
    for side, m in PKG.items():
        cfg = _cfg(m.cfg, tmp_path)
        cfg.leader_election.leader_elect = True
        cfg.leader_election.lease_duration = 5.0
        cfg.leader_election.retry_period = 0.2
        got[side] = _deployed(side, cfg, monkeypatch)
    _check_lockstep(got["jax"], got["torch"])


def test_a_loop_error_under_leader_election_raises(tmp_path, monkeypatch):
    """An exception in the loop thread ends run() with that exception,
    not with 0 and pods unbound."""
    store = TorchStore()
    for plural, obj in _copy_world("torch")[:3]:
        store.create(plural, obj)
    srv = TorchAPIServer(store).start()

    def broken(*a, **kw):
        raise RuntimeError("loop failed")

    monkeypatch.setattr(tks, "build_scheduler", broken)
    cfg = _cfg(tcfg, tmp_path, healthz_port=-1)
    cfg.leader_election.leader_elect = True
    cfg.leader_election.retry_period = 0.05
    try:
        with pytest.raises(RuntimeError, match="loop failed"):
            tks.run(cfg, srv.url, once=True, device="cpu")
    finally:
        for w in list(srv.broadcaster._watchers):
            w.stop()
        srv.stop()


# --- the truth GET and the bind pool ----------------------------------------------


def _remote_sched(side, store, srv, **kw):
    m = PKG[side]
    rs = m.refl.RemoteStore(m.rest.RESTClient(srv.url),
                            metrics=m.metrics.Metrics())
    for kind in ("pods", "nodes"):
        rs.mirror(kind)
    assert rs.wait_for_sync()
    sched = m.Scheduler(rs, wave_size=8, metrics=rs.metrics, **m.kw, **kw)
    return rs, sched


def _stop_reflectors(rs, srv):
    """Stop the store's reflectors and wait for their threads: the
    server's watchers are stopped so that each open stream ends at once
    instead of at its timeout."""
    rs.stop()
    for w in list(srv.broadcaster._watchers):
        w.stop()
    for refl in rs._reflectors.values():
        refl._thread.join(timeout=15)
        assert not refl._thread.is_alive()


def _stop(rs, srv):
    _stop_reflectors(rs, srv)
    srv.stop()


def _lost_response(rs):
    """rs.bind lands the POST, then loses the answer once."""
    real = rs.bind
    lost = []

    def bind(pod, node_name):
        real(pod, node_name)
        if not lost:
            lost.append(pod.metadata.name)
            raise ConnectionError("response lost")

    rs.bind = bind
    return lost


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def test_a_lost_bind_response_over_rest_is_confirmed_once_as_in_jax():
    got = {}
    for side, m in PKG.items():
        pkg = "kubernetes_tpu" if side == "jax" else "kubernetes_tpu_torch"
        store = m.Store()
        store.create("nodes", plain_node(pkg, "n0"))
        store.create("pods", plain_pod(pkg, "p0", cpu="1", memory="64Mi"))
        srv = m.APIServer(store).start()
        rs, sched = _remote_sched(side, store, srv)
        sched.reconciler.sleep = lambda d: None
        sched.reconciler.jitter = lambda: 0.5
        truth_via = []
        real_get = rs.get

        def mirror_get(*a, truth_via=truth_via, real_get=real_get):
            truth_via.append(a)
            return real_get(*a)

        echoed = threading.Event()

        def on_pod(ev, echoed=echoed):
            if ev.obj.metadata.name == "p0" and ev.obj.spec.node_name:
                echoed.set()

        # registered after the scheduler's watcher: the RemoteStore runs
        # its watchers in order on the reflector's thread, so once this
        # one has seen the bind's echo the scheduler has handled it (the
        # CONFIRMED pod leaves the assumed set then)
        rs.watch("pods", on_pod)
        lost = _lost_response(rs)
        rs.get = mirror_get
        try:
            assert sched.schedule_pending() == 1
            sched.close()
            assert echoed.wait(20.0), f"{side}: the bind's echo never came"
            pods, _ = m.rest.RESTClient(srv.url).list("pods")
            met = sched.metrics
            got[side] = dict(
                lost=lost, binding={p.metadata.name: p.spec.node_name
                                    for p in pods},
                retries=met.bind_retries.value,
                scheduled=met.pods_scheduled.value,
                errors=sched.store_debug()["errors"],
                breaker=sched.storehealth.state,
                assumed=len(sched.cache.assumed_pods()),
                pods_get=[a for a in truth_via if a[0] == "pods"])
        finally:
            _stop(rs, srv)
    assert got["torch"] == got["jax"]
    assert got["torch"]["binding"] == {"p0": "n0"}
    assert got["torch"]["scheduled"] == 1
    # the truth GET went through the REST client, not the mirror
    assert got["torch"]["pods_get"] == []


def test_recover_leadership_resolves_over_the_bind_pool_as_in_jax():
    """Four assumed pods after a dormant spell whose watch events were
    lost (the reflectors stopped): one bound on the server to its node
    (confirmed), one bound elsewhere by another leader (confirmed, adopted
    there), one still pending (orphaned, re-queued) and one deleted
    (orphaned, dropped). The truth GETs go through the REST client, on
    the bind pool's threads."""
    got = {}
    for side, m in PKG.items():
        pkg = "kubernetes_tpu" if side == "jax" else "kubernetes_tpu_torch"
        store = m.Store()
        for i in range(2):
            store.create("nodes", plain_node(pkg, f"n{i}"))
        srv = m.APIServer(store).start()
        rs, sched = _remote_sched(side, store, srv)
        threads = []
        real_truth = sched._pod_truth

        def truth(pod, real_truth=real_truth, threads=threads):
            threads.append(threading.current_thread().name)
            return real_truth(pod)

        sched._pod_truth = truth
        try:
            sched.enter_dormant()
            api = __import__(pkg + ".api.types", fromlist=["Pod"])
            for i in range(4):
                rs.create("pods", plain_pod(pkg, f"a{i}", cpu="100m",
                                            memory="64Mi"))
            assert _wait(lambda: sched.queue.pending_count() == 4)
            client = m.rest.RESTClient(srv.url)
            with sched._mu:
                for i in range(4):
                    pod = rs.get("pods", "default", f"a{i}")
                    sched.cache.assume_pod(api.with_node_name(pod, "n0"))
            # the watch events of what follows are lost: the reflectors
            # stop, so only a truth GET can see it
            _stop_reflectors(rs, srv)
            client.bind("default", "a0", "n0")
            client.bind("default", "a1", "n1")
            client.delete("pods", "default", "a3")
            stats = sched.recover_leadership()
            got[side] = dict(
                stats=stats, assumed=sorted(p.metadata.name for p in
                                            sched.cache.assumed_pods()),
                pool=all(t.startswith("binder") for t in threads),
                n_truth=len(threads))
            sched.close()
        finally:
            _stop(rs, srv)
    assert got["torch"] == got["jax"]
    assert got["torch"]["stats"] == {"confirmed": 2, "orphaned": 2,
                                     "unresolved": 0}
    assert got["torch"]["pool"] and got["torch"]["n_truth"] == 4


def test_shared_registry_carries_the_reflector_series():
    """The CLI hands one Metrics to the RemoteStore and the Scheduler:
    the reflectors' relists land in the scheduler's registry."""
    store = TorchStore()
    srv = TorchAPIServer(store).start()
    rs, sched = _remote_sched("torch", store, srv)
    try:
        assert sched.metrics is rs.metrics
        assert sched.metrics.reflector_relists.value >= 2
        assert sched._bind_pool is not None  # RemoteStore: async binds
        sched.close()
        assert sched._bind_pool is None
    finally:
        _stop(rs, srv)


def test_a_warm_standby_raises_on_pods_another_leader_bound_as_in_jax():
    """Reference behaviour the port copies (ROADMAP queue 3): a
    scheduler dormant while another leader binds pods keeps those pods
    in its pending queue (the bind echo adopts them into its cache but
    leaves the queue), so the first wave after recover_leadership pops
    one and its assume raises KeyError, in both packages alike."""
    got = {}
    for side, m in PKG.items():
        pkg = "kubernetes_tpu" if side == "jax" else "kubernetes_tpu_torch"
        store = m.Store()
        for i in range(2):
            store.create("nodes", plain_node(pkg, f"n{i}"))
        standby = m.Scheduler(store, wave_size=4, **m.kw)
        standby.enter_dormant()
        leader = m.Scheduler(store, wave_size=4, **m.kw)
        for i in range(6):
            store.create("pods", plain_pod(pkg, f"p{i}", cpu="100m",
                                           memory="64Mi"))
        placed = leader.schedule_pending()
        leader.enter_dormant()
        stale = standby.queue.active_count()
        standby.recover_leadership()
        with pytest.raises(KeyError, match="already in cache") as ei:
            standby.schedule_pending()
        got[side] = (placed, stale, str(ei.value))
    assert got["torch"] == got["jax"] == (6, 6, "'pod p0 already in cache'")
