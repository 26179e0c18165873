"""kubernetes_tpu_torch's client layer and scheduler configuration
against kubernetes_tpu's.

- Config: the fields and defaults of LeaderElectionConfig and
  KubeSchedulerConfiguration (sched/config.py) are JAX's; `load` of the
  same JSON file and of the same YAML file gives equal objects; the
  kube-scheduler's `main` parses the same argv into equal configs and
  the same `run` arguments.
- RemoteStore (client/reflector.py) against a JAX APIServer mirrors the
  same objects as JAX's RemoteStore, through the initial LIST and the
  watch that follows; its writes map 409 and 404 the same way, and the
  `store.outage` seam of its writes fires as often.
- The reflector's outage ladder (tests/test_outage.py
  TestReflectorFullOutage's scenario, made deterministic: a scripted
  client, a pinned jitter and a virtual clock): relists, the backoff
  ladder at each cycle, the store breaker's transitions, the error
  series and the hits of `reflector.relist` and `store.outage` are
  equal in both packages.
- LeaderElector (client/leaderelection.py): on a virtual clock over one
  in-process store, two candidates per package step in lockstep and hold
  the same lease records, one leader at a time, the standby taking over
  after a stopped leader's lease expires; `lease.renew` fires as often
  in both. Then two threaded candidates over a RemoteStore against the
  port's own APIServer: one leader, and a failover.
"""

import dataclasses
import json
import signal
import threading
import time

import pytest

from kubernetes_tpu.api import scheme as jscheme
from kubernetes_tpu.api import types as japi
from kubernetes_tpu.cli import kube_scheduler as jks
from kubernetes_tpu.client import leaderelection as jle
from kubernetes_tpu.client import reflector as jrefl
from kubernetes_tpu.client import rest as jrest
from kubernetes_tpu.runtime.store import ObjectStore as JaxStore
from kubernetes_tpu.sched import config as jcfg
from kubernetes_tpu.sched import storehealth as jsh
from kubernetes_tpu.server import APIServer as JaxAPIServer
from kubernetes_tpu.utils import faultpoints as jfp
from kubernetes_tpu.utils import metrics as jmetrics
from kubernetes_tpu_torch.api import scheme as tscheme
from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.cli import kube_scheduler as tks
from kubernetes_tpu_torch.client import leaderelection as tle
from kubernetes_tpu_torch.client import reflector as trefl
from kubernetes_tpu_torch.client import rest as trest
from kubernetes_tpu_torch.runtime.store import ObjectStore as TorchStore
from kubernetes_tpu_torch.sched import config as tcfg
from kubernetes_tpu_torch.sched import storehealth as tsh
from kubernetes_tpu_torch.server import APIServer as TorchAPIServer
from kubernetes_tpu_torch.utils import faultpoints as tfp
from kubernetes_tpu_torch.utils import metrics as tmetrics

from torch_guard import faults_off  # noqa: F401

PKGS = {
    "jax": dict(api=japi, scheme=jscheme, ks=jks, le=jle, refl=jrefl,
                rest=jrest, cfg=jcfg, sh=jsh, fp=jfp, metrics=jmetrics,
                Store=JaxStore),
    "torch": dict(api=tapi, scheme=tscheme, ks=tks, le=tle, refl=trefl,
                  rest=trest, cfg=tcfg, sh=tsh, fp=tfp, metrics=tmetrics,
                  Store=TorchStore),
}


def stop_remote(store, srv=None):
    """Stop a RemoteStore's reflectors and wait for their threads: the
    server's watchers are stopped so that each open stream ends at once
    instead of at its timeout."""
    store.stop()
    if srv is not None:
        for w in list(srv.broadcaster._watchers):
            w.stop()
    for refl in store._reflectors.values():
        refl._thread.join(timeout=15)
        assert not refl._thread.is_alive()


# --- configuration --------------------------------------------------------------


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
            if dataclasses.is_dataclass(default):
                default = dataclasses.asdict(default)
        else:
            default = f.default
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", ["LeaderElectionConfig",
                                  "KubeSchedulerConfiguration"])
def test_config_fields_and_defaults_match_jax(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


CONFIG = {
    "schedulerName": "tpu-scheduler", "waveSize": 64,
    "disablePreemption": True, "hardPodAffinitySymmetricWeight": 3,
    "healthzPort": 0, "scrubInterval": 2.5, "breakerThreshold": 5,
    "storeBreakerCooldown": 4.0, "bindJournalPath": "/dev/null/j",
    "shedWatermark": 100, "tracing": True, "traceRounds": 16,
    "featureGates": {"VolumeScheduling": True}, "notAField": 1,
    "leaderElection": {"leaderElect": True, "leaseDuration": 1.5,
                       "renewDeadline": 1.0, "retryPeriod": 0.25,
                       "lockName": "sched-lock", "bogus": 2},
}


def test_load_json_matches_jax(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(CONFIG))
    want = jcfg.KubeSchedulerConfiguration.load(str(path))
    got = tcfg.KubeSchedulerConfiguration.load(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.leader_election.lease_duration == 1.5
    assert got.wave_size == 64 and not hasattr(got, "not_a_field")


def test_load_yaml_matches_jax(tmp_path):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(CONFIG))
    want = jcfg.KubeSchedulerConfiguration.load(str(path))
    got = tcfg.KubeSchedulerConfiguration.load(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.scheduler_name == "tpu-scheduler"


ARGV = ["--server", "http://127.0.0.1:1", "--token", "t",
        "--scheduler-name", "s2", "--leader-elect", "--disable-preemption",
        "--wave-size", "32", "--mesh-devices", "0", "--mesh-min-devices",
        "1", "--scrub-interval", "3", "--compact-interval", "4",
        "--hbm-budget-bytes", "1000000", "--healthz-port", "-1",
        "--feature-gates", "VolumeScheduling=true,PodPriority=false,X",
        "--profiling", "--tracing", "--trace-rounds", "8",
        "--round-ledger", "/dev/null/l", "--round-ledger-max-bytes", "0",
        "--weight-profiles", "/dev/null/w", "--shadow-exact-interval", "2",
        "--racecheck", "--shed-watermark", "9",
        "--shed-priority-threshold", "7", "--shed-age", "1.5",
        "--wave-deadline", "0.5", "--bind-journal", "/dev/null/b",
        "--spool-watermark", "5", "--store-breaker-threshold", "2",
        "--store-breaker-cooldown", "6", "--once"]


@pytest.mark.parametrize("with_config", [False, True])
def test_main_parses_argv_as_jax(with_config, tmp_path, monkeypatch):
    argv = list(ARGV)
    if with_config:
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(CONFIG))
        argv += ["--config", str(path)]
    got = {}
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for side, mods in PKGS.items():
            def fake_run(cfg, server, side=side, **kw):
                kw.pop("stop")
                got[side] = (dataclasses.asdict(cfg), server, kw)
                return 0

            monkeypatch.setattr(mods["ks"], "run", fake_run)
            assert mods["ks"].main(argv) == 0
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    want_cfg, want_server, want_kw = got["jax"]
    cfg, server, kw = got["torch"]
    assert kw.pop("device") is None  # the card, no flag
    assert (cfg, server, kw) == (want_cfg, want_server, want_kw)
    assert cfg["feature_gates"] == {"VolumeScheduling": True,
                                    "PodPriority": False, "X": True}


def test_help_lists_every_flag_of_jax(capsys):
    text = {}
    for side, mods in PKGS.items():
        with pytest.raises(SystemExit):
            mods["ks"].main(["--help"])
        text[side] = capsys.readouterr().out
    assert text["torch"] == text["jax"]


# --- RemoteStore against a JAX APIServer -----------------------------------------


def _node(api, name, zone):
    return api.Node(
        metadata=api.ObjectMeta(name=name, uid=f"uid-{name}",
                                labels={api.LABEL_HOSTNAME: name,
                                        "zone": zone}),
        status=api.NodeStatus(allocatable=api.resource_list(
            cpu="4", memory="8Gi", pods=110)))


def _pod(api, name, node=""):
    return api.Pod(
        metadata=api.ObjectMeta(name=name, uid=f"uid-{name}",
                                labels={"app": "w"}),
        spec=api.PodSpec(node_name=node, containers=[api.Container(
            resources=api.ResourceRequirements(
                requests=api.resource_list(cpu="100m", memory="64Mi")))]))


def _mirror(store, scheme, kind):
    return sorted((o.metadata.name, json.dumps(scheme.encode_object(o),
                                               sort_keys=True))
                  for o in store.list(kind))


def _wait(cond, timeout=10.0, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def test_remote_store_mirrors_the_jax_server_as_jax_does():
    jstore = JaxStore()
    for i in range(6):
        jstore.create("nodes", _node(japi, f"n{i}", f"z{i % 2}"))
    for i in range(10):
        jstore.create("pods", _pod(japi, f"p{i}", node=f"n{i % 3}"
                                   if i % 2 else ""))
    srv = JaxAPIServer(jstore).start()
    remotes = {}
    try:
        for side, mods in PKGS.items():
            rs = mods["refl"].RemoteStore(mods["rest"].RESTClient(srv.url),
                                          metrics=mods["metrics"].Metrics())
            for kind in ("nodes", "pods"):
                rs.mirror(kind)
            assert rs.wait_for_sync()
            remotes[side] = rs
        for kind in ("nodes", "pods"):
            assert (_mirror(remotes["torch"], tscheme, kind)
                    == _mirror(remotes["jax"], jscheme, kind))
            assert len(remotes["torch"].list(kind)) == (6 if kind == "nodes"
                                                        else 10)
        # a write through the port's store lands on the server and comes
        # back to both mirrors through their watches
        remotes["torch"].create("pods", _pod(tapi, "late"))
        remotes["torch"].bind(remotes["torch"].get("pods", "default", "p0"),
                              "n5")
        remotes["torch"].delete("pods", "default", "p2")
        for side, rs in remotes.items():
            _wait(lambda rs=rs: (rs.get("pods", "default", "late") is not None
                                 and rs.get("pods", "default", "p2") is None
                                 and rs.get("pods", "default", "p0")
                                 .spec.node_name == "n5"), msg=side)
        assert (_mirror(remotes["torch"], tscheme, "pods")
                == _mirror(remotes["jax"], jscheme, "pods"))
        # errors map as in JAX: 409 -> Conflict, 404 -> KeyError; the
        # store.outage seam of _guard fires once a write in both packages
        # (an answer, 409 and 404 too, counts as the store reachable)
        hits = {}
        for side, mods in PKGS.items():
            rs = remotes[side]
            store_mod = __import__(
                {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}
                [side] + ".runtime.store", fromlist=["Conflict"])
            health = mods["sh"].StorePathBreaker(threshold=3)
            rs.set_health(health)
            mods["fp"].activate("store.outage", "latency", arg=0.0)
            rs.create("pods", _pod(mods["api"], f"w-{side}"))
            with pytest.raises(store_mod.Conflict):
                rs.create("pods", _pod(mods["api"], f"w-{side}"))
            with pytest.raises(KeyError):
                rs.delete("pods", "default", "nope")
            rs.delete("pods", "default", f"w-{side}")
            hits[side] = (mods["fp"].hits("store.outage"), health.state,
                          health.failures)
            mods["fp"].reset()
            assert rs.latest_resource_version > 0
        assert hits["torch"] == hits["jax"] == (4, "connected", 0)
    finally:
        for rs in remotes.values():
            stop_remote(rs, srv)
        srv.stop()


# --- the reflector's outage ladder -------------------------------------------------


class _ScriptedClient:
    """A LIST that answers [] at rv 7, and a watch that first advances
    the reflector's clock past its staleness deadline (one forced
    relist), then stops the reflector: a fixed number of cycles."""

    def __init__(self, clock):
        self.clock = clock
        self.lists = 0
        self.watches = 0
        self.reflector = None

    def list(self, plural, timeout=None):
        self.lists += 1
        return [], 7

    def watch(self, plural, resource_version=None, timeout_seconds=10.0,
              stop=None, label_selector=None):
        self.watches += 1
        if self.watches == 1:
            self.clock[0] += 6.0  # past stale_after
        else:
            self.reflector.stop()
        return iter(())


def _ladder_run(side, fails):
    mods = PKGS[side]
    metrics = mods["metrics"].Metrics()
    states = []
    health = mods["sh"].StorePathBreaker(
        threshold=3, cooldown=60.0, jitter=lambda: 0.5,
        on_state=states.append)
    clock = [0.0]
    client = _ScriptedClient(clock)
    ladder = []
    refl = mods["refl"].Reflector(
        client, "pods", lambda ev: None, relist_backoff=0.001,
        max_relist_backoff=0.004, stale_after=5.0, metrics=metrics,
        health=health, clock=lambda: clock[0], jitter=lambda: 0.5)
    client.reflector = refl
    real_wait = refl._backoff_wait

    def wait(backoff):
        ladder.append(backoff)
        return real_wait(backoff)

    refl._backoff_wait = wait
    mods["fp"].activate("store.outage", "raise", times=fails)
    mods["fp"].activate("reflector.relist", "latency", arg=0.0)
    refl.run()  # on this thread: the scripted client ends it
    out = {
        "relists": refl.relists, "stale_relists": refl.stale_relists,
        "ladder": ladder, "backoff": refl.backoff,
        "synced": refl.synced.is_set(), "last_sync_rv": refl.last_sync_rv,
        "breaker": health.state, "transitions": states,
        "lists": client.lists,
        "store_errors_list": metrics.store_errors.value(op="list"),
        "reflector_errors": metrics.scheduling_errors.value(
            stage="reflector"),
        "relist_series": metrics.reflector_relists.value,
        "watch_stale": metrics.watch_stale.value,
        "hits": {p: mods["fp"].hits(p)
                 for p in ("store.outage", "reflector.relist")},
    }
    mods["fp"].reset()
    return out


@pytest.mark.parametrize("fails", [2, 5])
def test_reflector_outage_ladder_matches_jax(fails):
    want, got = _ladder_run("jax", fails), _ladder_run("torch", fails)
    assert got == want
    # the ladder climbed to its cap and the breaker tripped, then the
    # first clean cycle reconnected it; the staleness watchdog forced one
    # more relist after the heal
    assert got["hits"]["store.outage"] == fails
    assert got["relists"] == fails + 2 and got["stale_relists"] == 1
    if fails >= 3:
        assert max(got["ladder"]) == 0.004
        assert "disconnected" in got["transitions"]
    assert got["breaker"] == "connected" and got["synced"]


# --- leader election ---------------------------------------------------------------


def _lease_state(store):
    rec = store.get("leases", "default", "kube-scheduler")
    if rec is None:
        return None
    return (rec.holder_identity, rec.acquire_time, rec.renew_time,
            rec.leader_transitions, rec.lease_duration_seconds)


def _elect_run(side):
    """Two candidates over one in-process store on a virtual clock,
    stepped by hand: a acquires, b waits, a stops renewing, b takes over
    once a's lease expires."""
    mods = PKGS[side]
    store = mods["Store"]()
    now = [100.0]
    a, b = (mods["le"].LeaderElector(store, ident, lease_duration=2.0,
                                     renew_deadline=1.5, retry_period=0.5,
                                     clock=lambda: now[0])
            for ident in ("a", "b"))
    mods["fp"].activate("lease.renew", "latency", arg=0.0)
    trace = []
    for t in range(12):
        got_a = a._try_acquire_or_renew() if t < 4 else None
        got_b = b._try_acquire_or_renew()
        trace.append((t, got_a, got_b, _lease_state(store)))
        now[0] += 0.5
    hits = mods["fp"].hits("lease.renew")
    mods["fp"].reset()
    return trace, hits


def test_leader_election_steps_match_jax():
    want, got = _elect_run("jax"), _elect_run("torch")
    assert got == want
    trace, hits = got
    holders = [s[3][0] for s in trace]
    assert holders[0] == "a" and holders[-1] == "b"
    assert not any(ga and gb for _, ga, gb, _ in trace)  # never co-leaders
    assert trace[-1][3][3] == 1  # one transition
    assert hits == 4 + 12


def test_two_candidates_over_the_port_server_one_leader_and_failover():
    srv = TorchAPIServer(TorchStore()).start()
    store = trefl.RemoteStore(trest.RESTClient(srv.url))
    a = tle.LeaderElector(store, "a", lease_duration=1.0, retry_period=0.05)
    b = tle.LeaderElector(store, "b", lease_duration=1.0, retry_period=0.05)
    a_started, b_started = threading.Event(), threading.Event()
    a.on_started_leading = a_started.set
    b.on_started_leading = b_started.set
    try:
        a.start()
        assert a_started.wait(10)
        b.start()
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline:
            assert not (a.is_leader and b.is_leader)
            time.sleep(0.02)
        a.stop()
        assert b_started.wait(20)
        _wait(lambda: store.get("leases", "default", "kube-scheduler")
              .holder_identity == "b", msg="the lease mirror")
        rec = store.get("leases", "default", "kube-scheduler")
        assert rec.leader_transitions >= 1
    finally:
        a.stop()
        b.stop()
        for e in (a, b):
            if e._thread is not None:
                e._thread.join(timeout=10)
        stop_remote(store, srv)
        srv.stop()
