"""The port's HTTP extenders (kubernetes_tpu_torch/sched/extender.py) and
their sites in its Scheduler, against the JAX package's.

Each package gets its own logging extender: a ThreadingHTTPServer on
127.0.0.1:0 (daemon threads, shut down by the fixture) that answers the
filter, prioritize, bind and preempt verbs as the test sets it and logs
every request as (verb, body bytes). The scenarios run both schedulers
in lockstep (torch_parity.Both: the same store writes, the same virtual
clock) with `profile(pkg, store)` building each package's HTTPExtender
pointed at its own server, and after every step compare, beside
Both.check's stores, queues and SCHED_METRICS, the two request logs byte
for byte and in order, and the binds each extender recorded.

The cases: those of tests/test_extender.py; a legacy filter answered
with `nodes.items`; an `error` answer; a fractional prioritize score at
weight 3 beside a Policy host priority; each path an extender is asked
on (per wave, the exact host path, a gang, the degraded host wave and
degraded gang with the device path faulted open, the pipeline's
bail-out); the preempt verb on every preemption path (`_handle_failure`,
`_fail_gang`, the host path, `_preempt_chunk` through the degraded wave);
an unreachable extender on each path (a port bound and closed: the
connection is refused at once), traced; and an extender bind answered
with HTTP 500 once, then spooled under `store.outage`.
"""

import importlib
import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from kubernetes_tpu.utils import tracing as jtracing
from kubernetes_tpu_torch.plugins.registry import Profile, Registry
from kubernetes_tpu_torch.runtime.store import ObjectStore
from kubernetes_tpu_torch.sched.extender import HTTPExtender
from kubernetes_tpu_torch.sched.scheduler import Scheduler
from kubernetes_tpu_torch.utils import tracing as ttracing

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both, arm, check_faults, disarm
from torch_worlds import (GCE_PD, bindings, multikey_affinity, plain_node,
                          volume_pod)

SIDES = ("jax", "torch")
TRACING = {"jax": jtracing, "torch": ttracing}
KERNEL_POINTS = ("kernel.round", "kernel.wave", "kernel.gang")
OUTAGE = 10 ** 6  # times: a store outage until disarmed
TIMEOUT = 2.0  # http_timeout of every extender here


class Extender:
    """One package's extender endpoint: answers as its fields say and
    logs every request. ban: node names its filter drops; scores: node ->
    its prioritize score (0 if absent); legacy: answer the filter with
    `nodes.items`; error: answer the filter with this error; bind_fail:
    HTTP 500 answers left for the bind verb; drop_first: the preempt verb
    drops the first candidate node; trim: the preempt verb keeps at most
    this many victims a node."""

    def __init__(self):
        self.log = []
        self.bound = []
        self.ban = set()
        self.scores = {}
        self.legacy = False
        self.error = ""
        self.bind_fail = 0
        self.drop_first = False
        self.trim = None
        self._lock = threading.Lock()
        ext = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                verb = self.path.rsplit("/", 1)[-1]
                with ext._lock:
                    ext.log.append((verb, raw))
                    status, out = ext.answer(verb, json.loads(raw))
                body = json.dumps(out).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def answer(self, verb, args):
        if verb == "filter":
            if self.error:
                return 200, {"error": self.error}
            names = [n for n in args["nodenames"] if n not in self.ban]
            failed = {n: "extender said no" for n in args["nodenames"]
                      if n in self.ban}
            if self.legacy:
                return 200, {"nodes": {"items": [
                    {"metadata": {"name": n}} for n in names]},
                    "failedNodes": failed}
            return 200, {"nodenames": names, "failedNodes": failed}
        if verb == "prioritize":
            return 200, [{"host": n, "score": self.scores.get(n, 0)}
                         for n in args["nodenames"]]
        if verb == "bind":
            if self.bind_fail > 0:
                self.bind_fail -= 1
                return 500, {"error": "busy"}
            self.bound.append((args["podName"], args["node"]))
            return 200, {}
        if verb == "preempt":
            victims = args["nodeNameToVictims"]
            nodes = list(victims)[1:] if self.drop_first else list(victims)
            return 200, {"nodeNameToVictims": {
                n: {"pods": victims[n]["pods"][:self.trim]} for n in nodes}}
        return 404, {"error": f"unknown verb {verb}"}

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def exts():
    """side -> its own logging Extender."""
    got = {side: Extender() for side in SIDES}
    yield got
    for e in got.values():
        e.close()


@pytest.fixture
def recorders():
    """Both packages' flight recorders on, off after the test."""
    for mod in TRACING.values():
        mod.disable()
    rec = {side: mod.enable() for side, mod in TRACING.items()}
    yield rec
    for mod in TRACING.values():
        mod.disable()


def closed_port_url():
    """The URL of a port that was bound and closed: refused at once."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def profile_with(urls, **ext_kw):
    """profile(pkg, store) for Both: the package's default profile with
    one HTTPExtender of that package at urls[side]."""

    def build(pkg, store):
        side = "jax" if pkg == "kubernetes_tpu" else "torch"
        reg = importlib.import_module(f"{pkg}.plugins.registry")
        ext = importlib.import_module(f"{pkg}.sched.extender")
        prof = reg.default_profile(store)
        kw = dict(http_timeout=TIMEOUT)
        kw.update(ext_kw)
        prof.extenders = [ext.HTTPExtender(urls[side], **kw)]
        return prof

    return build


def urls_of(exts):
    return {side: e.url for side, e in exts.items()}


def closed_urls():
    url = closed_port_url()
    return {side: url for side in SIDES}


def lockstep(urls, n_nodes=0, ext_kw=None, wave=8, **kw):
    """Both with one extender a side at urls[side] (built with ext_kw),
    and n_nodes nodes n0.. of kw's node keywords (cpu, memory, zone)."""
    node_kw = {k: kw.pop(k) for k in ("cpu", "memory", "zone") if k in kw}
    b = Both(wave=wave, profile=profile_with(urls, **(ext_kw or {})), **kw)
    for i in range(n_nodes):
        b.node(f"n{i}", **node_kw)
    return b


def check_logs(exts):
    """The two extenders saw the same requests, byte for byte and in
    order, and recorded the same binds."""
    j, t = exts["jax"], exts["torch"]
    assert [v for v, _ in t.log] == [v for v, _ in j.log]
    assert t.log == j.log
    assert t.bound == j.bound


def run(b, exts):
    n = b.run()
    check_logs(exts)
    return n


def once(b, exts):
    got = {side: s.run_once() for side, s in b.sched.items()}
    assert got["jax"] == got["torch"], got
    b.check()
    check_logs(exts)
    return got["torch"]


def verbs(ext):
    out = {}
    for v, _ in ext.log:
        out[v] = out.get(v, 0) + 1
    return out


def ext_errors(b):
    return b.sched["torch"].metrics.scheduling_errors.value(stage="extender")


# -- tests/test_extender.py's cases -------------------------------------------


def test_filter_bans_nodes(exts):
    for e in exts.values():
        e.ban = {"n1", "n2"}
    b = lockstep(urls_of(exts),
                 3, dict(filter_verb="filter", node_cache_capable=True))
    b.pod("p1", cpu="100m")
    assert run(b, exts) == 1
    assert bindings(b.stores["torch"])["p1"] == "n0"
    assert verbs(exts["torch"]) == {"filter": 1}
    assert json.loads(exts["torch"].log[0][1]) == {
        "pod": {"name": "p1", "namespace": "default", "uid": "p1"},
        "nodenames": ["n0", "n1", "n2"]}


def test_prioritize_steers(exts):
    for e in exts.values():
        e.scores = {"n1": 10}
    b = lockstep(urls_of(exts),
                 3, dict(prioritize_verb="prioritize", weight=100))
    b.pod("p1", cpu="100m")
    assert run(b, exts) == 1
    assert bindings(b.stores["torch"])["p1"] == "n1"


def test_bind_delegates(exts):
    b = lockstep(urls_of(exts), 1, dict(bind_verb="bind"))
    b.pod("p1", cpu="100m")
    assert run(b, exts) == 1
    assert exts["torch"].bound == [("p1", "n0")]
    # the store mirrors the extender's binding for the informers
    assert bindings(b.stores["torch"])["p1"] == "n0"
    assert json.loads(exts["torch"].log[0][1]) == {
        "podName": "p1", "podNamespace": "default", "podUID": "p1",
        "node": "n0"}


def test_filter_all_banned_is_unschedulable(exts):
    for e in exts.values():
        e.ban = {"n0"}
    b = lockstep(urls_of(exts), 1, dict(filter_verb="filter"))
    b.pod("p1", cpu="100m")
    assert run(b, exts) == 0
    assert bindings(b.stores["torch"])["p1"] == ""
    assert b.sched["torch"].metrics.pods_failed.value == 1


def test_ignorable_extender_down_does_not_block():
    b = lockstep(closed_urls(), 1,
                 dict(filter_verb="filter", prioritize_verb="prioritize",
                      ignorable=True))
    b.pod("p1", cpu="100m")
    assert b.run() == 1
    assert ext_errors(b) == 0


def test_policy_builds_extenders_and_the_scheduler_takes_them():
    """A Policy's extenders build the port's HTTPExtender field for field
    as the JAX Registry builds its own, and the port's Scheduler takes
    the profile (it used to refuse it)."""
    from kubernetes_tpu.plugins.registry import Registry as JaxRegistry

    policy = json.dumps({"extenders": [
        {"urlPrefix": "http://example.invalid/sched/", "filterVerb": "filter",
         "weight": 3},
        {"urlPrefix": "http://127.0.0.1:1", "prioritizeVerb": "prio",
         "bindVerb": "bind", "preemptVerb": "preempt", "httpTimeout": 1.5,
         "nodeCacheCapable": True, "ignorable": True}]})
    got = Registry().profile_from_policy(policy)
    want = JaxRegistry().profile_from_policy(policy)
    assert [type(e) for e in got.extenders] == [HTTPExtender] * 2
    assert [vars(e) for e in got.extenders] == [vars(e)
                                                 for e in want.extenders]
    assert got.extenders[0].url_prefix == "http://example.invalid/sched"
    assert got.extenders[0].weight == 3
    assert got.extenders[1].supports_preemption()
    sched = Scheduler(ObjectStore(), device="cpu", profile=got)
    assert sched.profile.extenders == got.extenders
    sched = Scheduler(ObjectStore(), device="cpu",
                      profile=Profile(extenders=got.extenders[1:]))
    assert len(sched.profile.extenders) == 1


# -- wire modes and answers ---------------------------------------------------


def test_legacy_filter_answered_with_node_items(exts):
    """nodeCacheCapable false: the request carries every node with its
    labels, and the answer's `nodes.items` is read as the feasible set."""
    for e in exts.values():
        e.ban = {"n0", "n2"}
        e.legacy = True
    b = lockstep(urls_of(exts), 4, dict(filter_verb="filter"), zone="z0")
    for i in range(3):
        b.pod(f"p{i}", cpu="1")
    assert run(b, exts) == 3
    got = bindings(b.stores["torch"])
    assert {got[f"p{i}"] for i in range(3)} <= {"n1", "n3"}
    body = json.loads(exts["torch"].log[0][1])
    assert list(body) == ["pod", "nodenames", "nodes"]
    assert body["nodes"]["items"][1] == {"metadata": {"name": "n1", "labels": {
        "kubernetes.io/hostname": "n1",
        "failure-domain.beta.kubernetes.io/zone": "z0"}}}


def test_error_answer_parks_even_when_ignorable(exts):
    for e in exts.values():
        e.error = "no capacity data"
    b = lockstep(urls_of(exts), 2, dict(filter_verb="filter", ignorable=True))
    for i in range(3):
        b.pod(f"p{i}", cpu="100m")
    assert run(b, exts) == 0
    assert ext_errors(b) == 1
    assert b.sched["torch"].queue.pending_count() == 3
    assert verbs(exts["torch"]) == {"filter": 1}
    # the error clears; a node joins (a cluster event moves the parked
    # pods) and past their backoff the wave places
    for e in exts.values():
        e.error = ""
    b.advance(2.0)
    b.node("n2")
    assert run(b, exts) == 3


def test_host_filter_reason_stands_before_the_extender(exts):
    """A node a host filter already rejected keeps that reason when the
    extender drops it too; only a node still admitted fails as
    ExtenderFilter: the FitError message and unschedulable_reasons are
    equal in both packages."""
    for e in exts.values():
        e.ban = {"n0", "n1"}
    b = lockstep(urls_of(exts), 2, dict(filter_verb="filter"))
    disk = [(GCE_PD, "pd-0", False)]
    b.create("pods", lambda pkg: volume_pod(pkg, "holder", disks=disk,
                                            cpu="100m", node_name="n0"))
    b.create("pods", lambda pkg: volume_pod(pkg, "p0", disks=disk,
                                            cpu="100m"))
    assert run(b, exts) == 0
    assert dict(b.stores["torch"].get("pods", "default", "p0")
                .status.conditions)["PodScheduled"] == (
        "False:0/2 nodes are available: 1 ExtenderFilter, 1 node(s) had "
        "no available disk.")


def test_fractional_scores_beside_a_policy_priority(exts):
    """A Policy with a labelPreference host priority and an extender at
    weight 3 answering fractional scores: the extra_scores plane is
    bit-equal in both packages (Python float products added into f32
    after the host scores), and the drain places the same."""
    for e in exts.values():
        e.scores = {"n0": 0.1, "n1": 1.7, "n2": 3.3, "n3": 0.45}

    def profile(pkg, store):
        side = "jax" if pkg == "kubernetes_tpu" else "torch"
        reg = importlib.import_module(f"{pkg}.plugins.registry")
        return reg.Registry().profile_from_policy(json.dumps({
            "priorities": [
                {"name": "LeastRequestedPriority", "weight": 1},
                {"name": "Preferred", "weight": 2, "argument": {
                    "labelPreference": {"label": "tier", "presence": True}}}],
            "extenders": [{"urlPrefix": exts[side].url,
                           "prioritizeVerb": "prioritize", "weight": 3,
                           "httpTimeout": TIMEOUT}]}), store)

    b = Both(profile=profile)

    def node(pkg, name, tier):
        n = plain_node(pkg, name, cpu="8", memory="16Gi")
        if tier:
            n.metadata.labels["tier"] = "gold"
        return n

    for i, tier in enumerate((True, False, False, True)):
        b.create("nodes", lambda pkg, i=i, t=tier: node(pkg, f"n{i}", t))
    b.pod("p0", cpu="100m")
    planes = {side: s._host_score_matrix(
        [b.stores[side].get("pods", "default", "p0")], 2)
        for side, s in b.sched.items()}
    assert planes["torch"].dtype == planes["jax"].dtype == np.float32
    np.testing.assert_array_equal(planes["torch"].view(np.int32),
                                  planes["jax"].view(np.int32))
    assert planes["torch"][0, 2] == np.float32(3.3 * 3)
    assert run(b, exts) == 1
    assert bindings(b.stores["torch"])["p0"] == "n3"


# -- the paths an extender is asked on ----------------------------------------


def _faulted(b):
    """The device path of both schedulers faulted at every kernel entry
    and its breaker tripped OPEN by one recorded failure at threshold 1:
    the twin carries every wave and gang from then on (the cooldown never
    passes on the virtual clock)."""
    for name in KERNEL_POINTS:
        arm(name)
    for s in b.sched.values():
        s.breaker.threshold = 1
        s.breaker.record_failure()


def _anchor(b):
    """A bound pod anchoring both terms of multikey_affinity on n3."""
    b.pod("anchor", labels={"app": "db", "tier": "cache"}, node_name="n3",
          priority=1000)


PATHS = ("wave", "host", "gang", "degraded_wave", "degraded_gang")


def _path_pods(b, path, prefix="p", n=3, cpu="1", priority=None):
    """The pending pods that take `path`: plain pods, multi-key
    anti-affinity pods (the exact host path) or a gang of n."""
    for i in range(n):
        kw = dict(cpu=cpu, priority=priority)
        if path == "host":
            kw["affinity"] = multikey_affinity(anti=True)
        elif path.endswith("gang"):
            kw.update(gang=prefix, min_avail=n)
        b.pod(f"{prefix}{i}", **kw)


@pytest.mark.parametrize("path", PATHS)
def test_each_path_asks_the_extender(exts, path):
    """Filter, prioritize at weight 2 and bind, with labels sent, on one
    path: the bans hold, the scores steer, one bind a pod, and the
    request logs are equal byte for byte."""
    for e in exts.values():
        e.ban = {"n0", "n5"}
        e.scores = {"n2": 10, "n4": 7}
    b = lockstep(urls_of(exts), 6,
                 dict(filter_verb="filter", prioritize_verb="prioritize",
                      bind_verb="bind", weight=2), cpu="4", zone="z0")
    if path == "host":
        _anchor(b)
    if path.startswith("degraded"):
        _faulted(b)
    if path.endswith("gang"):
        b.group("p", 3)
    _path_pods(b, path)
    assert run(b, exts) == 3
    got = bindings(b.stores["torch"])
    placed = [got[f"p{i}"] for i in range(3)]
    assert not {"n0", "n5"} & set(placed)
    assert "n2" in placed
    assert sorted(exts["torch"].bound) == sorted(
        (f"p{i}", got[f"p{i}"]) for i in range(3))
    t = b.sched["torch"]
    if path.startswith("degraded"):
        check_faults(b, KERNEL_POINTS)
        assert t.breaker.state == "open"
        assert t.wave_path() == "host"
    else:
        assert t.breaker.trips == 0
    if path == "host":
        assert t.metrics.waves_total.value(path="host") == 3
        # the host path asks over the nodes still feasible: n3 fails the
        # anti-affinity before the extender sees it
        body = json.loads(exts["torch"].log[0][1])
        assert body["nodenames"] == ["n0", "n1", "n2", "n4", "n5"]
        assert [i["metadata"]["name"] for i in body["nodes"]["items"]] == \
            body["nodenames"]


def test_pipeline_bail_out_hands_the_pass_back(exts):
    """A pipeline pass (called directly: schedule_pending skips it with
    extenders) whose filter drops a node hands every pod back to the
    queue, after one filter POST a pod; the per-wave drain then places
    them."""
    for e in exts.values():
        e.ban = {"n1"}
    b = lockstep(urls_of(exts), 3, dict(filter_verb="filter"))
    for i in range(4):
        b.pod(f"p{i}", cpu="100m")
    got = {side: s._schedule_pipelined() for side, s in b.sched.items()}
    assert got == {"jax": 0, "torch": 0}
    b.check()
    check_logs(exts)
    assert verbs(exts["torch"]) == {"filter": 4}
    assert b.sched["torch"].queue.pending_count() == 4
    assert run(b, exts) == 4
    assert "n1" not in bindings(b.stores["torch"]).values()


# -- the preempt verb on every preemption path --------------------------------


PREEMPT_PATHS = ("handle_failure", "fail_gang", "host_path", "preempt_chunk")


@pytest.mark.parametrize("path", PREEMPT_PATHS)
def test_preempt_verb_trims_the_candidates(exts, path):
    """Nodes full of priority-1 pairs under a PDB that allows one
    disruption; high-priority pods on one preemption path. The preempt
    verb drops the first candidate node and keeps one victim a node:
    the trimmed lists have their PDB violations counted again, no victim
    comes from a dropped node, and the evictions, nominations and logs
    are equal in both packages."""
    for e in exts.values():
        e.drop_first = True
        e.trim = 1
    b = lockstep(urls_of(exts),
                 4, dict(preempt_verb="preempt"), cpu="2", zone="z0")
    if path == "host_path":
        _anchor(b)
    if path == "preempt_chunk":
        _faulted(b)
    for i in range(8):
        b.pod(f"low{i}", cpu="1", priority=1, labels={"app": "low"})
    assert run(b, exts) == 8
    b.budget("low-pdb", {"app": "low"}, 1)
    lows = {k: v for k, v in bindings(b.stores["torch"]).items()
            if k.startswith("low")}
    if path == "fail_gang":
        b.group("v", 2)
    kind = {"handle_failure": "wave", "fail_gang": "gang",
            "host_path": "host", "preempt_chunk": "wave"}[path]
    _path_pods(b, kind, prefix="v", n=2, cpu="2", priority=100)
    run(b, exts)
    asked = [json.loads(raw) for v, raw in exts["torch"].log
             if v == "preempt"]
    assert asked, "the preempt verb was never asked"
    dropped = {next(iter(a["nodeNameToVictims"])) for a in asked}
    gone = {k for k in lows if b.stores["torch"].get("pods", "default", k)
            is None}
    assert gone, "nothing was evicted"
    evicted_from = {lows[k] for k in gone}
    kept = set()
    for a in asked:
        kept |= set(list(a["nodeNameToVictims"])[1:])
    assert evicted_from <= kept
    assert not evicted_from & (dropped - kept)
    t = b.sched["torch"]
    if path == "preempt_chunk":
        check_faults(b, KERNEL_POINTS)
        assert t.pipeline_preemptions >= 1
    elif path != "host_path":
        assert t.metrics.total_preemption_attempts.value >= 1
    for _ in range(3):
        b.advance(5.0)
        run(b, exts)


@pytest.mark.parametrize("ignorable", [False, True])
def test_unreachable_preempt_verb(ignorable):
    """A preempt-only extender that cannot be reached: a required one
    drops every candidate (nothing is evicted), an ignorable one is
    skipped (the what-if's own choice stands)."""
    b = lockstep(closed_urls(), 2,
                 dict(preempt_verb="preempt", ignorable=ignorable), cpu="2")
    for i in range(2):
        b.pod(f"low{i}", cpu="2", priority=1)
    assert b.run() == 2
    b.pod("vip", cpu="2", priority=100)
    b.run()
    alive = {p.metadata.name for p in b.stores["torch"].list("pods")}
    assert (alive == {"low0", "low1", "vip"}) == (not ignorable)
    assert ext_errors(b) == 0


# -- an unreachable extender on each path -------------------------------------


@pytest.mark.parametrize("path", PATHS + ("pipeline",))
def test_unreachable_extender_parks_the_pods(path, recorders):
    """A required extender on a closed port: every pod of the path parks
    with backoff, scheduling_errors{stage="extender"} counts each failed
    attempt, the device breaker is not charged, and the traced rounds'
    outcomes (extender_error for a wave, a pipeline pass or a gang) are
    equal in both packages."""
    b = lockstep(closed_urls(), 6, dict(filter_verb="filter"), cpu="4",
                 zone="z0")
    if path == "host":
        _anchor(b)
    if path.startswith("degraded"):
        _faulted(b)
    if path.endswith("gang"):
        b.group("p", 3)
    _path_pods(b, "wave" if path == "pipeline" else path)
    if path == "pipeline":
        got = {side: s._schedule_pipelined() for side, s in b.sched.items()}
        assert got == {"jax": 0, "torch": 0}
        b.check()
    else:
        assert b.run() == 0
    t = b.sched["torch"]
    assert ext_errors(b) == (3 if path == "host" else 1)
    assert t.queue.pending_count() == 3
    if path.startswith("degraded"):
        check_faults(b, KERNEL_POINTS)
        assert t.breaker.trips == 1
    else:
        assert t.breaker.trips == 0 and t.breaker.failures == 0
    rows = {side: [(r["kind"], r.get("outcome"))
                   for r in rec.ledger_rows()]
            for side, rec in recorders.items()}
    assert rows["torch"] == rows["jax"]
    if path in ("wave", "pipeline", "gang"):
        assert (("pipeline" if path == "pipeline" else path),
                "extender_error") in rows["torch"]


# -- the extender bind through the reconciler and the spool -------------------


def test_extender_bind_retried_then_spooled(exts):
    """The extender's bind answers HTTP 500 once: the reconciler retries
    it (bind_retries 1) and it lands. Then the store goes dark: binds
    fail at the store.outage seam before the extender is called, the
    breaker trips and the intents spool; healed, past the probe
    deadline, the spool drains through the extender's bind again. The
    binds, the retries and the store plane are equal in both packages."""
    from kubernetes_tpu.utils import faultpoints as jfp
    from kubernetes_tpu_torch.utils import faultpoints as tfp

    for e in exts.values():
        e.bind_fail = 1
    b = lockstep(urls_of(exts),
                 2, dict(bind_verb="bind"), cpu="16", memory="32Gi",
                 sched_kw=dict(store_breaker_cooldown=2.0))
    for s in b.sched.values():
        s.reconciler.sleep = lambda d: None
        s.reconciler.jitter = lambda: 0.5
        s.storehealth.jitter = lambda: 0.5
    b.pod("p0", cpu="100m")
    assert once(b, exts) == 1
    t = b.sched["torch"]
    assert t.metrics.bind_retries.value == 1
    assert [v for v, _ in exts["torch"].log] == ["bind", "bind"]
    arm("store.outage", "raise", times=OUTAGE)
    for i in range(1, 4):
        b.pod(f"p{i}", cpu="100m")
    assert once(b, exts) == 3
    assert t.storehealth.state == "disconnected"
    assert t.spool_count() == 3
    assert len(exts["torch"].log) == 2  # the seam fires before the verb
    disarm("store.outage")
    b.advance(2.5)
    assert once(b, exts) == 0
    assert t.spool_count() == 0 and t.storehealth.state == "connected"
    assert [p for p, _ in exts["torch"].bound] == ["p0", "p1", "p2", "p3"]
    assert exts["torch"].bound == sorted(
        (k, v) for k, v in bindings(b.stores["torch"]).items())
    j = b.sched["jax"]
    for name in ("bind_retries", "binds_spooled", "store_breaker_trips"):
        assert (getattr(t.metrics, name).value
                == getattr(j.metrics, name).value), name
    assert ({c.name: c.value for c in t.metrics.store_errors.children()}
            == {c.name: c.value for c in j.metrics.store_errors.children()})
    for name in ("bind.post", "store.outage"):
        assert tfp.hits(name) == jfp.hits(name), name
