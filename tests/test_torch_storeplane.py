"""The port's store plane against the JAX scheduler's: the store-path
breaker (sched/storehealth.py), the bind reconciler (sched/reconciler.py),
the disconnected-mode bind spool with its journal and crash replay, the
admission hold and dormancy (sched/scheduler.py).

The breaker's state machine and the reconciler's outcomes run on both
packages' classes (the cases of tests/test_outage.py and
tests/test_resilience.py). The scenarios run both schedulers in
lockstep (torch_parity.Both: one store each, the same writes, the same
virtual clock), each with its reconciler's sleep a no-op and the
reconciler's and the breaker's jitter pinned to 0.5, and after every
step compare, beside Both.check's bindings and scheduler metrics, the
store plane's state: the breaker (state, consecutive failures, trips,
probe deadline), the spool (pod, node, journal seq), the journal's
unresolved intents and its bytes, the assumed pods, the store series of
the metrics and the hits of `bind.post`, `store.outage` and
`journal.append`.
"""

import importlib
import random

import pytest

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import SCHED_CAPS, Both, arm, disarm
from torch_worlds import FakeClock, bindings, plain_node, plain_pod

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")
POINTS = ("bind.post", "store.outage", "journal.append")
OUTAGE = 10 ** 6  # times: a store outage until disarmed


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- the breaker's state machine (tests/test_outage.py:78-150) ----------------


@pytest.mark.parametrize("pkg", PKGS)
class TestStorePathBreaker:
    def _mk(self, pkg, clock, **kw):
        kw.setdefault("threshold", 3)
        kw.setdefault("cooldown", 10.0)
        kw.setdefault("jitter", lambda: 0.5)  # retry_at = trip + cooldown
        return mod(pkg, "sched.storehealth").StorePathBreaker(
            clock=lambda: clock[0], **kw)

    def test_threshold_consecutive_failures_disconnect(self, pkg):
        sh = mod(pkg, "sched.storehealth")
        clock = [0.0]
        b = self._mk(pkg, clock)
        assert b.state == sh.CONNECTED
        b.record_failure()
        assert b.state == sh.DEGRADED and b.failures == 1
        b.record_failure()
        assert b.state == sh.DEGRADED
        b.record_failure()
        assert b.state == sh.DISCONNECTED and b.trips == 1
        assert b.retry_at == 10.0

    def test_success_resets_the_consecutive_count(self, pkg):
        sh = mod(pkg, "sched.storehealth")
        clock = [0.0]
        b = self._mk(pkg, clock)
        b.record_failure()
        b.record_failure()
        b.record_success()
        assert b.state == sh.CONNECTED and b.failures == 0
        b.record_failure()
        b.record_failure()
        assert b.state == sh.DEGRADED and b.trips == 0

    def test_allow_admits_exactly_one_probe_per_deadline(self, pkg):
        sh = mod(pkg, "sched.storehealth")
        clock = [0.0]
        b = self._mk(pkg, clock)
        for _ in range(3):
            b.record_failure()
        assert b.state == sh.DISCONNECTED
        clock[0] = 5.0
        assert not b.allow()
        clock[0] = 10.0
        assert b.allow()
        assert b.state == sh.DEGRADED
        b.record_failure()  # the probe failed: a fresh deadline
        assert b.state == sh.DISCONNECTED and b.trips == 2
        assert b.retry_at == 20.0

    def test_probe_success_reconnects_and_fires_callback(self, pkg):
        sh = mod(pkg, "sched.storehealth")
        clock = [0.0]
        events = []
        b = self._mk(pkg, clock, on_reconnect=lambda: events.append("up"),
                     on_trip=lambda: events.append("trip"),
                     on_state=lambda s: events.append(s))
        for _ in range(3):
            b.record_failure()
        clock[0] = 10.0
        assert b.allow()
        b.record_success()
        assert b.state == sh.CONNECTED
        assert events.count("trip") == 1
        assert events.count("up") == 1
        assert events[-2:] == ["connected", "up"]

    def test_snapshot_reports_probe_deadline(self, pkg):
        clock = [0.0]
        b = self._mk(pkg, clock)
        assert b.snapshot() == {"state": "connected", "failures": 0,
                                "trips": 0, "probe_in_s": 0.0}
        for _ in range(3):
            b.record_failure()
        clock[0] = 4.0
        assert b.snapshot()["probe_in_s"] == 6.0


def test_the_breakers_agree_on_a_random_walk():
    """A seeded walk of failures, successes, probes and clock steps: both
    packages' breakers take the same states, deadlines and callbacks."""
    import numpy as np

    rng = np.random.RandomState(7)
    clock = [0.0]
    seen = {pkg: [] for pkg in PKGS}
    bs = {pkg: mod(pkg, "sched.storehealth").StorePathBreaker(
        threshold=3, cooldown=4.0, clock=lambda: clock[0],
        jitter=lambda: 0.25, on_reconnect=lambda p=pkg: seen[p].append("up"),
        on_trip=lambda p=pkg: seen[p].append("trip"),
        on_state=lambda s, p=pkg: seen[p].append(s)) for pkg in PKGS}
    for _ in range(400):
        op = rng.randint(4)
        clock[0] += float(rng.rand() * 2) if op == 3 else 0.0
        out = []
        for pkg in PKGS:
            b = bs[pkg]
            if op == 0:
                b.record_failure()
            elif op == 1:
                b.record_success()
            else:
                out.append(b.allow())
        assert len(set(out)) <= 1
        a, t = bs["kubernetes_tpu"], bs["kubernetes_tpu_torch"]
        assert ((a.state, a.failures, a.trips, a.retry_at, a._probing)
                == (t.state, t.failures, t.trips, t.retry_at, t._probing))
        assert a.snapshot() == t.snapshot()
    assert seen["kubernetes_tpu"] == seen["kubernetes_tpu_torch"]
    assert "trip" in seen["kubernetes_tpu"] and "up" in seen["kubernetes_tpu"]


# -- the reconciler's outcomes (tests/test_resilience.py:177-230) -------------


@pytest.mark.parametrize("pkg", PKGS)
class TestBindReconciler:
    def _rec(self, pkg, truth, **kw):
        r = mod(pkg, "sched.reconciler")
        return r, r.BindReconciler(truth, sleep=lambda s: None, **kw)

    def test_bound_on_retry_counts_bind_retries(self, pkg):
        metrics = mod(pkg, "utils.metrics").Metrics()
        calls = []

        def attempt():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("flap")

        r, rc = self._rec(pkg, lambda pod: None, metrics=metrics,
                          max_attempts=3, base_delay=0.001)
        out, truth = rc.reconcile(plain_pod(pkg, "p"), "n0", attempt)
        assert out == r.BOUND and truth is None
        assert len(calls) == 3
        assert metrics.bind_retries.value == 2

    def test_lost_response_resolves_confirmed(self, pkg):
        truth_pod = plain_pod(pkg, "p", node_name="n0")

        def attempt():
            raise ConnectionError("response lost")

        r, rc = self._rec(pkg, lambda pod: truth_pod, max_attempts=2,
                          base_delay=0.001)
        out, truth = rc.reconcile(plain_pod(pkg, "p"), "n0", attempt)
        assert out == r.CONFIRMED and truth is truth_pod

    def test_never_landed_resolves_orphaned(self, pkg):
        r, rc = self._rec(pkg, lambda pod: plain_pod(pkg, "p"),
                          max_attempts=2, base_delay=0.001)
        out, _ = rc.reconcile(plain_pod(pkg, "p"), "n0",
                              lambda: (_ for _ in ()).throw(OSError("down")))
        assert out == r.ORPHANED

    def test_deleted_resolves_gone_and_unreachable_falls_back(self, pkg):
        r, rc = self._rec(pkg, lambda pod: None, max_attempts=1)
        out, _ = rc.reconcile(plain_pod(pkg, "p"), "n0",
                              lambda: (_ for _ in ()).throw(OSError("down")))
        assert out == r.GONE

        def no_truth(pod):
            raise OSError("apiserver down")

        _, rc2 = self._rec(pkg, no_truth, max_attempts=1)
        out2, truth = rc2.reconcile(
            plain_pod(pkg, "p"), "n0",
            lambda: (_ for _ in ()).throw(OSError("x")))
        assert out2 == r.ORPHANED and truth is None

    def test_a_refusal_is_not_retried(self, pkg):
        """Conflict and KeyError are the store's answer: one attempt, the
        breaker's ok callback, then truth."""
        conflict = mod(pkg, "runtime.store").Conflict
        ok, bad, calls = [], [], []

        def attempt():
            calls.append(1)
            raise conflict("already bound")

        r, rc = self._rec(pkg, lambda pod: plain_pod(pkg, "p",
                                                    node_name="n1"),
                          max_attempts=3, on_transport_ok=lambda: ok.append(1),
                          on_transport_error=lambda: bad.append(1))
        out, truth = rc.reconcile(plain_pod(pkg, "p"), "n0", attempt)
        assert out == r.CONFIRMED and truth.spec.node_name == "n1"
        assert (len(calls), len(ok), len(bad)) == (1, 1, 0)


# -- lockstep scenarios --------------------------------------------------------


def pin(sched):
    """The store plane's randomness pinned: no real sleep between bind
    attempts, jitter 0.5 (the probe deadline exactly trip + cooldown)."""
    sched.reconciler.sleep = lambda d: None
    sched.reconciler.jitter = lambda: 0.5
    sched.storehealth.jitter = lambda: 0.5
    if sched.journal is not None:
        sched.journal.clock = lambda: 4242.5
    return sched


def store_state(sched) -> dict:
    """The store plane's state of one scheduler."""
    sh = sched.storehealth
    m = sched.metrics
    out = {
        "breaker": (sh.state, sh.failures, sh.trips, sh.retry_at,
                    sh.tripped_at),
        "spool": [(e[0].metadata.name, e[2], e[4]) for e in sched._spool],
        "spool_uids": sorted(sched.spool_uids()),
        "assumed": sorted(p.metadata.name
                          for p in sched.cache.assumed_pods()),
        "pending": sched.queue.pending_count(),
        "shed": sched.queue.shed_count(),
        "dormant": sched.dormant,
        "metrics": {
            "store_breaker_state": m.store_breaker_state.value,
            "store_breaker_trips": m.store_breaker_trips.value,
            "store_errors": {c.name: c.value
                             for c in m.store_errors.children()},
            "binds_spooled": m.binds_spooled.value,
            "bind_retries": m.bind_retries.value,
            "cache_assumed_expired": m.cache_assumed_expired.value,
            "spool_gauge": m.pending_pods.value(queue="spool"),
        },
    }
    debug = sched.store_debug()
    debug["journal"] = (None if debug["journal"] is None else
                        {k: v for k, v in debug["journal"].items()
                         if k != "path"})
    out["debug"] = debug
    if sched.journal is not None:
        out["unresolved"] = sched.journal.unresolved()
        out["journal_bytes"] = [
            open(p, "rb").read() for p in sched.journal._segments()]
    return out


def check(b):
    """Both schedulers of `b` in the same store-plane state, every fault
    point of POINTS hit as often in both packages, and Both.check."""
    from kubernetes_tpu.utils import faultpoints as jfp
    from kubernetes_tpu_torch.utils import faultpoints as tfp

    b.check()
    want, got = (store_state(b.sched[s]) for s in ("jax", "torch"))
    assert got == want
    for name in POINTS:
        assert tfp.hits(name) == jfp.hits(name), name


def once(b) -> int:
    """run_once on both, the same count, then the checks."""
    got = {side: s.run_once() for side, s in b.sched.items()}
    assert got["jax"] == got["torch"], got
    check(b)
    return got["torch"]


def hits(name) -> int:
    from kubernetes_tpu_torch.utils import faultpoints as tfp

    return tfp.hits(name)


def fresh(pkg, store, path, clock, **kw):
    """A `pkg` Scheduler over `store` and the journal at `path`, its
    store plane pinned."""
    em = mod(pkg, "ops.encoding")
    if pkg == "kubernetes_tpu_torch":
        kw["device"] = "cpu"
    return pin(mod(pkg, "sched.scheduler").Scheduler(
        store, wave_size=8, caps=em.Caps(**SCHED_CAPS), clock=clock,
        bind_journal_path=path, **kw))


def world(tmp_path, n_nodes=2, tag="j", **kw):
    """Both, with `n_nodes` 16-core nodes, waves of 8, the store breaker's
    cooldown 2 s and a journal a side under tmp_path."""
    b = Both(wave=8, caps=SCHED_CAPS,
             sched_kw=dict(store_breaker_cooldown=2.0, **kw),
             side_kw=lambda side: dict(
                 bind_journal_path=str(tmp_path / f"{tag}-{side}.journal")))
    for s in b.sched.values():
        pin(s)
    for i in range(n_nodes):
        b.node(f"n{i}", cpu="16", memory="32Gi")
    return b


def pods(b, names, **kw):
    for name in names:
        b.pod(name, cpu=kw.get("cpu", "100m"), memory="64Mi",
              priority=kw.get("priority"))


def test_disconnected_mode_spools_then_heal_drains_once(tmp_path):
    """tests/test_outage.py:172: the store dark, four pods schedule
    against the cache and spool (the first bind's three POSTs trip the
    breaker, its truth GET fails: 3 + 1 hits of store.outage, then none);
    a late pod spools without a POST; a probe past the deadline with the
    store still dark fails and re-trips; healed, one housekeeping pass
    drains the spool head first and every pod binds once."""
    b = world(tmp_path)
    arm("store.outage", "raise", times=OUTAGE)
    pods(b, [f"p{i}" for i in range(4)])
    assert once(b) == 4
    t = b.sched["torch"]
    assert t.storehealth.state == "disconnected"
    assert hits("store.outage") == 4
    assert t.spool_count() == 4 and len(t.journal.unresolved()) == 4
    assert t.spool_uids() <= {p.uid for p in t.cache.assumed_pods()}
    assert {k: v for k, v in bindings(b.stores["torch"]).items() if v} == {}
    pods(b, ["late"])
    assert once(b) == 1
    assert hits("store.outage") == 4
    assert t.spool_count() == 5
    # the probe with the store still dark: the head intent's three POSTs
    # and its GET fail, the breaker re-trips with a fresh deadline
    b.advance(2.5)
    assert once(b) == 0
    assert hits("store.outage") == 8
    assert t.storehealth.trips == 2 and t.spool_count() == 5
    # heal: one housekeeping pass drains all five in arrival order
    disarm("store.outage")
    b.advance(2.5)
    assert once(b) == 0
    assert t.spool_count() == 0 and t.storehealth.state == "connected"
    assert sorted(k for k, v in bindings(b.stores["torch"]).items()
                  if v) == ["late", "p0", "p1", "p2", "p3"]
    assert t.journal.unresolved() == [] and t.cache.assumed_pods() == []


def test_post_heal_bindings_equal_an_outage_free_run(tmp_path):
    """The same arrivals at the same wave boundaries with and without a
    mid-run outage: the same pod -> node map in both packages, and the
    outage's equal to the outage-free run's."""

    def run(outage):
        b = world(tmp_path, tag=f"o{outage}")
        pods(b, [f"p{i}" for i in range(6)], cpu="200m")
        once(b)
        if outage:
            arm("store.outage", "raise", times=OUTAGE)
        pods(b, [f"p{i}" for i in range(6, 12)], cpu="300m")
        once(b)
        if outage:
            assert b.sched["torch"].spool_count() == 6
            disarm("store.outage")
        b.advance(5.0)
        for _ in range(3):
            once(b)
        assert b.sched["torch"].spool_count() == 0
        return bindings(b.stores["torch"])

    clean = run(False)
    assert sum(1 for v in clean.values() if v) == 12
    assert run(True) == clean


def test_spool_watermark_holds_sheddable_admissions(tmp_path):
    """tests/test_outage.py:243: past spool_watermark while DISCONNECTED
    a sheddable arrival parks in the shed area, a high-priority one
    still schedules and spools; after the heal everything binds."""
    b = world(tmp_path, spool_watermark=2, shed_watermark=50,
              shed_age_s=1.0)
    arm("store.outage", "raise", times=OUTAGE)
    pods(b, [f"p{i}" for i in range(3)])
    once(b)
    t = b.sched["torch"]
    assert t.spool_count() == 3 and t._admissions_held()
    pods(b, ["held"])
    once(b)
    assert t.queue.shed_count() == 1 and t.spool_count() == 3
    pods(b, ["critical"], priority=2000)
    once(b)
    assert t.spool_count() == 4 and t.queue.shed_count() == 1
    disarm("store.outage")
    b.advance(5.0)
    for _ in range(3):
        once(b)
    assert t.spool_count() == 0 and t.queue.shed_count() == 0
    assert bindings(b.stores["torch"])["held"]


def test_kill_mid_outage_then_a_fresh_process_recovers(tmp_path):
    """tests/test_outage.py:287: the first schedulers are abandoned with
    their spool (no drain); fresh ones over the same stores and journals,
    the store still dark, replay and re-spool every intent under its seq;
    healed, they drain: every pod bound once, nothing assumed or
    unresolved."""
    b = world(tmp_path)
    arm("store.outage", "raise", times=OUTAGE)
    pods(b, [f"p{i}" for i in range(3)])
    once(b)
    before = store_state(b.sched["torch"])["spool"]
    assert [s[2] for s in before] == [0, 1, 2]
    for s in b.sched.values():
        s.close()
    paths = {side: s.journal.path for side, s in b.sched.items()}
    # the replay's three failed GETs trip the new breakers before a test
    # can pin their jitter: the same seed gives both the same draw
    b.sched = {}
    for side in ("jax", "torch"):
        random.seed(11)
        b.sched[side] = pin(fresh(Both.pkg(side), b.stores[side],
                                  paths[side], b.clock[side],
                                  store_breaker_cooldown=2.0))
    check(b)
    t = b.sched["torch"]
    assert store_state(t)["spool"] == before
    assert t.storehealth.state == "disconnected"
    assert t.queue.pending_count() == 0
    disarm("store.outage")
    b.advance(5.0)
    once(b)
    assert t.spool_count() == 0 and t.journal.unresolved() == []
    assert t.cache.assumed_pods() == []
    assert sorted(k for k, v in bindings(b.stores["torch"]).items()
                  if v) == ["p0", "p1", "p2"]




@pytest.mark.parametrize("pkg", PKGS)
def test_landed_bind_is_adopted_not_bound_again(pkg, tmp_path):
    """tests/test_outage.py:335: the crash came after the POST landed and
    before its resolved record: the replay adopts the binding (no spool,
    nothing assumed, nothing queued), with the same journal bytes after
    it in both packages; `pkg` wrote the journal."""
    out = {}
    for side in PKGS:
        store = mod(side, "runtime.store").ObjectStore()
        store.create("nodes", plain_node(side, "n0", cpu="16",
                                         memory="32Gi"))
        p = plain_pod(side, "landed", cpu="100m", memory="64Mi")
        store.create("pods", p)
        path = str(tmp_path / f"{side}.journal")
        mod(pkg, "state.journal").BindJournal(
            path, clock=lambda: 7.0).append_intent(p, "n0")
        store.bind(p, "n0")
        s = fresh(side, store, path, FakeClock())
        assert s.spool_count() == 0
        assert s.journal.unresolved() == []
        assert s.cache.assumed_pods() == []
        assert s.queue.pending_count() == 0
        assert bindings(store) == {"landed": "n0"}
        out[side] = store_state(s)
    assert out["kubernetes_tpu_torch"] == out["kubernetes_tpu"]


@pytest.mark.parametrize("pkg", PKGS)
def test_deleted_pod_resolves_gone(pkg, tmp_path):
    """tests/test_outage.py:361: an intent whose pod is not in the store
    resolves GONE at replay."""
    out = {}
    for side in PKGS:
        store = mod(side, "runtime.store").ObjectStore()
        store.create("nodes", plain_node(side, "n0", cpu="16",
                                         memory="32Gi"))
        path = str(tmp_path / f"{side}.journal")
        mod(pkg, "state.journal").BindJournal(path, clock=lambda: 7.0) \
            .append_intent(plain_pod(side, "gone"), "n0")
        s = fresh(side, store, path, FakeClock())
        assert s.spool_count() == 0 and s.journal.unresolved() == []
        assert s.cache.assumed_pods() == []
        out[side] = store_state(s)
    assert out["kubernetes_tpu_torch"] == out["kubernetes_tpu"]
    assert b'"outcome":"gone"' in out["kubernetes_tpu"]["journal_bytes"][0]


def test_dormancy_and_recovery(tmp_path, monkeypatch):
    """tests/test_resilience.py:106 without the elector: while dormant,
    run_once and schedule_pending place nothing and the watches stay
    warm; a bind that landed with its confirmation lost is adopted, an
    assumption whose bind never happened is forgotten and the pod
    scheduled afresh; after recover_leadership the next drain binds the
    rest, in both packages alike."""
    b = world(tmp_path, n_nodes=3)
    pods(b, ["steady"], cpu="1")
    assert b.run() == 1
    for s in b.sched.values():
        s.enter_dormant()
    pods(b, ["while-dormant"], cpu="1")
    assert once(b) == 0
    assert b.run() == 0
    assert b.sched["torch"].queue.active_count() == 1
    for side, store in b.stores.items():
        api = mod(Both.pkg(side), "api.types")
        sched = b.sched[side]
        landed = plain_pod(Both.pkg(side), "landed", cpu="1")
        store.create("pods", landed)
        monkeypatch.setattr(store, "_notify", lambda ev: None)
        store.bind(landed, "n0")  # the confirmation is lost
        monkeypatch.undo()
        orphan = plain_pod(Both.pkg(side), "orphan", cpu="1")
        store.create("pods", orphan)
        with sched._mu:
            sched.cache.assume_pod(api.with_node_name(landed, "n0"))
            sched.cache.assume_pod(api.with_node_name(orphan, "n1"))
    check(b)
    stats = {side: s.recover_leadership() for side, s in b.sched.items()}
    assert stats["torch"] == stats["jax"] == {
        "confirmed": 1, "orphaned": 1, "unresolved": 0}
    check(b)
    assert b.sched["torch"].cache.assumed_pods() == []
    assert b.run() == 2
    assert sorted(k for k, v in bindings(b.stores["torch"]).items()
                  if v) == ["landed", "orphan", "steady", "while-dormant"]


def test_a_gang_half_spooled(tmp_path):
    """The gang commit binds member by member through the same path: the
    store goes dark after two members' POSTs, the third member's POSTs
    trip the breaker and it spools with the fourth; healed, the spool
    drains and the gang is whole (JAX _commit_gang)."""
    b = world(tmp_path, n_nodes=4)
    b.group("g", 4)

    def dark_after(n):
        def make(pkg):
            seen = [0]

            def fn(payload):
                seen[0] += 1
                if seen[0] > n:
                    raise ConnectionError("store.outage: dark")
            return fn
        return make

    arm("store.outage", "corrupt", times=OUTAGE, make=dark_after(2))
    for i in range(4):
        b.pod(f"g-{i}", cpu="1", memory="64Mi", gang="g")
    assert b.run() == 4
    t = b.sched["torch"]
    assert b.bound("g") == 2 and t.spool_count() == 2
    assert t.storehealth.state == "disconnected"
    check(b)
    disarm("store.outage")
    b.advance(5.0)
    once(b)
    assert b.bound("g") == 4 and t.spool_count() == 0


def test_journal_append_fault_spools_in_memory(tmp_path):
    """journal.append raising at the first intent: that intent spools in
    memory only (no seq), the next ones journal; the drain binds all and
    resolves the journaled two."""
    b = world(tmp_path)
    arm("store.outage", "raise", times=OUTAGE)
    arm("journal.append", "raise", times=1)
    pods(b, [f"p{i}" for i in range(3)])
    once(b)
    t = b.sched["torch"]
    # the failed append still took seq 0
    assert [s[2] for s in store_state(t)["spool"]] == [None, 1, 2]
    disarm("store.outage")
    b.advance(5.0)
    once(b)
    assert t.spool_count() == 0 and t.journal.unresolved() == []
    assert sum(1 for v in bindings(b.stores["torch"]).values() if v) == 3


# -- the lost bind response (the fault this slice repairs) --------------------


def lost_response_store(pkg, lose):
    """An ObjectStore whose bind lands and then answers ConnectionError,
    `lose` times (tests/test_resilience.py:235 _LostResponseStore)."""
    base = mod(pkg, "runtime.store").ObjectStore

    class LostResponseStore(base):
        def __init__(self):
            super().__init__()
            self.lose = lose

        def bind(self, pod, node_name):
            super().bind(pod, node_name)
            if self.lose > 0:
                self.lose -= 1
                raise ConnectionError("bind response lost")

    return LostResponseStore()


def test_lost_bind_response_confirms_the_pod_once():
    """Every POST's answer is lost but each lands: both packages retry
    twice (bind_retries 2), read the pod bound from the store and
    confirm it once — not assumed, not queued, the mirror clean. The
    port's bind used to let the ConnectionError out of
    schedule_pending."""
    out = {}
    for pkg in PKGS:
        store = lost_response_store(pkg, 100)
        store.create("nodes", plain_node(pkg, "n0", cpu="4"))
        kw = {"device": "cpu"} if pkg == "kubernetes_tpu_torch" else {}
        s = mod(pkg, "sched.scheduler").Scheduler(store, clock=FakeClock(),
                                                  **kw)
        store.create("pods", plain_pod(pkg, "p0", cpu="1"))
        # the reconciler's real sleeps and jitter draws, and the trip's:
        # the same seed gives both packages the same draws
        random.seed(3)
        assert s.schedule_pending() == 1
        assert [p.metadata.name for p in store.list("pods")
                if p.spec.node_name] == ["p0"]
        assert s.metrics.bind_retries.value == 2
        assert s.cache.assumed_pods() == [] and s.cache.pod_count() == 1
        assert s.queue.pending_count() == 0
        assert s.scrubber.scrub().clean
        out[pkg] = store_state(s)
    assert out["kubernetes_tpu_torch"] == out["kubernetes_tpu"]
    # three failed POSTs trip the store breaker; the truth GET answers
    # and reconnects it
    assert out["kubernetes_tpu"]["debug"]["errors"]["bind"] == 3
    assert out["kubernetes_tpu"]["breaker"][:3] == ("connected", 0, 1)


def test_a_bind_that_never_lands_is_orphaned_and_requeued():
    """bind.post raising ConnectionError on all three attempts: ORPHANED
    in both, the assumption forgotten, the pod parked with backoff; past
    the backoff it binds."""
    b = Both(n_nodes=1, cpu="4")
    for s in b.sched.values():
        pin(s)
    arm("bind.post", "raise", times=3,
        exc=lambda: ConnectionError("bind lost"))
    b.pod("p0", cpu="1")
    assert b.run() == 0
    check(b)
    t = b.sched["torch"]
    assert hits("bind.post") == 3
    assert t.cache.assumed_pods() == [] and t.cache.pod_count() == 0
    assert t.queue.pending_count() == 1
    assert t.metrics.scheduling_errors.value(stage="bind") == 1
    assert t.metrics.bind_retries.value == 2
    b.advance(1.5)
    for s in b.sched.values():
        s.queue.move_all_to_active()
    assert b.run() == 1
    check(b)
    assert bindings(b.stores["torch"]) == {"p0": "n0"}
