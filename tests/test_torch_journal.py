"""The port's bind-intent journal (kubernetes_tpu_torch/state/journal.py)
against the JAX package's (kubernetes_tpu/state/journal.py).

Every case of tests/test_journal.py runs on both packages' BindJournal
(the format, seq order and resumption, rotation to `<path>.1`, torn and
garbage lines, the `journal.append` fault point in raise and drop mode,
each package arming its own registry); then the two packages write the
same records with the same clock and their files must be equal byte for
byte, rotation included; and a journal one package writes replays in the
other, as a BindJournal and through a Scheduler's construction.
"""

import importlib
import json
import os

import pytest

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import SCHED_CAPS
from torch_worlds import FakeClock, bindings, plain_node, plain_pod

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")


def mods(pkg):
    """(journal module, faultpoints module) of one package."""
    return (importlib.import_module(f"{pkg}.state.journal"),
            importlib.import_module(f"{pkg}.utils.faultpoints"))


def journal(pkg, tmp_path, name="bind.journal", **kw):
    jm, _ = mods(pkg)
    return jm.BindJournal(str(tmp_path / name), **kw)


def pod(pkg, name):
    return plain_pod(pkg, name)


pytestmark = pytest.mark.parametrize("pkg", PKGS)


class TestFormat:
    def test_append_intent_record_shape(self, pkg, tmp_path):
        j = journal(pkg, tmp_path, clock=lambda: 123.456)
        p = pod(pkg, "web-1")
        assert j.append_intent(p, "node-a") == 0
        lines = open(j.path).read().splitlines()
        assert len(lines) == 1
        assert json.loads(lines[0]) == {
            "v": 1, "k": "intent", "seq": 0, "uid": p.uid, "ns": "default",
            "name": "web-1", "node": "node-a", "ts": 123.456}

    def test_seq_monotonic_and_resolve_record(self, pkg, tmp_path):
        jm, _ = mods(pkg)
        j = journal(pkg, tmp_path)
        s0 = j.append_intent(pod(pkg, "a"), "n0")
        s1 = j.append_intent(pod(pkg, "b"), "n1")
        assert (s0, s1) == (0, 1)
        j.resolve(s0, jm.CONFIRMED)
        recs = [json.loads(ln) for ln in open(j.path).read().splitlines()]
        assert recs[-1] == {"v": 1, "k": "resolved", "seq": 0,
                            "outcome": "confirmed"}

    def test_unresolved_is_set_difference_in_seq_order(self, pkg, tmp_path):
        jm, _ = mods(pkg)
        j = journal(pkg, tmp_path)
        seqs = [j.append_intent(pod(pkg, f"p{i}"), f"n{i}")
                for i in range(4)]
        j.resolve(seqs[1], jm.GONE)
        j.resolve(seqs[3], jm.ORPHANED)
        left = j.unresolved()
        assert [r["seq"] for r in left] == [seqs[0], seqs[2]]
        assert [r["name"] for r in left] == ["p0", "p2"]

    def test_fresh_path_has_no_unresolved(self, pkg, tmp_path):
        j = journal(pkg, tmp_path)
        assert j.unresolved() == []
        assert j.stats()["unresolved"] == 0

    def test_seq_resumes_past_prior_generation(self, pkg, tmp_path):
        j = journal(pkg, tmp_path)
        j.append_intent(pod(pkg, "a"), "n0")
        j.append_intent(pod(pkg, "b"), "n1")
        assert journal(pkg, tmp_path).append_intent(pod(pkg, "c"), "n2") == 2


class TestRotation:
    def test_rotation_keeps_unresolved_across_segments(self, pkg, tmp_path):
        jm, _ = mods(pkg)
        probe = journal(pkg, tmp_path, "probe.journal", clock=lambda: 100.0)
        probe.append_intent(pod(pkg, "rot0"), "n0")
        line = os.path.getsize(probe.path)
        j = journal(pkg, tmp_path, max_bytes=int(2.5 * line),
                    clock=lambda: 100.0)
        seqs = [j.append_intent(pod(pkg, f"rot{i}"), f"n{i}")
                for i in range(4)]
        assert j.rotations == 1
        assert os.path.exists(j.path + ".1")
        assert [r["seq"] for r in j.unresolved()] == seqs
        j.resolve(seqs[0], jm.CONFIRMED)
        assert seqs[0] not in {r["seq"] for r in j.unresolved()}

    def test_default_cap_comes_from_module(self, pkg, tmp_path):
        jm, _ = mods(pkg)
        assert journal(pkg, tmp_path, max_bytes=-1).max_bytes == \
            jm.JOURNAL_MAX_BYTES


class TestTornLines:
    def test_torn_tail_skipped_not_fatal(self, pkg, tmp_path):
        j = journal(pkg, tmp_path)
        j.append_intent(pod(pkg, "ok"), "n0")
        with open(j.path, "ab") as f:
            f.write(b'{"v":1,"k":"intent","seq":1,"uid":"torn')
        assert [r["name"] for r in j.unresolved()] == ["ok"]
        assert j.skipped_lines == 1

    def test_append_after_torn_tail_repairs_line_boundary(self, pkg,
                                                          tmp_path):
        j = journal(pkg, tmp_path)
        j.append_intent(pod(pkg, "ok"), "n0")
        with open(j.path, "ab") as f:
            f.write(b'{"v":1,"k":"int')
        j.append_intent(pod(pkg, "after"), "n1")
        assert [r["name"] for r in j.unresolved()] == ["ok", "after"]
        assert j.skipped_lines == 1

    def test_garbage_line_in_middle_skipped(self, pkg, tmp_path):
        j = journal(pkg, tmp_path)
        j.append_intent(pod(pkg, "a"), "n0")
        with open(j.path, "ab") as f:
            f.write(b"\x00\xff not json at all\n")
        j.append_intent(pod(pkg, "b"), "n1")
        assert [r["name"] for r in j.unresolved()] == ["a", "b"]


class TestFaultPoint:
    def test_raise_mode_propagates_to_caller(self, pkg, tmp_path):
        _, fp = mods(pkg)
        j = journal(pkg, tmp_path)
        fp.activate("journal.append", "raise", times=1)
        with pytest.raises(fp.FaultInjected):
            j.append_intent(pod(pkg, "a"), "n0")
        assert not os.path.exists(j.path)
        j.append_intent(pod(pkg, "b"), "n1")
        assert [r["name"] for r in j.unresolved()] == ["b"]
        assert fp.hits("journal.append") == 1

    def test_drop_mode_loses_exactly_the_acked_write(self, pkg, tmp_path):
        _, fp = mods(pkg)
        j = journal(pkg, tmp_path)
        j.append_intent(pod(pkg, "kept"), "n0")
        fp.activate("journal.append", "drop", times=1)
        j.append_intent(pod(pkg, "lost"), "n1")
        assert [r["name"] for r in j.unresolved()] == ["kept"]

    def test_dropped_resolve_means_reverify_not_corruption(self, pkg,
                                                           tmp_path):
        jm, fp = mods(pkg)
        j = journal(pkg, tmp_path)
        s = j.append_intent(pod(pkg, "a"), "n0")
        fp.activate("journal.append", "drop", times=1)
        j.resolve(s, jm.CONFIRMED)
        assert [r["seq"] for r in j.unresolved()] == [s]

    def test_the_arming_package_alone_is_faulted(self, pkg, tmp_path):
        """Each package's point is armed in its own registry: arming one
        leaves the other's journal writing."""
        other = PKGS[1 - PKGS.index(pkg)]
        _, fp = mods(pkg)
        fp.activate("journal.append", "raise")
        journal(other, tmp_path, "other.journal").append_intent(
            pod(other, "a"), "n0")
        with pytest.raises(fp.FaultInjected):
            journal(pkg, tmp_path).append_intent(pod(pkg, "a"), "n0")


def write_script(pkg, tmp_path, max_bytes):
    """One fixed sequence of appends and resolves, a rotation in it when
    max_bytes is small, on a pinned clock. Returns the journal."""
    jm, _ = mods(pkg)
    ts = iter(range(1000))
    j = jm.BindJournal(str(tmp_path / f"{pkg}.journal"),
                       max_bytes=max_bytes, clock=lambda: 1e9 + next(ts) / 7)
    seqs = [j.append_intent(pod(pkg, f"p{i}"), f"node-{i % 3}")
            for i in range(6)]
    j.resolve(seqs[1], jm.CONFIRMED)
    j.resolve(seqs[4], jm.GONE)
    j.append_intent(pod(pkg, "late"), "node-2")
    j.resolve(seqs[2], jm.ORPHANED)
    return j


def segments(j):
    return [open(p, "rb").read() if os.path.exists(p) else None
            for p in (j.path + ".1", j.path)]


@pytest.mark.parametrize("max_bytes", [-1, 600])
def test_both_packages_write_the_same_bytes(pkg, max_bytes, tmp_path):
    """The same records on the same clock: the two packages' files equal
    byte for byte, the rotated generation too (max_bytes 600 rotates once;
    the pkg parameter orders which package writes first)."""
    other = PKGS[1 - PKGS.index(pkg)]
    a = write_script(pkg, tmp_path, max_bytes)
    b = write_script(other, tmp_path, max_bytes)
    assert segments(a) == segments(b)
    assert (a.rotations, a.appends) == (b.rotations, b.appends)
    assert a.rotations == (1 if max_bytes > 0 else 0)
    assert a.unresolved() == b.unresolved()


def test_a_journal_replays_in_the_other_package(pkg, tmp_path):
    """`pkg` writes (a rotation and a torn tail in it), the other package
    reads: the same unresolved intents in seq order, the same skipped
    line, its seq resumes past both generations, and its own append
    repairs the torn tail."""
    other = PKGS[1 - PKGS.index(pkg)]
    w = write_script(pkg, tmp_path, 600)
    with open(w.path, "ab") as f:
        f.write(b'{"v":1,"k":"intent","seq":9')
    want = w.unresolved()
    jm, _ = mods(other)
    r = jm.BindJournal(w.path)
    assert r.unresolved() == want
    assert [x["seq"] for x in want] == [0, 3, 5, 6]  # across the rotation
    assert r.skipped_lines == w.skipped_lines == 1
    assert r.append_intent(pod(other, "next"), "node-0") == 7
    assert [x["name"] for x in r.unresolved()] == (
        [x["name"] for x in want] + ["next"])
    assert r.skipped_lines == 1
    assert [x["seq"] for x in w.unresolved()] == [
        x["seq"] for x in r.unresolved()]


def scheduler(pkg, store, clock, path):
    sm = importlib.import_module(f"{pkg}.sched.scheduler")
    em = importlib.import_module(f"{pkg}.ops.encoding")
    kw = {"device": "cpu"} if pkg == "kubernetes_tpu_torch" else {}
    s = sm.Scheduler(store, wave_size=8, caps=em.Caps(**SCHED_CAPS),
                     clock=clock, store_breaker_cooldown=2.0,
                     bind_journal_path=path, **kw)
    s.storehealth.jitter = lambda: 0.5
    s.reconciler.sleep = lambda d: None
    s.reconciler.jitter = lambda: 0.5
    return s


def test_a_scheduler_replays_the_other_packages_journal(pkg, tmp_path):
    """A `pkg` Scheduler spools three binds under a store outage into its
    journal and is abandoned; a Scheduler of the other package, over a
    store holding the same objects, replays that journal at
    construction (every intent re-spooled under its seq, the store still
    dark) and, healed, drains it to the same bindings."""
    other = PKGS[1 - PKGS.index(pkg)]
    path = str(tmp_path / "bind.journal")
    stores, clocks = {}, {}
    for p in (pkg, other):
        stores[p] = importlib.import_module(f"{p}.runtime.store").ObjectStore()
        clocks[p] = FakeClock()
        for i in range(2):
            stores[p].create("nodes", plain_node(p, f"n{i}", cpu="16",
                                                 memory="32Gi"))
    _, fp = mods(pkg)
    s1 = scheduler(pkg, stores[pkg], clocks[pkg], path)
    fp.activate("store.outage", "raise", times=10 ** 6)
    for p in (pkg, other):
        for i in range(3):
            stores[p].create("pods", plain_pod(p, f"p{i}", cpu="100m",
                                               memory="64Mi"))
    s1.run_once()
    assert s1.spool_count() == 3
    spooled = {e[0].metadata.name: (e[2], e[4]) for e in s1._spool}
    _, ofp = mods(other)
    ofp.activate("store.outage", "raise", times=10 ** 6)
    s2 = scheduler(other, stores[other], clocks[other], path)
    assert {e[0].metadata.name: (e[2], e[4]) for e in s2._spool} == spooled
    assert s2.queue.pending_count() == 0
    ofp.deactivate("store.outage")
    clocks[other].advance(5.0)
    s2.run_once()
    assert s2.spool_count() == 0
    assert s2.journal.unresolved() == []
    assert s2.cache.assumed_pods() == []
    got = {k: v for k, v in bindings(stores[other]).items() if v}
    assert got == {k: v[0] for k, v in spooled.items()}
