"""Preemption in kubernetes_tpu_torch against the JAX package.

ops/preempt.py against kubernetes_tpu/ops/preempt.py `_preemption_stats`
on the same numpy inputs: the packed [5, P, N] stats byte-equal, with and
without gang weights, on random worlds, on worlds whose f32 sums round
(memory requests of hundreds of MB, priorities near 2e9: the order of
the adds shows, and a reordered sum gives other bits), on worlds with
the priority-max sentinels (free rows at node 0, removed rows, nodes no
row points at, ids past the last node) and on ragged shapes. The numpy
twin of the host path and the level list against the JAX package's.
Then the Scheduler end to end against the JAX Scheduler in the scenarios
of tests/test_preempt_pipeline.py and on seeded store worlds with
preemption on: the same bindings, evictions, nominations and counts.
"""

import numpy as np
import pytest

from kubernetes_tpu.ops import encoding as jenc
from kubernetes_tpu.ops import hostwave as jhost
from kubernetes_tpu.ops import preempt as jpre
from kubernetes_tpu.plugins.registry import default_profile
from kubernetes_tpu.sched.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import preempt as tpre
from kubernetes_tpu_torch.sched.scheduler import Scheduler

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both, parity_world
from torch_worlds import FakeClock, bindings, ipa_store_world, store_world

LEVELS = 8


def _world(seed, kind):
    """numpy (nt, pm, tt, pb) of a parity world, reworked for `kind`:
    "random" as built; "large" with victim memory requests of 1e8-1e9
    bytes and priorities up to 2e9 on nodes that must evict to fit, most
    rows on the nodes the pods' static predicates pass; "evict_all" the
    same where only a whole node's live pods make room; "sentinel" with
    free rows at node 0, a passing node no row points at and one whose
    rows are all removed, both with room."""
    _, (nt, pm, tt, pb), _ = parity_world(seed)
    rng = np.random.RandomState(100 + seed)
    N, M = nt.valid.shape[0], pm.node.shape[0]
    pm = pm._replace(**{f: getattr(pm, f).copy()
                        for f in ("node", "valid", "alive", "req", "prio")})
    nt = nt._replace(requested=nt.requested.copy(), alloc=nt.alloc.copy(),
                     pod_count=nt.pod_count.copy(),
                     allowed_pods=nt.allowed_pods.copy())
    pb = pb._replace(prio=pb.prio.copy(), req=pb.req.copy())
    if kind == "random":
        return nt, pm, tt, pb
    ntt, _, _, pbt = tenc.to_torch(nt, None, None, pb, "cpu")
    passing = tpre.static_ok_mask(ntt, pbt).numpy().sum(axis=0)
    good = [int(n) for n in np.argsort(-passing, kind="stable")[:4]
            if passing[n] >= 2]
    assert len(good) >= 3
    pm.valid[:] = rng.rand(M) < 0.9
    pm.alive[:] = pm.valid & (rng.rand(M) < 0.9)
    pm.node[:] = np.where(rng.rand(M) < 0.8, rng.choice(good, M),
                          rng.randint(0, N, M))
    pm.prio[:] = rng.randint(0, 2_000_000_000, M)
    pm.req[:, 0] = rng.randint(0, 900, M)
    pm.req[:, 1] = (rng.rand(M) * 9e8 + 1e8).astype(np.float32)
    room = []
    if kind == "sentinel":
        empty, removed_only = good[0], good[1]
        pm.node[pm.node == empty] = good[2]
        free = rng.rand(M) < 0.25
        pm.node[free] = 0
        pm.valid[free] = pm.alive[free] = False
        removed = ((rng.rand(M) < 0.15) & ~free) | (pm.node == removed_only)
        pm.valid[removed] = pm.alive[removed] = False
        pm.prio[:] = rng.randint(0, 50, M)
        room = [0, empty, removed_only]
    live = pm.valid & pm.alive
    used = np.zeros((N, pm.req.shape[1]), np.float64)
    np.add.at(used, pm.node[pm.valid], pm.req[pm.valid].astype(np.float64))
    nt.requested[:, :2] = used[:, :2].astype(np.float32)
    nt.alloc[:, 1] = (nt.requested[:, 1] * 0.75).astype(np.float32)
    nt.alloc[:, 0] = nt.requested[:, 0] + 500
    nt.pod_count[:] = np.bincount(pm.node[pm.valid], minlength=N)[:N]
    nt.allowed_pods[:] = nt.pod_count + 8
    if room:
        # room without a victim on the sentinel nodes
        nt.alloc[room, 0] = nt.requested[room, 0] + 8000
        nt.alloc[room, 1] = nt.requested[room, 1] + 1e9
    if kind == "evict_all":
        # only evicting every live pod of a node makes room (its pod
        # count): every class is a whole node's live rows
        nt.alloc[:, 0] = nt.requested[:, 0] + 8000
        nt.alloc[:, 1] = nt.requested[:, 1] + 1e9
        live_n = np.bincount(pm.node[live], minlength=N)[:N]
        nt.allowed_pods[:] = nt.pod_count - live_n + 1
    pb.prio[:] = np.where(rng.rand(pb.prio.shape[0]) < 0.3, 40,
                          2_000_000_000)
    pb.req[:, 1] = np.float32(3e8)
    assert live.any()
    return nt, pm, tt, pb


def _gang_w(pm, seed):
    rng = np.random.RandomState(seed)
    return ((rng.rand(pm.node.shape[0]) < 0.5)
            * rng.choice([1.0, 0.25, 3.0], pm.node.shape[0])).astype(
                np.float32)


def _both(nt, pm, tt, pb, gang_w):
    levels = tpre.victim_levels(pm.prio, pm.valid & pm.alive, LEVELS)
    assert levels == jhost.victim_levels(pm.prio, pm.valid & pm.alive,
                                         LEVELS)
    want = np.asarray(jpre.preemption_stats(
        nt, pm, pb, np.asarray(levels, np.int32), num_levels=LEVELS,
        gang_w=gang_w))
    ntt, pmt, _, pbt = tenc.to_torch(nt, pm, tt, pb, "cpu")
    got = tpre.preemption_stats(ntt, pmt, pbt, levels, num_levels=LEVELS,
                                gang_w=gang_w).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    plain = tpre.preemption_stats_plain(ntt, pmt, pbt, levels,
                                        num_levels=LEVELS, gang_w=gang_w)
    np.testing.assert_array_equal(plain.numpy(), want)
    return want, levels


@pytest.mark.parametrize("gang", [False, True])
@pytest.mark.parametrize("kind", ["random", "large", "sentinel"])
@pytest.mark.parametrize("seed", [0, 1])
def test_preemption_stats_match_jax(seed, kind, gang):
    nt, pm, tt, pb = _world(seed, kind)
    packed, _ = _both(nt, pm, tt, pb, _gang_w(pm, seed) if gang else None)
    st = tpre.PreemptStats(packed)
    assert st.ok.any()
    if not gang:
        assert not packed[4].any()
    if kind == "sentinel":
        # a node no row points at keeps INT32_MIN; node 0 (free rows
        # only, or non-victims) NEG; fits without victims there
        maxes = set(st.prio_max[st.ok].tolist())
        assert tpre.INT32_MIN in maxes and tpre.NEG in maxes
    if kind == "large":
        assert (st.victims[st.ok] > 1).any()


@pytest.mark.parametrize("what", ["requests", "gang_weights"])
def test_non_finite_values_in_non_live_rows_match_jax(what):
    """inf, -inf and NaN in the requests or the gang weights of rows that
    are not live — free rows at node 0, removed rows. The JAX program adds
    0 * x of their requests, which is NaN for a non-finite x, so they
    change the result (and the kernel keeps such rows in its row lists,
    ops/preempt.py live_rows); but XLA evaluates its w * gang_w as a
    select, so their gang weights change nothing. The port's plain
    version does both the same."""
    nt, pm, tt, pb = _world(0, "sentinel")
    gw = _gang_w(pm, 0)
    clean, _ = _both(nt, pm, tt, pb, gw)
    rng = np.random.RandomState(7)
    bad = np.flatnonzero(~(pm.valid & pm.alive))
    bad = bad[rng.rand(bad.size) < 0.5]
    odd = rng.choice(np.asarray([np.inf, -np.inf, np.nan], np.float32),
                     bad.size)
    if what == "requests":
        pm = pm._replace(req=pm.req.copy())
        pm.req[bad, rng.randint(0, 2, bad.size)] = odd
    else:
        gw = gw.copy()
        gw[bad] = odd
    packed, _ = _both(nt, pm, tt, pb, gw)
    st = tpre.PreemptStats(packed)
    if what == "requests":  # a NaN core column never fits
        assert not np.array_equal(packed[0], clean[0])
    else:
        assert np.array_equal(packed, clean)
        assert st.ok.any() and (st.gang_viol[st.ok] > 0).any()


def test_reordered_sum_differs():
    """Large sums depend on the order of the adds: the same
    rows in reverse order give other bits (so the plain version's match
    above is an order match, not luck), and the JAX program and the
    plain version agree on that reordered world too."""
    nt, pm, tt, pb = _world(0, "evict_all")
    want, _ = _both(nt, pm, tt, pb, None)
    rev = pm._replace(**{f: np.ascontiguousarray(getattr(pm, f)[::-1])
                         for f in pm._fields})
    flipped, _ = _both(nt, rev, tt, pb, None)
    assert np.array_equal(want[:3], flipped[:3])  # ok, count, max
    assert not np.array_equal(want[3], flipped[3])  # the f32 sums


def test_ragged_shapes_match_jax():
    """P = 1 pod against N = 13 nodes, with rows pointing past the last
    node (dropped, as XLA's segment ops drop them)."""
    nt, pm, tt, pb = _world(1, "large")
    nt = nt._replace(**{f: getattr(nt, f)[:13] for f in nt._fields})
    pb = pb._replace(**{f: getattr(pb, f)[:1] for f in pb._fields})
    pb.prio[:] = 2_000_000_000
    assert (pm.node >= 13).any()
    packed, _ = _both(nt, pm, tt, pb, _gang_w(pm, 1))
    assert packed.shape == (5, 1, 13) and packed[0].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_host_twin_matches_jax(seed):
    """The numpy twin behind the host per-pod candidate ranking."""
    nt, pm, tt, pb = _world(seed, "large")
    levels = np.asarray(tpre.victim_levels(pm.prio, pm.valid & pm.alive,
                                           LEVELS), np.int32)
    gw = _gang_w(pm, seed)
    want = jhost.preemption_stats_host(nt, pm, pb, levels,
                                       num_levels=LEVELS, gang_w=gw)
    got = tpre.preemption_stats_host(nt, pm, pb, levels, num_levels=LEVELS,
                                     gang_w=gw)
    np.testing.assert_array_equal(got, want)


def test_plain_version_on_edge_worlds_keeps_sentinels():
    """The kernel's edge worlds (ops/preempt.py EDGE_WORLDS, held to the
    kernel in tests/test_torch_preempt_host.py and on the card) reach
    the traps: sums that round, both sentinels, no-gang planes."""
    seen = set()
    for P, N, M, kw in tpre.EDGE_WORLDS:
        w = tpre.random_whatif(P, N, M, seed=P + N, device="cpu", **kw)
        out = tpre.whatif_plain(w)
        assert out.shape == (5, P, N)
        ok = out[0].bool()
        seen |= set(out[2][ok].tolist()) & {tpre.NEG, tpre.INT32_MIN}
        if w.gang_w is None:
            assert not out[4].any()
        assert not ok[~w.static_ok].any()
    assert seen == {tpre.NEG, tpre.INT32_MIN}


# --- the Scheduler end to end -------------------------------------------------


def _saturated(n_nodes=6, wave=4, hog_prio=1):
    b = Both(n_nodes, wave=wave, cpu="2")
    for i in range(n_nodes):
        b.pod(f"hog-{i}", cpu="2", priority=hog_prio)
    assert b.run() == n_nodes
    return b


def test_backlog_preempts_through_pipeline_in_two_chunks():
    """8 vips on 8 saturated nodes, wave 4: two preemption chunks, the
    second seeing the first's evictions through the snapshot."""
    b = _saturated(8, wave=4)
    for i in range(8):
        b.pod(f"vip-{i}", cpu="2", priority=100)
    chunks = []
    whatif = b.sched["torch"]._whatif
    b.sched["torch"]._whatif = lambda pb, *a, **kw: (
        chunks.append(int(pb.valid.sum())), whatif(pb, *a, **kw))[1]
    placed = b.run()
    assert chunks == [4, 4]
    assert b.sched["torch"].pipeline_preemptions == 8
    for _ in range(4):
        b.advance(2.0)
        placed += b.run()
        if placed >= 8:
            break
    assert all(b.stores["torch"].get("pods", "default",
                                     f"vip-{i}").spec.node_name
               for i in range(8))


def test_partial_failure_mixes_with_fallback():
    b = _saturated(4, wave=4, hog_prio=50)
    for i in range(4):
        b.pod(f"vip-{i}", cpu="2", priority=100)
    for i in range(4):
        b.pod(f"peer-{i}", cpu="2", priority=50)
    b.run()
    assert b.sched["torch"].pipeline_preemptions == 4
    b.advance(2.0)
    b.run()
    store = b.stores["torch"]
    assert all(store.get("pods", "default", f"vip-{i}").spec.node_name
               for i in range(4))
    assert not any(store.get("pods", "default", f"peer-{i}").spec.node_name
                   for i in range(4))


def test_tie_breaks_pick_the_cheaper_victim():
    b = Both(0, wave=2)
    b.node("na", cpu="2")
    b.node("nb", cpu="2")
    b.pod("pricey", cpu="2", priority=50)
    b.pod("cheap", cpu="2", priority=1)
    assert b.run() == 2
    for i in range(4):
        b.pod(f"vip-{i}", cpu="2", priority=100)
    b.run()
    assert b.sched["torch"].pipeline_preemptions >= 1
    assert b.stores["torch"].get("pods", "default", "cheap") is None


def test_pdb_counted_on_the_chosen_node():
    b = Both(0, wave=2)
    b.node("n0", cpu="2")
    b.pod("guarded", cpu="2", priority=1, labels={"app": "db"})
    assert b.run() == 1
    b.budget("pdb", {"app": "db"}, 0)
    for i in range(4):
        b.pod(f"vip-{i}", cpu="2", priority=100)
    b.run()
    b.advance(2.0)
    b.run()


@pytest.mark.parametrize("seed", [0, 1])
def test_store_worlds_with_preemption_match_jax(seed):
    """Seeded worlds of every predicate with priorities 0, 5 and 10: the
    round fails some pods, the pipeline preempts for them, the per-wave
    loop attributes the rest (host preemption); then the clock passes
    the backoffs and the drain runs again."""
    got = {}
    for pkg, make in (("kubernetes_tpu", lambda s, c: JaxScheduler(
            s, profile=default_profile(s), clock=c)),
            ("kubernetes_tpu_torch", lambda s, c: Scheduler(
                s, device="cpu", clock=c))):
        store, _ = store_world(pkg, seed, 64, 600)
        n_pods = len(store.list("pods"))
        clock = FakeClock()
        sched = make(store, clock)
        counts = [sched.schedule_pending()]
        clock.advance(100.0)
        counts.append(sched.schedule_pending())
        got[pkg] = (bindings(store), counts, sched.pipeline_preemptions)
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    assert got["kubernetes_tpu"][2] > 0  # the pipeline preempted
    assert len(got["kubernetes_tpu"][0]) < n_pods  # and evicted


def test_affinity_world_with_preemption_matches_jax():
    """Pod (anti-)affinity in the cluster: preemption's what-if checks
    the victims' node through the golden cluster view, and the pipeline
    runs the rounds with inter-pod affinity."""
    caps = dict(N=64, M=512, E=512, P=128, PA=4, UI=64, UP=64, LV=128)
    got = {}
    for pkg, make in (("kubernetes_tpu", lambda s, c: JaxScheduler(
            s, clock=c, caps=jenc.Caps(**caps))),
            ("kubernetes_tpu_torch", lambda s, c: Scheduler(
                s, device="cpu", clock=c, caps=tenc.Caps(**caps)))):
        store, _ = ipa_store_world(pkg, 0, 32, 300)
        clock = FakeClock()
        sched = make(store, clock)
        counts = [sched.schedule_pending()]
        clock.advance(100.0)
        counts.append(sched.schedule_pending())
        got[pkg] = (bindings(store), counts, sched.pipeline_preemptions)
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    assert got["kubernetes_tpu"][2] > 0
