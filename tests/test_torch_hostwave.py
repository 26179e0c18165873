"""The port's numpy twin (kubernetes_tpu_torch/ops/hostwave.py) against
the JAX package's twin and against the port's own torch wave, gang and
what-if on the CPU, and the port's breaker-open degraded mode against the
JAX scheduler's (tests/test_hostwave.py's scenarios, each run through
both packages in lockstep).

Two properties:

  1. PARITY — on seeded worlds the port's twin equals the JAX twin and
     the port's torch kernels, plane for plane: masks, chosen, score,
     fail counts, feasible counts, the round-robin counter, the
     sentinel and the score decomposition (wave, gang, what-if,
     telemetry). twin == torch wave is what chip_smoke.py's phase 17
     checks on the card.
  2. DEGRADED MODE — with the device entries faulted the breaker opens
     and both schedulers drain through their twins: the bindings, the
     breaker, the fault-point hits and the metrics are equal, and the
     placements equal a clean device run.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import hostwave as jhw
from kubernetes_tpu.ops import kernel as jk
from kubernetes_tpu.ops.preempt import preemption_stats as jpreemption_stats
from kubernetes_tpu.utils import tracing as jtracing
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import hostwave as thw
from kubernetes_tpu_torch.ops import kernel as tk
from kubernetes_tpu_torch.ops import preempt as tpre
from kubernetes_tpu_torch.ops import simulate as tsim
from kubernetes_tpu_torch.ops import telemetry as ttele
from kubernetes_tpu_torch.ops.gang import schedule_gang as tschedule_gang
from kubernetes_tpu_torch.runtime.store import ObjectStore
from kubernetes_tpu_torch.sched.breaker import OPEN
from kubernetes_tpu_torch.sched.scheduler import Scheduler
from kubernetes_tpu_torch.utils import tracing as ttracing

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import (LIVE_VECTOR, RICH_WEIGHTS, WAVE_PLANES, Both, arm,
                          check_faults, parity_world)
from torch_worlds import FakeClock, bindings, op_world, plain_node, plain_pod

TORCH = "kubernetes_tpu_torch"
KERNEL_POINTS = ("kernel.round", "kernel.wave", "kernel.gang", "kernel.hang",
                 "wave.poison")


def _zl(snap):
    return dict(num_zones=snap.caps.Z, num_label_values=snap.num_label_values)


def _weights(kind):
    """(JAX kwargs, port twin kwargs, port torch kwargs) for the default
    weights or the RICH_WEIGHTS gating with the LIVE_VECTOR."""
    if kind == "default":
        return (dict(weights=jk.Weights()), dict(weights=tk.Weights()),
                dict(weights=tk.Weights()))
    return (dict(weights=jk.Weights(**RICH_WEIGHTS), weight_vec=LIVE_VECTOR),
            dict(weights=tk.Weights(**RICH_WEIGHTS), weight_vec=LIVE_VECTOR),
            dict(weights=tk.Weights(**RICH_WEIGHTS),
                 weight_vec=tenc.weight_vec_to_torch(LIVE_VECTOR, "cpu")))


def same(a, t, name=""):
    """A twin plane (numpy) and a torch plane: the same shape and every
    element equal. The twins count fail_counts in int64 where the
    kernels count in int32, so dtypes are not compared here (the two
    twins are compared dtype and all)."""
    a = np.asarray(a)
    b = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _same_wave(want, got, torch_res=None, deco=False):
    """The JAX twin's WaveResult, the port twin's and (where given) the
    port's torch wave: every plane equal."""
    for name in WAVE_PLANES:
        a = np.asarray(getattr(want, name))
        b = np.asarray(getattr(got, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        if torch_res is not None:
            same(a, getattr(torch_res, name), name)
    if deco:
        for k, (a, b) in enumerate(zip(want.deco, got.deco)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"deco[{k}]")
            if torch_res is not None:
                same(a, torch_res.deco[k], f"deco[{k}]")


# -- 1. parity of the twin ---------------------------------------------------


@pytest.mark.parametrize("weights", ["default", "vector"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wave_twin_equals_jax_twin_and_torch_wave(seed, weights):
    """schedule_wave_host of both packages and the port's schedule_wave on
    CPU tensors: every plane equal, host masks and extra scores in."""
    snap, pb, _ = op_world("kubernetes_tpu", seed, n_pending=14)
    nt, pm, tt = snap.host_tensors()
    P, N = pb.req.shape[0], nt.valid.shape[0]
    rng = np.random.RandomState(seed)
    extra = rng.rand(P, N) < 0.95
    scores = rng.randint(0, 3, size=(P, N)).astype(np.float32)
    kj, kh, kt = _weights(weights)
    want, _ = jhw.schedule_wave_host(nt, pm, tt, pb, extra, seed, scores,
                                     **kj, **_zl(snap))
    got, _ = thw.schedule_wave_host(nt, pm, tt, pb, extra, seed, scores,
                                    **kh, **_zl(snap))
    ntt, pmt, ttt, pbt = tenc.to_torch(nt, pm, tt, pb, "cpu")
    res = tk.schedule_wave(ntt, pmt, ttt, pbt, torch.from_numpy(extra),
                           torch.tensor(seed, dtype=torch.int32),
                           torch.from_numpy(scores), **kt, **_zl(snap))
    _same_wave(want, got, res)
    assert (got.chosen[:14] >= 0).any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ipa_wave_twin_parity_with_decomposition(seed):
    """Affinity and spread worlds (the incoming_statics_host and
    topo_statics_host planes): the two twins and the torch wave agree on
    every plane and on the score decomposition."""
    snap, (nt, pm, tt, pb), (ntt, pmt, ttt, pbt) = parity_world(seed)
    P, N = pb.req.shape[0], nt.valid.shape[0]
    extra = np.ones((P, N), bool)
    kw = dict(has_ipa=True, collect_scores=True, **_zl(snap))
    want, _ = jhw.schedule_wave_host(nt, pm, tt, pb, extra, 2, None,
                                     weights=jk.Weights(), **kw)
    got, _ = thw.schedule_wave_host(nt, pm, tt, pb, extra, 2, None,
                                    weights=tk.Weights(), **kw)
    res = tk.schedule_wave(ntt, pmt, ttt, pbt, torch.from_numpy(extra),
                           torch.tensor(2, dtype=torch.int32), None,
                           weights=tk.Weights(), **kw)
    assert pb.ra_has.any() or pb.rn_has.any() or (pb.pa_w != 0).any()
    _same_wave(want, got, res, deco=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gang_twin_parity(seed):
    """schedule_gang_host of both packages and the port's schedule_gang:
    ok, chosen, placed, rr and the sentinel equal, for a need the
    members meet and one they do not."""
    snap, (nt, pm, tt, pb), (ntt, pmt, ttt, pbt) = parity_world(seed + 10)
    P, N = pb.req.shape[0], nt.valid.shape[0]
    extra = np.ones((P, N), bool)
    for need in (2, P + 1):
        kw = dict(has_ipa=True, **_zl(snap))
        want = jhw.schedule_gang_host(nt, pm, tt, pb, extra, 1, None, need,
                                      weights=jk.Weights(), **kw)
        got = thw.schedule_gang_host(nt, pm, tt, pb, extra, 1, None, need,
                                     weights=tk.Weights(), **kw)
        res = tschedule_gang(ntt, pmt, ttt, pbt, torch.from_numpy(extra),
                             torch.tensor(1, dtype=torch.int32), None,
                             torch.tensor(need, dtype=torch.int32),
                             weights=tk.Weights(), **kw)
        for name in ("ok", "chosen", "placed", "rr_end", "finite",
                     "fail_counts", "masks"):
            a = np.asarray(getattr(want, name))
            np.testing.assert_array_equal(a, np.asarray(getattr(got, name)),
                                          err_msg=name)
            same(a, getattr(res, name), name)
        assert bool(got.ok) == (need == 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preemption_stats_twin_parity(seed):
    """The packed [5, P, N] what-if planes: the port's twin, the JAX twin
    and the port's preemption_stats on CPU tensors (its plain version)
    byte for byte, with gang weights in play; victim_levels moved into
    the twin and is the one ops/preempt.py exports."""
    snap, (nt, pm, tt, pb), (ntt, pmt, _, pbt) = parity_world(seed + 20)
    assert tpre.victim_levels is thw.victim_levels
    assert tpre.preemption_stats_host is thw.preemption_stats_host
    live = pm.valid & pm.alive
    levels = thw.victim_levels(pm.prio, live, 8)
    assert levels == jhw.victim_levels(pm.prio, live, 8)
    gang_w = np.zeros((pm.valid.shape[0],), np.float32)
    gang_w[:5] = 1.0
    want = jhw.preemption_stats_host(nt, pm, pb, np.asarray(levels, np.int32),
                                     num_levels=8, gang_w=gang_w)
    got = thw.preemption_stats_host(nt, pm, pb, np.asarray(levels, np.int32),
                                    num_levels=8, gang_w=gang_w)
    np.testing.assert_array_equal(want, got)
    dev = tpre.preemption_stats(ntt, pmt, pbt, levels, num_levels=8,
                                gang_w=gang_w).numpy()
    np.testing.assert_array_equal(want, dev)
    jdev = np.asarray(jpreemption_stats(nt, pm, pb,
                                        np.asarray(levels, np.int32),
                                        num_levels=8, gang_w=gang_w))
    np.testing.assert_array_equal(jdev, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_telemetry_twin_parity(seed):
    """cluster_telemetry_host (the port's reduction on CPU tensors made
    from the host planes) equals the JAX twin and the port's device
    reduction, bit for bit."""
    snap, (nt, pm, tt, pb), (ntt, _, _, _) = parity_world(seed + 30)
    Z = snap.caps.Z
    got = thw.cluster_telemetry_host(nt, num_zones=Z)
    want = jhw.cluster_telemetry_host(nt, num_zones=Z)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    dev = ttele.cluster_telemetry(ntt, num_zones=Z).numpy()
    assert dev.dtype == got.dtype
    np.testing.assert_array_equal(got.view(np.int32), dev.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_matches_golden_oracle(seed):
    """The port twin's combined feasibility per (pod, node) equals the
    port's golden predicates, over a shared-vocab shadow snapshot so the
    live mirror stays untouched."""
    from kubernetes_tpu_torch.plugins import golden
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.featurize import PodFeaturizer
    from kubernetes_tpu_torch.state.snapshot import Snapshot
    from torch_worlds import make_nodes, make_pod

    # op_world's world, with its cache kept
    rng = np.random.RandomState(seed)
    cache, snap = SchedulerCache(), Snapshot()
    for node in make_nodes(TORCH, rng, 24):
        cache.add_node(node)
        snap.set_node(cache.node_infos[node.name])
    for i in range(16):
        p = make_pod(TORCH, rng, f"e{i}", 24,
                     node_name=f"n{rng.randint(24)}", rich=False)
        cache.add_pod(p)
        snap.refresh_node_resources(cache.node_infos[p.spec.node_name])
        snap.add_pod(p)
    pods = [make_pod(TORCH, rng, f"p{i}", 24) for i in range(6)]
    shadow, _ = tsim.shadow_snapshot(cache, snap)
    feat = PodFeaturizer(shadow)
    for pod in pods:
        pb = feat.featurize([pod])
        nt, pm, tt = shadow.host_tensors()
        extra = np.ones((pb.req.shape[0], shadow.caps.N), bool)
        res, _ = thw.schedule_wave_host(
            nt, pm, tt, pb, extra, 0, None, weights=tk.Weights(),
            **_zl(shadow))
        combined = res.masks.all(axis=0)[0]
        for name, idx in shadow.node_index.items():
            ni = cache.node_infos.get(name)
            if ni is None or ni.node is None:
                continue
            ok, _reasons = golden.pod_fits_on_node(pod, ni)
            assert bool(combined[idx]) == ok, (pod.metadata.name, name)


# -- 2. the simulate host backend --------------------------------------------


def _shadow_batch(seed):
    """A port scheduler over a seeded store world, the shadow snapshot of
    its cache and the featurized pending pods."""
    from torch_worlds import store_world

    store, names = store_world(TORCH, seed, 12, 10)
    sched = Scheduler(store, wave_size=16, device="cpu", clock=FakeClock())
    pending = [store.get("pods", "default", n) for n in names]
    shadow, n_real = tsim.shadow_snapshot(sched.cache, sched.snapshot)
    pb = sched.shadow_featurizer(shadow).featurize(pending)
    kw = dict(weights=sched.profile.weights(), **_zl(shadow))
    return shadow, pb, kw


@pytest.mark.parametrize("seed", [3, 7])
def test_simulate_host_backend_matches_device(seed):
    """simulate_placements and simulate_refit with backend="host" (the
    twin, the autoscaler's OPEN-breaker branch) return the device
    branch's verdicts on the same shadow, element for element."""
    shadow, pb, kw = _shadow_batch(seed)
    v_d = tsim.simulate_placements(shadow, pb, device="cpu", **kw)
    v_h = tsim.simulate_placements(shadow, pb, backend="host", **kw)
    for f in ("chosen", "feasible"):
        a, b = getattr(v_d, f), getattr(v_h, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for need in (1, pb.req.shape[0] + 1):
        ok_d, ch_d = tsim.simulate_refit(shadow, pb, need, device="cpu", **kw)
        ok_h, ch_h = tsim.simulate_refit(shadow, pb, need, backend="host",
                                         **kw)
        assert ok_d == ok_h
        np.testing.assert_array_equal(ch_d, ch_h)


# -- 3. degraded mode, both packages in lockstep ------------------------------


def _faulted(n_nodes=4, cpu="4", wave=8, threshold=2, **node_kw):
    """Both schedulers on a cluster whose device path faults at every
    kernel entry: after `threshold` failures the breaker opens and the
    twins carry."""
    b = Both(n_nodes, wave=wave, sched_kw=dict(breaker_threshold=threshold),
             cpu=cpu, **node_kw)
    for name in ("kernel.round", "kernel.wave", "kernel.gang"):
        arm(name)
    return b


def test_breaker_open_placements_match_device_path():
    """A clean port run and a breaker-open run of the same workload land
    every pod on the same node; the faulted run equals the JAX
    scheduler's in lockstep (bindings, breaker, hits, metrics)."""
    clean = Both(5, wave=8, cpu="4")
    for i in range(12):
        clean.pod(f"p{i}", cpu="1")
    assert clean.run() == 12
    want = bindings(clean.stores["torch"])
    b = Both(5, wave=8, sched_kw=dict(breaker_threshold=1), cpu="4")
    arm("kernel.round")
    arm("kernel.wave")
    for i in range(12):
        b.pod(f"p{i}", cpu="1")
    assert b.run() == 12
    check_faults(b, KERNEL_POINTS)
    t = b.sched["torch"]
    assert t.breaker.state == OPEN
    assert bindings(b.stores["torch"]) == want
    assert t.metrics.waves_total.value(path="host") >= 1
    assert t.wave_path() == "host"
    assert b.sched["jax"].wave_path() == "vector"


def test_degraded_preemption_is_batched():
    """Breaker open, a saturated cluster and a high-priority backlog:
    the evictions go through the twin's batched what-if (pipeline
    accounting), equal in both packages, and the vips land."""
    b = _faulted(n_nodes=4, cpu="2", wave=4)
    for i in range(4):
        b.pod(f"hog-{i}", cpu="2", priority=1)
    assert b.run() == 4
    for i in range(4):
        b.pod(f"vip-{i}", cpu="2", priority=100)
    b.run()
    check_faults(b, KERNEL_POINTS)
    t = b.sched["torch"]
    assert t.breaker.state == OPEN
    assert t.pipeline_preemptions == 4
    for _ in range(4):
        b.advance(2.0)
        b.run()
    check_faults(b, KERNEL_POINTS)
    assert all(b.stores["torch"].get("pods", "default",
                                     f"vip-{i}").spec.node_name
               for i in range(4))


def test_degraded_gang_atomicity_restored():
    """Gangs stay all-or-nothing on the twin: a gang that fits places
    whole, one that cannot places nothing; both packages equal."""
    b = _faulted(n_nodes=3, cpu="2", wave=8)
    for i in range(2):
        b.pod(f"filler-{i}", cpu="100m")
    assert b.run() == 2
    assert b.sched["torch"].breaker.state == OPEN
    for i in range(2):
        b.delete(f"filler-{i}")
    for j in range(3):
        b.pod(f"fits-{j}", cpu="2", gang="fits", min_avail=3)
    assert b.run() == 3
    for j in range(4):
        b.pod(f"toobig-{j}", cpu="2", gang="toobig", min_avail=4)
    assert b.run() == 0
    check_faults(b, KERNEL_POINTS)
    assert not any(b.stores["torch"].get("pods", "default",
                                         f"toobig-{j}").spec.node_name
                   for j in range(4))


def _anti(api, lbl):
    return api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
        required=[api.PodAffinityTerm(
            label_selector=lbl.LabelSelector(match_labels={"g": "x"}),
            topology_key="kubernetes.io/hostname")]))


def test_degraded_affinity_pods_take_the_twin():
    """Anti-affine pods stay on the batched twin while the breaker is
    open (no golden routing) and still get one host each."""
    b = _faulted(n_nodes=3, cpu="4", wave=8)
    for i in range(3):
        b.pod(f"anti-{i}", cpu="1", labels={"g": "x"}, affinity=_anti)
    assert b.run() == 3
    check_faults(b, KERNEL_POINTS)
    t = b.sched["torch"]
    assert t.breaker.state == OPEN
    nodes = {b.stores["torch"].get("pods", "default",
                                   f"anti-{i}").spec.node_name
             for i in range(3)}
    assert len(nodes) == 3
    assert t.metrics.degraded_golden_pods.value(reason="affinity") == 0
    assert t.metrics.waves_total.value(path="host") >= 1


def test_degraded_golden_reasons_and_ledger_tag():
    """A multi-topology-key pod drained while the breaker is open counts
    under reason=multi_tk in both packages, and the degraded round's
    ledger records carry the tally, the twin's telemetry and the
    breaker's state."""
    from torch_worlds import multikey_affinity

    b = _faulted(n_nodes=4, cpu="8", wave=8, zone="z0")
    recs = {"jax": jtracing.enable(), "torch": ttracing.enable()}
    try:
        for i in range(3):
            b.pod(f"plain-{i}", cpu="1")
        assert b.run() == 3
        assert b.sched["torch"].breaker.state == OPEN
        b.pod("anchor", cpu="1", labels={"app": "db", "tier": "cache"},
              node_name="n1")
        b.pod("multi-tk", cpu="1", affinity=multikey_affinity())
        assert b.run() == 1
        check_faults(b, KERNEL_POINTS)
        rows = {s: [r for r in recs[s].ledger_rows()
                    if r.get("degraded_golden")] for s in recs}
        assert rows["torch"] and rows["jax"]
        assert rows["torch"][-1]["degraded_golden"] == {"multi_tk": 1}
        assert (rows["torch"][-1]["degraded_golden"]
                == rows["jax"][-1]["degraded_golden"])
        kinds = {s: [(r["kind"], r["outcome"], r.get("breaker"))
                     for r in recs[s].ledger_rows()] for s in recs}
        assert kinds["torch"] == kinds["jax"]
        deg = [r for r in recs["torch"].ledger_rows()
               if r["kind"] == "degraded"]
        assert deg and all(r["path"] == "host" for r in deg)
        assert deg[-1]["telemetry"]["backend"] == "host"
    finally:
        jtracing.disable()
        ttracing.disable()


def test_degraded_affinity_e2e_matches_clean_device_run():
    """Breaker open from the first dispatch: required anti-affinity and
    preferred affinity pods place exactly where a clean port run places
    them, equal to the JAX scheduler, none routed golden."""

    def pref(api, lbl):
        return api.Affinity(pod_affinity=api.PodAffinity(
            preferred=[api.WeightedPodAffinityTerm(
                weight=10, pod_affinity_term=api.PodAffinityTerm(
                    label_selector=lbl.LabelSelector(
                        match_labels={"app": "w"}),
                    topology_key="failure-domain.beta.kubernetes.io/"
                                 "zone"))]))

    def anti(api, lbl):
        return api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
            required=[api.PodAffinityTerm(
                label_selector=lbl.LabelSelector(
                    match_labels={"anti": "a"}),
                topology_key="kubernetes.io/hostname")]))

    def world(b):
        for i in range(8):
            for side, store in b.stores.items():
                store.create("nodes", plain_node(b.pkg(side), f"n{i}",
                                                 cpu="8", memory="16Gi",
                                                 zone=f"z{i % 2}"))
        for i in range(12):
            if i % 4 == 0:
                b.pod(f"p{i}", cpu="500m", memory="128Mi",
                      labels={"anti": "a", "app": "w"}, affinity=anti)
            elif i % 4 == 1:
                b.pod(f"p{i}", cpu="500m", memory="128Mi",
                      labels={"app": "w"}, affinity=pref)
            else:
                b.pod(f"p{i}", cpu="500m", memory="128Mi",
                      labels={"app": "w"})

    clean = Both(0, wave=8)
    world(clean)
    assert clean.run() == 12
    want = bindings(clean.stores["torch"])
    b = _faulted(n_nodes=0, wave=8, threshold=1)
    world(b)
    assert b.run() == 12
    check_faults(b, KERNEL_POINTS)
    assert b.sched["torch"].breaker.state == OPEN
    assert bindings(b.stores["torch"]) == want
    assert b.sched["torch"].metrics.degraded_golden_pods.value(
        reason="affinity") == 0


def test_prune_preserves_preempt_choice():
    """The port's preempt() with the twin's candidate prune picks the
    node and victims the validate-everything loop picks."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.sched.preemption import preempt

    store = ObjectStore()
    sched = Scheduler(store, wave_size=4, device="cpu", clock=FakeClock())
    for i in range(6):
        store.create("nodes", plain_node(TORCH, f"n{i}", cpu="2"))
    for i in range(6):
        store.create("pods", plain_pod(TORCH, f"hog-{i}", cpu="2",
                                       priority=1 if i % 2 else 50))
    assert sched.schedule_pending() == 6
    vip = plain_pod(TORCH, "vip", cpu="2", priority=100)
    failed = {f"n{i}": ["PodFitsResources"] for i in range(6)}
    exact = preempt(vip, sched.cache, failed, [])
    pruned = preempt(vip, sched.cache, failed, [], snapshot=sched.snapshot,
                     featurizer=sched.featurizer)
    assert exact is not None and pruned is not None
    assert ({v.uid for v in pruned.victims}
            == {v.uid for v in exact.victims})
    assert api.pod_priority(pruned.victims[0]) == 1


def test_prune_drops_hopeless_nodes():
    """A node that cannot fit the pod even with every lower-priority pod
    removed is pruned by the twin before any validation."""
    from kubernetes_tpu_torch.sched.preemption import vector_candidate_order

    store = ObjectStore()
    sched = Scheduler(store, wave_size=4, device="cpu", clock=FakeClock())
    store.create("nodes", plain_node(TORCH, "big", cpu="4"))
    store.create("nodes", plain_node(TORCH, "small", cpu="1"))
    store.create("pods", plain_pod(TORCH, "hog-big", cpu="4", priority=1))
    store.create("pods", plain_pod(TORCH, "hog-small", cpu="1", priority=1))
    assert sched.schedule_pending() == 2
    vip = plain_pod(TORCH, "vip", cpu="3", priority=100)
    assert vector_candidate_order(vip, sched.snapshot,
                                  sched.featurizer) == ["big"]
