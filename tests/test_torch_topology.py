"""Topology spread in kubernetes_tpu_torch (ops/topology.py, the has_ts
step and the TopologySpread score plane of ops/kernel.py) against the
JAX package, bit-equal.

The same seeded worlds go through the JAX function and its port: every
TopoStatics field, every WaveResult plane of schedule_wave with has_ts
(and no inter-pod affinity), every output of schedule_round over chained
waves, and the bindings of the two Schedulers on a store of spread
Deployments. The tolerance is exact equality: the planes are booleans,
integer domain ids and integer-valued f32 counts.
"""

import importlib

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import encoding as jenc
from kubernetes_tpu.ops import kernel as jk
from kubernetes_tpu.ops import topology as jt
from kubernetes_tpu.plugins.registry import default_profile
from kubernetes_tpu.sched import scheduler as jsched
from kubernetes_tpu.state.featurize import PodFeaturizer
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import kernel as tk
from kubernetes_tpu_torch.ops import topology as tt_
from kubernetes_tpu_torch.sched import scheduler as tsched

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import (CAPS, WAVE_PLANES, assemble, compare_rounds, eq,
                          parity_world, round_inputs)
from torch_worlds import ZONE, bindings, spread_store_world, zone_skew

SEEDS = range(6)


@pytest.mark.parametrize("seed", SEEDS)
def test_topo_statics(seed):
    snap, (nt, pm, _, pb), (ntt, pmt, _, pbt) = parity_world(seed)
    lv = snap.num_label_values
    want = jt.topo_statics(nt, pm, pb, lv)
    got = tt_.topo_statics(ntt, pmt, pbt, lv)
    for name in want._fields:
        eq(getattr(want, name), getattr(got, name), name)
    (P, TS), N = pb.ts_tk.shape, nt.valid.shape[0]
    assert got.node_dom.shape == (P, TS, N)
    assert got.counts.shape == got.present.shape == (P, TS, lv)
    assert got.wm.shape == (P, TS, P)
    assert got.selfm.shape == (P, TS)


def test_worlds_exercise_every_spread_case():
    """Across the seeds: hard and soft constraints, resident matches,
    pods that match their own selector and pods that do not, and nodes
    without the constraint's key."""
    live = dict.fromkeys(("hard", "soft", "counts", "selfm", "no_self",
                          "keyless"), False)
    for seed in SEEDS:
        snap, _, (ntt, pmt, _, pbt) = parity_world(seed)
        got = tt_.topo_statics(ntt, pmt, pbt, snap.num_label_values)
        v = pbt.ts_valid
        live["hard"] |= bool((v & pbt.ts_hard).any())
        live["soft"] |= bool((v & ~pbt.ts_hard).any())
        live["counts"] |= bool((got.counts > 0).any())
        live["selfm"] |= bool(got.selfm.any())
        live["no_self"] |= bool((v & ~got.selfm & pbt.valid[:, None]).any())
        keyless = (got.node_dom == 0) & ntt.valid[None, None, :]
        live["keyless"] |= bool((keyless & v[:, :, None]).any())
    assert all(live.values()), live


@pytest.mark.parametrize("seed", range(4))
def test_schedule_wave_with_spread(seed):
    snap, (nt, pm, tt, pb), (ntt, pmt, ttt, pbt) = parity_world(seed)
    P, N = pb.req.shape[0], nt.valid.shape[0]
    extra_mask = np.ones((P, N), bool)
    zl = dict(num_zones=snap.caps.Z, num_label_values=snap.num_label_values)
    want = jk.schedule_wave(nt, pm, tt, pb, extra_mask, np.int32(seed),
                            weights=jk.Weights(), **zl)
    got = tk.schedule_wave(ntt, pmt, ttt, pbt, torch.from_numpy(extra_mask),
                           torch.tensor(seed, dtype=torch.int32),
                           weights=tk.Weights(), **zl)
    for name in WAVE_PLANES:
        eq(getattr(want, name), getattr(got, name), name)
    ts_i = tenc.PRED_IDX["PodTopologySpread"]
    ipa_i = tenc.PRED_IDX["MatchInterPodAffinity"]
    assert (got.fail_counts[ts_i] > 0).any()
    assert got.masks[ipa_i].all()  # has_ipa off: the placeholder row


@pytest.mark.parametrize("seed,wave_sizes", [(0, (16, 16)), (1, (9, 16, 5)),
                                             (4, (16, 16, 16, 4))])
def test_schedule_round_with_spread(seed, wave_sizes):
    snap, inputs = round_inputs(seed, wave_sizes)
    chosen = compare_rounds(snap, inputs, has_ipa=False)
    assert (chosen[1] >= 0).any()


def _zone_world(pkg):
    """Two nodes in two zones, two waves of one pod each, both of app x
    with a hard zone spread (maxSkew 1). Both land on the roomier z0 by
    score unless wave 1 counts wave 0's placement, which the round
    stages into the pod matrix."""
    api = importlib.import_module(f"{pkg}.api.types")
    lbl = importlib.import_module(f"{pkg}.api.labels")
    state = importlib.import_module(f"{pkg}.state.snapshot")
    cache_mod = importlib.import_module(f"{pkg}.state.cache")
    cache = cache_mod.SchedulerCache()
    snap = state.Snapshot(caps=jenc.Caps(**CAPS))
    for i, size in enumerate((64, 2)):
        node = api.Node(
            metadata=api.ObjectMeta(name=f"n{i}", uid=f"n{i}",
                                    labels={ZONE: f"z{i}"}),
            status=api.NodeStatus(
                allocatable=api.resource_list(cpu=str(size),
                                              memory=f"{size}Gi", pods=10),
                conditions=[api.NodeCondition(api.NODE_READY,
                                              api.COND_TRUE)]))
        cache.add_node(node)
        snap.set_node(cache.node_infos[node.name])
    pods = [api.Pod(
        metadata=api.ObjectMeta(name=n, uid=n, labels={"app": "x"}),
        spec=api.PodSpec(
            topology_spread_constraints=[api.TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE,
                when_unsatisfiable=api.DO_NOT_SCHEDULE,
                label_selector=lbl.LabelSelector(match_labels={"app": "x"}))],
            containers=[api.Container(resources=api.ResourceRequirements(
                requests=api.resource_list(cpu="1", memory="1Gi")))]))
        for n in ("a", "b")]
    return snap, pods


def test_next_wave_counts_the_staged_placement():
    snap, pods = _zone_world("kubernetes_tpu")
    chosen = compare_rounds(
        snap, assemble(snap, PodFeaturizer(snap), [pods[:1], pods[1:]]),
        has_ipa=False)
    assert chosen[0, 0] == 0 and chosen[1, 0] == 1


# --- the schedulers ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_bindings_match_the_jax_scheduler(seed, monkeypatch):
    store, _ = spread_store_world("kubernetes_tpu", seed, 24, 240, 6)
    profile = default_profile(store)
    profile.disable_preemption = True
    jsched.Scheduler(store, profile=profile,
                     caps=jenc.Caps(M=512, P=128)).schedule_pending()
    want = bindings(store)
    store, names = spread_store_world("kubernetes_tpu_torch", seed, 24, 240,
                                      6)
    before = zone_skew(store)
    sched = tsched.Scheduler(store, device="cpu", caps=tenc.Caps(M=512,
                                                                 P=128),
                             disable_preemption=True)
    flags = []
    body = tk._wave_body

    def spy(*args, **kw):
        flags.append((args[10], kw["has_ts"]))  # (has_ipa, has_ts)
        return body(*args, **kw)

    monkeypatch.setattr(tk, "_wave_body", spy)
    placed = sched.schedule_pending()
    assert bindings(store) == want
    assert placed > len(names) // 2
    # the hard zone rule holds in the store: no placement widened any
    # Deployment's zone skew past max(1, what the bound pods had)
    for app, skew in zone_skew(store).items():
        assert skew <= max(1, before.get(app, 0)), (app, skew)
    # every wave ran the spread step and no affinity step
    assert flags and set(flags) == {(False, True)}
