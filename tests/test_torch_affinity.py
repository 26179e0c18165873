"""Inter-pod affinity in kubernetes_tpu_torch (ops/affinity.py and the
has_ipa step of ops/kernel.py) against the JAX package, bit-equal.

The same seeded worlds (tests/torch_worlds.py `ipa_world`,
`ipa_store_world`) go through the JAX function and its port: every
IncomingStatics field, every WaveResult plane of schedule_wave with
has_ipa (and has_ts where the world spreads), every output of
schedule_round over chained waves, and the bindings of the two
Schedulers. The tolerance is exact equality throughout: the planes are
booleans, integer domain ids, and f32 sums of integer weights.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import affinity as ja
from kubernetes_tpu.ops import encoding as jenc
from kubernetes_tpu.ops import kernel as jk
from kubernetes_tpu.ops.scores import stack_weights
from kubernetes_tpu.plugins.registry import default_profile
from kubernetes_tpu.sched import scheduler as jsched
from kubernetes_tpu.state.featurize import PodFeaturizer
from kubernetes_tpu_torch.api import labels as tlbl
from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.ops import affinity as ta
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import kernel as tk
from kubernetes_tpu_torch.sched import scheduler as tsched
from kubernetes_tpu_torch.state.featurize import PodFeaturizer as TPodFeaturizer

from torch_guard import jax_watchdog_off, torch_one_thread  # noqa: F401
from torch_parity import (CAPS, LIVE_VECTOR, WAVE_PLANES, assemble,
                          compare_rounds, eq, parity_world, round_inputs)
from torch_worlds import HOSTNAME, bindings, ipa_store_world, ipa_world

SEEDS = range(6)


@pytest.mark.parametrize("seed,hard_weight", [(s, (1.0, 0.0, 10.0)[s % 3])
                                              for s in SEEDS])
def test_incoming_statics(seed, hard_weight):
    snap, (nt, pm, tt, pb), (ntt, pmt, ttt, pbt) = parity_world(seed)
    lv = snap.num_label_values
    want = ja.incoming_statics(nt, pm, tt, pb, lv, hard_weight)
    got = ta.incoming_statics(ntt, pmt, ttt, pbt, lv, hard_weight)
    for name in want._fields:
        eq(getattr(want, name), getattr(got, name), name)
    P, N = pb.req.shape[0], nt.valid.shape[0]
    assert got.wm_aff.shape == got.wm_anti.shape == (P, P)
    assert got.counts.shape == (P, N)


def test_worlds_exercise_every_plane():
    """Across the seeds, every affinity plane is live somewhere."""
    live = {}
    for seed in SEEDS:
        snap, _, (ntt, pmt, ttt, pbt) = parity_world(seed)
        got = ta.incoming_statics(ntt, pmt, ttt, pbt, snap.num_label_values,
                                  1.0)
        for name in ("sym_blocked", "ok_aff", "any_aff", "blocked_anti",
                     "wm_aff", "wm_anti"):
            live[name] = live.get(name, False) or bool(
                getattr(got, name).any())
        live["counts"] = live.get("counts", False) or bool(
            (got.counts != 0).any())
        live["ra_self"] = live.get("ra_self", False) or bool(
            (pbt.ra_self & ~got.any_aff).any())
    assert all(live.values()), live


@pytest.mark.parametrize("seed", SEEDS)
def test_helpers(seed):
    snap, (nt, pm, tt, pb), (ntt, pmt, ttt, pbt) = parity_world(seed)
    eq(ja.term_entry_match(tt, pb), ta.term_entry_match(ttt, pbt),
        "term_entry_match")
    eq(ja.same_domain(tt, nt), ta.same_domain(ttt, ntt), "same_domain")
    eq(ja.ns_match(tt.ns, pb.ns_id), ta.ns_match(ttt.ns, pbt.ns_id),
        "ns_match")
    eq(ja.node_domains(nt, pb.ts_tk), ta.node_domains(ntt, pbt.ts_tk),
        "node_domains")
    em = ja.term_entry_match(tt, pb)
    sd = ja.same_domain(tt, nt)
    eq(ja._bool_matmul(em, sd),
        ta._bool_matmul(torch.from_numpy(np.array(em)),
                        torch.from_numpy(np.array(sd))), "_bool_matmul")


def test_label_value_ids_stay_below_num_label_values():
    """The segment ids the round gathers with are node label-value ids,
    and the snapshot's num_label_values grows with the vocabulary: every
    id is in range (so no gather on the card is clamped)."""
    for seed in SEEDS:
        snap, (nt, _, _, _), _ = parity_world(seed)
        assert int(np.asarray(nt.labels).max()) < snap.num_label_values
        assert snap.vocabs.label_values.size <= snap.num_label_values


@pytest.mark.parametrize("count", [False, True])
def test_anchored_hit_drops_out_of_range_ids_like_segment_sum(count):
    rng = np.random.RandomState(7)
    match = rng.rand(5, 40) < 0.6
    # ids 0..11 against 8 segments: 0 never counts, 8..11 are dropped
    dom = rng.randint(0, 12, size=(5, 40)).astype(np.int32)
    want = ja._anchored_hit(match, dom, 8, count=count)
    got = ta._anchored_hit(torch.from_numpy(match), torch.from_numpy(dom), 8,
                           count=count)
    eq(want, got)


def _wave_kw(weights, snap):
    """Both cases pass a traced weight vector (the default weights' own,
    or LIVE_VECTOR), so that they share one compiled JAX program; the
    weight_vec=None path is held by tests/test_torch_kernel.py."""
    zl = dict(num_zones=snap.caps.Z, num_label_values=snap.num_label_values)
    vec = (stack_weights(jk.Weights()) if weights == "default"
           else LIVE_VECTOR)
    return (dict(weights=jk.Weights(), weight_vec=vec, **zl),
            dict(weights=tk.Weights(),
                 weight_vec=tenc.weight_vec_to_torch(vec, "cpu"), **zl))


@pytest.mark.parametrize("weights", ["default", "vector"])
@pytest.mark.parametrize("seed", SEEDS)
def test_schedule_wave_with_ipa(seed, weights):
    snap, (nt, pm, tt, pb), (ntt, pmt, ttt, pbt) = parity_world(seed)
    assert pb.ts_valid.any()  # has_ts rides along, derived by both
    P, N = pb.req.shape[0], nt.valid.shape[0]
    extra_mask = np.random.RandomState(seed).rand(P, N) < 0.97
    kw_j, kw_t = _wave_kw(weights, snap)
    want = jk.schedule_wave(nt, pm, tt, pb, extra_mask, np.int32(seed),
                            has_ipa=True, **kw_j)
    got = tk.schedule_wave(ntt, pmt, ttt, pbt, torch.from_numpy(extra_mask),
                           torch.tensor(seed, dtype=torch.int32),
                           has_ipa=True, **kw_t)
    for name in WAVE_PLANES:
        eq(getattr(want, name), getattr(got, name), name)
    ipa_i = tenc.PRED_IDX["MatchInterPodAffinity"]
    # the affinity row is filled in, and some pods still place
    assert (got.fail_counts[ipa_i] > 0).any()
    assert (got.chosen >= 0).any()


@pytest.mark.parametrize("seed,wave_sizes,vector", [
    (0, (16, 16), False), (1, (9, 16, 5), True), (2, (16, 16, 16, 4), False),
    (3, (12, 7), True)])
def test_schedule_round_with_ipa(seed, wave_sizes, vector):
    snap, inputs = round_inputs(seed, wave_sizes)
    chosen = compare_rounds(snap, inputs, has_ipa=True, vector=vector)
    assert (chosen[1] >= 0).any()  # a later wave places too


def _chain_world(pkg, direction):
    """Two nodes, two waves of one pod each. `symmetry`: wave 0's pod
    carries a required hostname anti-affinity term against `grp=x`, wave
    1's pod is `grp=x` — only the term table row that the round stages
    after wave 0 keeps it off wave 0's node. `incoming`: the other way
    round — the pod matrix row staged after wave 0 carries the label that
    wave 1's anti-affinity term reads."""
    import importlib

    api = importlib.import_module(f"{pkg}.api.types")
    lbl = importlib.import_module(f"{pkg}.api.labels")
    state = importlib.import_module(f"{pkg}.state.snapshot")
    cache_mod = importlib.import_module(f"{pkg}.state.cache")
    cache = cache_mod.SchedulerCache()
    snap = state.Snapshot(caps=jenc.Caps(**CAPS) if pkg == "kubernetes_tpu"
                          else None)
    for i, size in enumerate((64, 2)):  # n0 is the roomier node
        node = api.Node(
            metadata=api.ObjectMeta(name=f"n{i}", uid=f"n{i}",
                                    labels={HOSTNAME: f"n{i}"}),
            status=api.NodeStatus(
                allocatable=api.resource_list(cpu=str(size),
                                              memory=f"{size}Gi", pods=10),
                conditions=[api.NodeCondition(api.NODE_READY,
                                              api.COND_TRUE)]))
        cache.add_node(node)
        snap.set_node(cache.node_infos[node.name])
    anti = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(required=[
        api.PodAffinityTerm(
            label_selector=lbl.LabelSelector(match_labels={"grp": "x"}),
            topology_key=HOSTNAME)]))

    def pod(name, labels, aff):
        return api.Pod(
            metadata=api.ObjectMeta(name=name, uid=name, labels=labels),
            spec=api.PodSpec(affinity=aff, containers=[api.Container(
                resources=api.ResourceRequirements(
                    requests=api.resource_list(cpu="1",
                                               memory="1Gi")))]))

    if direction == "symmetry":
        pods = [pod("a", {"grp": "y"}, anti), pod("b", {"grp": "x"}, None)]
    else:
        pods = [pod("a", {"grp": "x"}, None), pod("b", {"grp": "y"}, anti)]
    return snap, pods


@pytest.mark.parametrize("direction", ["symmetry", "incoming"])
def test_next_wave_sees_the_staged_placement(direction):
    snap, pods = _chain_world("kubernetes_tpu", direction)
    chosen = compare_rounds(
        snap, assemble(snap, PodFeaturizer(snap), [pods[:1], pods[1:]]),
        has_ipa=True)
    # both land on n0 by score, unless wave 1 sees wave 0's placement
    assert chosen[0, 0] == 0 and chosen[1, 0] == 1


def test_port_featurizer_flags_multi_key_pods():
    """needs_host_path: required terms of one kind over two topology
    keys; the same verdict as the JAX featurizer's on the same pods."""
    _, _, pods = ipa_world("kubernetes_tpu_torch", 0, n_pending=40)
    term = tapi.PodAffinityTerm(
        label_selector=tlbl.LabelSelector(match_labels={"grp": "g0"}),
        topology_key=HOSTNAME)
    multi = tapi.Pod(metadata=tapi.ObjectMeta(name="m", uid="m"), spec=
                     tapi.PodSpec(affinity=tapi.Affinity(
                         pod_anti_affinity=tapi.PodAntiAffinity(required=[
                             term, tapi.PodAffinityTerm(
                                 label_selector=term.label_selector,
                                 topology_key="zone")]))))
    assert TPodFeaturizer.needs_host_path(multi)
    _, _, jpods = ipa_world("kubernetes_tpu", 0, n_pending=40)
    assert ([TPodFeaturizer.needs_host_path(p) for p in pods]
            == [PodFeaturizer.needs_host_path(p) for p in jpods])
    assert not any(TPodFeaturizer.needs_host_path(p) for p in pods)


# --- the schedulers ------------------------------------------------------------

STORE_CAPS = dict(N=64, M=512, E=512, P=128, PA=4, UI=64, UP=64, LV=128)


def _jax_bindings(seed, n_nodes, n_pods):
    store, _ = ipa_store_world("kubernetes_tpu", seed, n_nodes, n_pods)
    profile = default_profile(store)
    profile.disable_preemption = True
    jsched.Scheduler(store, profile=profile,
                     caps=jenc.Caps(**STORE_CAPS)).schedule_pending()
    return bindings(store)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bindings_match_the_jax_scheduler(seed):
    want = _jax_bindings(seed, 32, 300)
    store, names = ipa_store_world("kubernetes_tpu_torch", seed, 32, 300)
    sched = tsched.Scheduler(store, device="cpu",
                             caps=tenc.Caps(**STORE_CAPS),
                             disable_preemption=True)
    placed = sched.schedule_pending()
    got = bindings(store)
    assert got == want
    assert placed == sum(1 for n in names if got[n])
    assert placed > len(names) // 4
    assert sched.snapshot.has_affinity_terms


def test_rounds_over_the_ipa_wave_cap_split_identically(monkeypatch):
    """With the ipa cap at 2 waves, a 300-pod affinity backlog (3 waves
    of 128) takes several rounds in both packages, each round's leftover
    going back to the queue before it runs; the bindings stay
    identical."""
    monkeypatch.setattr(jsched, "PIPELINE_MAX_WAVES_IPA", 2)
    monkeypatch.setattr(tsched, "PIPELINE_MAX_WAVES_IPA", 2)
    want = _jax_bindings(3, 32, 300)
    store, _ = ipa_store_world("kubernetes_tpu_torch", 3, 32, 300)
    sched = tsched.Scheduler(store, device="cpu",
                             caps=tenc.Caps(**STORE_CAPS),
                             disable_preemption=True)
    rounds = []
    run = sched._run_pipeline
    monkeypatch.setattr(sched, "_run_pipeline",
                        lambda pods: (rounds.append(len(pods)), run(pods))[1])
    sched.schedule_pending()
    assert bindings(store) == want
    assert len(rounds) > 1 and rounds[0] == 300
    assert tsched.PIPELINE_MAX_WAVES_IPA < tsched.PIPELINE_MAX_WAVES


def test_round_cap_constants_match_the_reference():
    assert tsched.PIPELINE_MAX_WAVES_IPA == jsched.PIPELINE_MAX_WAVES_IPA
    for n in (1, 5, 63, 64, 65, 200):
        assert (tsched.pipeline_bucket(n, hi=64)
                == jsched.pipeline_bucket(n, hi=64))
