"""kubernetes_tpu_torch on a CUDA card: the hand-written taint/host-port
kernel against its plain PyTorch version, the what-if kernel against its
plain version run on a CPU copy of the same inputs (on the card the
plain version's index_add_ sums by atomics, in no fixed order), the gang
dispatch on the card against the CPU, the score decomposition and the
cluster telemetry on the card against the CPU, and the scheduler on the
card against the same scheduler on the CPU (with inter-pod affinity,
topology spread, gangs and preemption too; traced, its ledger rows and
decisions too), the node-lifecycle zone tally on the card against
np.bincount, and one cluster-autoscaler scale-up what-if on the card
against the same pass on the CPU. Every test is marked `cuda` and skips
without a card (the kernels have no CPU mode).

This file imports neither JAX nor kubernetes_tpu, so it also runs where
only the port's dependencies are installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import gang as tgang
from kubernetes_tpu_torch.ops import kernel as tk
from kubernetes_tpu_torch.ops import preempt as tpre
from kubernetes_tpu_torch.ops import taint_ports as ttp
from kubernetes_tpu_torch.ops import telemetry as ttele
from kubernetes_tpu_torch.runtime.store import ObjectStore
from kubernetes_tpu_torch.sched.scheduler import Scheduler
from kubernetes_tpu_torch.utils import tracing

from torch_worlds import (FakeClock, bindings, ipa_store_world, ipa_world,
                          op_world, plain_node, plain_pod,
                          spread_store_world, store_world)

pytestmark = pytest.mark.cuda

EFFECT_SETS = ((tenc.EFFECT_NO_SCHEDULE, tenc.EFFECT_NO_EXECUTE),
               (tenc.EFFECT_NO_EXECUTE,))
SHAPES = [(0, 23, 11), (1, 37, 29), (2, 5, 3), (3, 261, 145)]
# featurized worlds (seed, nodes, pending pods), then the kernel's edges
# as seeded feature tables (P, N, random_tables arguments)
CASES = ([("world", shape) for shape in SHAPES]
         + [("tables", edge) for edge in ttp.EDGE_TABLES])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,case", CASES,
                         ids=[f"{k}{i}" for i, (k, _) in enumerate(CASES)])
def test_kernel_matches_plain_on_card(cuda, kind, case):
    if kind == "world":
        seed, n_nodes, n_pending = case
        snap, pb, _ = op_world("kubernetes_tpu_torch", seed,
                               n_nodes=n_nodes, n_pending=n_pending)
        nt, pb = tenc.to_torch(snap.node_tensors(), None, None, pb,
                               cuda)[::3]
    else:
        P, N, kw = case
        nt, pb = ttp.random_tables(P, N, seed=P + N, device=cuda, **kw)
    plan = ttp.launch_plan(nt, pb)
    tx, rows = plan["block"]
    assert tx in (32, 16) and tx * rows == 256
    assert plan["grid"][0] == -(-nt.taint_key.shape[0] // (16 * tx))
    assert plan["blocks_per_sm"] >= 1
    for eff in EFFECT_SETS:
        before = ttp.taint_ports_masks.launches
        got = ttp.taint_ports_masks(nt, pb, effects=eff)
        torch.cuda.synchronize()
        assert ttp.taint_ports_masks.launches == before + 1
        want = ttp.taint_ports_plain(nt, pb, eff)
        for g, w in zip(got, want):
            assert g.dtype == torch.bool and torch.equal(g, w)


def test_kernel_rejects_what_it_cannot_take(cuda):
    snap, pb, _ = op_world("kubernetes_tpu_torch", 0, n_nodes=9,
                           n_pending=5)
    nt, pb = tenc.to_torch(snap.node_tensors(), None, None, pb, cuda)[::3]
    with pytest.raises(TypeError):
        ttp.taint_ports_masks(nt._replace(ports=nt.ports.long()), pb)
    with pytest.raises(ValueError):
        ttp.taint_ports_masks(nt, pb._replace(tol_key=pb.tol_key.t()))
    with pytest.raises(ValueError):
        ttp.taint_ports_masks(nt, pb._replace(tol_val=pb.tol_val.cpu()))


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_on_card_matches_cpu(cuda, seed):
    got = {}
    for device in ("cuda", "cpu"):
        store, _ = store_world("kubernetes_tpu_torch", seed, 64, 600)
        clock = FakeClock()
        sched = Scheduler(store, device=device, clock=clock)
        sched.schedule_pending()
        clock.advance(100.0)  # past every backoff: the drain runs again
        sched.schedule_pending()
        got[device] = (bindings(store), sched.pipeline_preemptions)
        assert sched.wave_path() == ("cuda" if device == "cuda"
                                     else "torch-cpu")
    assert got["cuda"] == got["cpu"]


@pytest.mark.parametrize("world", ["affinity", "spread"])
def test_affinity_and_spread_rounds_on_card_match_cpu(cuda, world):
    got = {}
    for device in ("cuda", "cpu"):
        if world == "affinity":
            store, _ = ipa_store_world("kubernetes_tpu_torch", 0, 32, 300)
        else:
            store, _ = spread_store_world("kubernetes_tpu_torch", 0, 24, 240,
                                          6)
        Scheduler(store, device=device).schedule_pending()
        got[device] = bindings(store)
    assert got["cuda"] == got["cpu"]
    assert any(got["cuda"].values())


def _whatif_worlds():
    return [(P, N, M, kw) for P, N, M, kw in tpre.EDGE_WORLDS] + [
        (128, 5000, 12000, dict(large=True)), (16, 8192, 40000, {})]


@pytest.mark.parametrize("case", range(len(_whatif_worlds())))
def test_whatif_kernel_matches_cpu_plain(cuda, case):
    P, N, M, kw = _whatif_worlds()[case]
    w = tpre.random_whatif(P, N, M, seed=P + N, device=cuda, **kw)
    before = tpre.preempt_whatif.launches
    got = tpre.preempt_whatif(w)
    torch.cuda.synchronize()
    assert tpre.preempt_whatif.launches == before + 1
    cpu = tpre.WhatIf(*[None if t is None else t.cpu() for t in w])
    assert torch.equal(got.cpu(), tpre.whatif_plain(cpu))


@pytest.mark.parametrize("case", range(len(tpre.EDGE_WORLDS)))
def test_whatif_class_stats_match_cpu_plain(cuda, case):
    """The class-stats table of every (threshold, node), whichever level
    the pick takes, against its plain version on a CPU copy: bit-equal,
    a NaN sum (never a fit) matching in position only."""
    P, N, M, kw = tpre.EDGE_WORLDS[case]
    w = tpre.random_whatif(P, N, M, seed=P + N, device=cuda, **kw)
    prep = tpre.whatif_prepare(w)
    tpre.whatif_launch(prep)
    torch.cuda.synchronize()
    args = prep.tensors
    S = int(args.n_slots)
    cpu = tpre.WhatIf(*[None if t is None else t.cpu() for t in w])
    got = args.stats[:S].cpu()
    want = tpre.class_stats_plain(cpu, args.slot_values[:S].cpu())
    floats = slice(0, w.alloc.shape[1] + 3)
    nan = torch.isnan(got[:, floats].view(torch.float32))
    assert torch.equal(nan, torch.isnan(want[:, floats].view(torch.float32)))
    same = got == want
    same[:, floats] |= nan
    assert bool(same.all())


def test_whatif_kernel_rejects_what_it_cannot_take(cuda):
    w = tpre.random_whatif(4, 9, 32, seed=1, device=cuda)
    with pytest.raises(TypeError):
        tpre.preempt_whatif(w._replace(ep_prio=w.ep_prio.long()))
    with pytest.raises(ValueError):
        tpre.preempt_whatif(w._replace(levels=w.levels.cpu()))
    with pytest.raises(ValueError):
        tpre.preempt_whatif(tpre.random_whatif(4, 9, 32, seed=1, R=17,
                                               device=cuda))


@pytest.mark.parametrize("need", [1, 14])
def test_schedule_gang_on_card_matches_cpu(cuda, need):
    snap, pb, _ = op_world("kubernetes_tpu_torch", 0, n_pending=14)
    nt, pm, tt = snap.host_tensors()
    P, N = pb.req.shape[0], nt.valid.shape[0]
    got = {}
    for dev in (cuda, torch.device("cpu")):
        ntt, pmt, ttt, pbt = tenc.to_torch(nt, pm, tt, pb, dev)
        res = tgang.schedule_gang(
            ntt, pmt, ttt, pbt, torch.ones((P, N), dtype=torch.bool,
                                           device=dev),
            torch.tensor(5, dtype=torch.int32, device=dev), None,
            torch.tensor(need, dtype=torch.int32, device=dev),
            weights=tk.Weights(), num_zones=snap.caps.Z,
            num_label_values=snap.num_label_values,
            ts_valid_host=pb.ts_valid)
        got[dev.type] = [t.cpu() for t in res]
    for name, a, b in zip(tgang.GangResult._fields, got["cuda"], got["cpu"]):
        assert torch.equal(a, b), name


def test_gang_and_preemption_drain_on_card_matches_cpu(cuda):
    """Low-priority gangs fill the nodes, then high-priority single pods
    arrive that place only by evicting gang members (whole gangs go)."""
    got = {}
    for device in ("cuda", "cpu"):
        store = ObjectStore()
        clock = FakeClock()
        sched = Scheduler(store, wave_size=16, device=device, clock=clock,
                          caps=tenc.Caps(P=16))
        pkg = "kubernetes_tpu_torch"
        for i in range(12):
            store.create("nodes", plain_node(pkg, f"n{i}", cpu="16"))
        for g in range(11):
            for j in range(4):
                store.create("pods", plain_pod(pkg, f"g{g}-{j}", cpu="4",
                                               priority=1, gang=f"g{g}",
                                               min_avail=4))
        sched.schedule_pending()
        for i in range(10):
            store.create("pods", plain_pod(pkg, f"high-{i}", cpu="4",
                                           priority=1000))
        sched.schedule_pending()
        clock.advance(10.0)
        sched.schedule_pending()
        got[device] = (bindings(store),
                       sched.metrics.pod_preemption_victims.value)
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][1] > 0 and got["cuda"][1] % 4 == 0


def _planes(x):
    """A tuple of tensors (or one) on the CPU, f32 as int32 bit patterns."""
    ts = x if isinstance(x, tuple) else (x,)
    return [t.cpu().view(torch.int32) if t.dtype == torch.float32
            else t.cpu() for t in ts]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_decomposition_on_card_matches_cpu(cuda, seed):
    """The wave's and the round's ScoreDeco on the card equal the CPU's,
    bit for bit, with inter-pod affinity and spread in play."""
    snap, pb, _ = ipa_world("kubernetes_tpu_torch", seed)
    nt, pm, tt = snap.host_tensors()
    P, N = pb.req.shape[0], nt.valid.shape[0]
    got = {}
    for dev in (cuda, torch.device("cpu")):
        ntt, pmt, ttt, pbt = tenc.to_torch(nt, pm, tt, pb, dev)
        res = tk.schedule_wave(
            ntt, pmt, ttt, pbt, torch.ones((P, N), dtype=torch.bool,
                                           device=dev),
            torch.tensor(3, dtype=torch.int32, device=dev),
            weights=tk.Weights(), num_zones=snap.caps.Z,
            num_label_values=snap.num_label_values, has_ipa=True,
            collect_scores=True)
        got[dev.type] = (_planes((res.chosen, res.score, res.finite))
                         + _planes(tuple(res.deco)))
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_telemetry_on_card_matches_cpu(cuda, seed):
    snap, _, _ = ipa_world("kubernetes_tpu_torch", seed, featurize=False)
    nt = snap.node_tensors()
    got = {}
    for dev in (cuda, torch.device("cpu")):
        ntt = tenc.to_torch(nt, None, None, None, dev)[0]
        got[dev.type] = ttele.cluster_telemetry(
            ntt, num_zones=snap.caps.Z).cpu().view(torch.int32)
    assert torch.equal(got["cuda"], got["cpu"])


def test_traced_scheduler_on_card_matches_cpu(cuda, tmp_path):
    """A traced drain with a candidate profile and the exact shadow
    sample: the ledger rows (less timings and path), the decisions, the
    shadow report and the telemetry gauges on the card equal the CPU's."""
    from kubernetes_tpu_torch.api import types as api

    got = {}
    for device in ("cuda", "cpu"):
        tracing.disable()
        rec = tracing.enable()
        try:
            store, _ = store_world("kubernetes_tpu_torch", 0, 64, 600)
            store.create("weightprofiles", api.WeightProfile(
                metadata=api.ObjectMeta(name="packer"),
                spec=api.WeightProfileSpec(
                    weights={"MostRequested": 1.0})))
            clock = FakeClock()
            sched = Scheduler(store, device=device, clock=clock,
                              shadow_exact_interval=1)
            sched.schedule_pending()
            rows = [{k: v for k, v in r.items()
                     if k not in ("ts", "wall_s", "spans", "path")}
                    for r in rec.ledger_rows()]
            got[device] = (bindings(store), rows, dict(rec.decisions),
                           sched.weightbook.report("packer"),
                           sched.metrics.scheduling_errors.value(
                               stage="telemetry"))
        finally:
            tracing.disable()
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][4] == 0
    assert any("telemetry" in r for r in got["cuda"][1])


@pytest.mark.parametrize("cap,n,z,nz", [(8192, 5000, 3, 8), (64, 40, 7, 8)])
def test_zone_tally_on_card_matches_host(cuda, cap, n, z, nz):
    """The node-lifecycle tally's two int32 segment sums on the card
    equal np.bincount, and the call took the device path."""
    import numpy as np

    from kubernetes_tpu_torch.ops import zonehealth as tzh

    rng = np.random.RandomState(cap + n)
    zone_id = np.zeros((cap,), np.int32)
    zone_id[:n] = rng.randint(0, z, size=n)
    bad = np.zeros((cap,), bool)
    bad[:n] = rng.rand(n) < 0.6
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    tzh.reset_counts()
    got = tzh.zone_tally(zone_id, bad, valid, nz, device=cuda)
    assert tzh.TALLY_COUNTS == {"device": 1, "host": 0, "device_failures": 0}
    for g, w in zip(got, tzh.zone_tally_host(zone_id, bad, valid, nz)):
        assert g.dtype == np.int32 and (g == w).all()


def test_scale_up_what_if_on_card_matches_cpu(cuda):
    """One autoscaler pass over pods no real node can host: the verdict
    (chosen rows and the feasibility plane), the group picked and its
    size on the card equal the CPU's, and the what-if launched the
    taint/port kernel."""
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.cloud.provider import (FakeCloud,
                                                     node_from_template)
    from kubernetes_tpu_torch.controllers import ClusterAutoscaler

    taint = api.Taint(key="dedicated", value="batch",
                      effect=api.NO_SCHEDULE)
    tol = api.Toleration(key="dedicated", operator="Equal", value="batch",
                         effect=api.NO_SCHEDULE)
    got = {}
    for device in ("cuda", "cpu"):
        store = ObjectStore()
        clock = FakeClock()
        sched = Scheduler(store, wave_size=16, device=device, clock=clock)
        for i in range(6):
            store.create("nodes", plain_node("kubernetes_tpu_torch",
                                             f"n{i}", cpu="2"))
        cloud = FakeCloud()
        cloud.joiner = lambda g, name, store=store: store.create(
            "nodes", node_from_template(g, name))
        cloud.add_node_group("std", plain_node("kubernetes_tpu_torch", "t1",
                                               cpu="4"), max_size=8)
        cloud.add_node_group("batch", plain_node(
            "kubernetes_tpu_torch", "t2", cpu="16", taints=[taint]),
            max_size=8, price=2.0)
        ca = ClusterAutoscaler(store, cloud, sched, clock=clock)
        for i in range(12):
            pod = plain_pod("kubernetes_tpu_torch", f"p{i}", cpu="3")
            if i % 2:
                pod.spec.tolerations = [tol]
            store.create("pods", pod)
        assert sched.schedule_pending() == 0
        before = ttp.taint_ports_masks.launches
        r = ca.run_once()
        launched = ttp.taint_ports_masks.launches - before
        v = ca.last_verdict
        got[device] = (r, v.chosen.tolist(), v.feasible.tolist(), v.n_real,
                       ca.last_scale_up,
                       sched.metrics.scheduling_errors.value(
                           stage="autoscaler"))
        if device == "cuda":
            assert launched >= 1
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][0]["scaled_up"] >= 1 and got["cuda"][5] == 0
