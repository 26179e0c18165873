"""kubernetes_tpu_torch on a CUDA card: the hand-written taint/host-port
kernel against its plain PyTorch version, and the scheduler's round on
the card against the same round on the CPU (with inter-pod affinity and
topology spread too). Every test is marked `cuda`
and skips without a card (the kernel has no CPU mode).

This file imports neither JAX nor kubernetes_tpu, so it also runs where
only the port's dependencies are installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import taint_ports as ttp
from kubernetes_tpu_torch.sched.scheduler import Scheduler

from torch_worlds import (bindings, ipa_store_world, op_world,
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
        sched = Scheduler(store, device=device)
        sched.schedule_pending()
        got[device] = bindings(store)
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
