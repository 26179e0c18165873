"""Gang scheduling in kubernetes_tpu_torch against the JAX package.

ops/gang.py `schedule_gang` against the JAX `_schedule_gang` on the same
numpy inputs, every GangResult plane bit-equal, for a gang that admits,
one that fails whole (chosen all -1, rr rolled back) and one that admits
with surplus members unplaced; then the Scheduler end to end against the
JAX Scheduler in the scenarios of tests/test_gang.py — the same store
contents, arrivals and virtual clock give the same bindings, the same
evictions and the same schedule_pending counts at every step.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import gang as jgang
from kubernetes_tpu.ops import kernel as jk
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import gang as tgang
from kubernetes_tpu_torch.ops import kernel as tk

from torch_guard import jax_watchdog_off, torch_one_thread  # noqa: F401
from torch_parity import Both, eq
from torch_worlds import op_world

GANG_PLANES = ("ok", "chosen", "placed", "fail_counts", "masks", "rr_end",
               "finite")


def _gangs(seed, need):
    snap, pb, _ = op_world("kubernetes_tpu", seed, n_pending=14)
    nt, pm, tt = snap.host_tensors()
    P, N = pb.req.shape[0], nt.valid.shape[0]
    extra = np.ones((P, N), bool)
    zl = dict(num_zones=snap.caps.Z, num_label_values=snap.num_label_values)
    want = jgang.schedule_gang(nt, pm, tt, pb, extra, np.int32(5), None,
                               np.int32(need), weights=jk.Weights(), **zl)
    ntt, pmt, ttt, pbt = tenc.to_torch(nt, pm, tt, pb, "cpu")
    got = tgang.schedule_gang(ntt, pmt, ttt, pbt, torch.from_numpy(extra),
                              torch.tensor(5, dtype=torch.int32), None,
                              torch.tensor(need, dtype=torch.int32),
                              weights=tk.Weights(),
                              ts_valid_host=pb.ts_valid, **zl)
    for name in GANG_PLANES:
        eq(getattr(want, name), getattr(got, name), name)
    return got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["admit", "fail", "surplus"])
def test_schedule_gang_matches_jax(seed, case):
    placed = int(_gangs(seed, 0).placed)  # what the loop can place
    assert 0 < placed < 14  # some members of the 14 never fit
    need = {"admit": 1, "fail": placed + 1, "surplus": placed}[case]
    got = _gangs(seed, need)
    chosen = got.chosen.numpy()
    if case == "fail":
        # the whole gang fails: nothing placed, rr rolled back
        assert not bool(got.ok) and (chosen == -1).all()
        assert int(got.rr_end) == 5 and int(got.placed) == placed
    else:
        assert bool(got.ok) and (chosen >= 0).sum() == placed
        assert int(got.rr_end) == 5 + placed
        # surplus members the loop could not place stay -1
        assert (chosen[:14] == -1).sum() == 14 - placed


# --- the Scheduler end to end -------------------------------------------------


def test_incomplete_gang_waits_then_releases():
    b = Both(4)
    b.pod("a0", cpu="1", gang="ga", min_avail=3)
    b.pod("a1", cpu="1", gang="ga", min_avail=3)
    assert b.run() == 0
    queue = b.sched["torch"].queue
    assert queue.gang_waiting_count() == 2 and queue.active_count() == 0
    assert [p.metadata.name for p in queue.gang_pending_pods(
        "default/ga")] == ["a0", "a1"]
    b.pod("a2", cpu="1", gang="ga", min_avail=3)
    assert b.run() == 3


def test_min_member_from_podgroup_and_late_podgroup():
    b = Both(4)
    b.group("gb", 2)
    b.pod("b0", cpu="1", gang="gb")
    assert b.run() == 0
    b.pod("b1", cpu="1", gang="gb")
    assert b.run() == 2
    # a PodGroup arriving after its pods lowers minMember and releases
    b.pod("c0", cpu="1", gang="gc", min_avail=5)
    b.pod("c1", cpu="1", gang="gc", min_avail=5)
    assert b.run() == 0
    b.group("gc", 2)
    assert b.run() == 2


def test_member_deleted_while_waiting():
    b = Both(4)
    b.pod("d0", cpu="1", gang="gd", min_avail=3)
    b.pod("d1", cpu="1", gang="gd", min_avail=3)
    assert b.run() == 0
    b.delete("d1")
    b.pod("d2", cpu="1", gang="gd", min_avail=3)
    assert b.run() == 0
    b.pod("d3", cpu="1", gang="gd", min_avail=3)
    assert b.run() == 3


def test_gang_larger_than_cluster_fails_atomically():
    b = Both(2, cpu="2")
    for i in range(4):
        b.pod(f"e{i}", cpu="2", gang="ge", min_avail=4)
    assert b.run() == 0
    assert b.sched["torch"].cache.pod_count() == 0  # no assume leaked
    pod = b.stores["torch"].get("pods", "default", "e0")
    assert any("pod group could not be placed in full" in c[1]
               for c in pod.status.conditions)
    b.node("late", cpu="2")
    assert b.sched["torch"].queue.active_count() == 0  # inside the window
    b.advance(1.1)
    assert b.run() == 0  # 3 nodes < 4 pods: fails whole again
    b.node("late2", cpu="2")
    b.advance(2.2)  # the second failure doubled the gang's window
    assert b.run() == 4


def test_two_gangs_contending_never_interleave():
    b = Both(4, cpu="2")
    for i in range(3):
        b.pod(f"ga{i}", cpu="2", gang="g-left", min_avail=3)
        b.pod(f"gb{i}", cpu="2", gang="g-right", min_avail=3)
    for round_i in range(8):
        b.run()
        for gang in ("g-left", "g-right"):
            assert b.bound(gang) in (0, 3)
        b.advance(2.0 ** min(round_i, 6) + 0.1)
    assert sorted(b.bound(g) for g in ("g-left", "g-right")) == [0, 3]


def test_loser_gang_places_after_capacity_frees():
    b = Both(3, cpu="2")
    for i in range(3):
        b.pod(f"wa{i}", cpu="2", gang="g-win", min_avail=3)
    assert b.run() == 3
    for i in range(3):
        b.pod(f"wb{i}", cpu="2", gang="g-lose", min_avail=3)
    assert b.run() == 0
    for i in range(3):
        b.delete(f"wa{i}")
    b.advance(1.1)
    assert b.run() == 3


def test_surplus_beyond_min_member_parks():
    b = Both(2, cpu="2")
    for i in range(3):
        b.pod(f"s{i}", cpu="2", gang="gs", min_avail=2)
    assert b.run() == 2
    assert b.bound("gs") == 2


def test_wave_boundary_never_splits_a_gang():
    b = Both(8, wave=4, cpu="4")
    for i in range(6):
        b.pod(f"w{i}", cpu="1", gang="gw", min_avail=6)
    b.pod("filler", cpu="1")
    assert b.run() == 7
    assert b.bound("gw") == 6


def test_high_priority_gang_evicts_whole_victim_gang():
    b = Both(3, cpu="2")
    for i in range(3):
        b.pod(f"low{i}", cpu="2", priority=1, gang="g-low", min_avail=3)
    assert b.run() == 3
    for i in range(3):
        b.pod(f"high{i}", cpu="2", priority=100, gang="g-high", min_avail=3)
    b.run()
    assert b.bound("g-low") == 0  # never a sub-minMember remnant
    for _ in range(4):
        b.advance(2.0)
        b.run()
    assert b.bound("g-high") == 3


def test_single_pod_preemptor_spares_gang_without_slack():
    b = Both(2, cpu="2")
    b.pod("gm0", cpu="2", priority=1, gang="g-guard")
    b.group("g-guard", 1)
    b.pod("plain", cpu="2", priority=1)
    assert b.run() == 2
    b.pod("vip", cpu="2", priority=100)
    b.run()
    b.advance(2.0)
    b.run()
    store = b.stores["torch"]
    assert store.get("pods", "default", "vip").spec.node_name
    assert store.get("pods", "default", "plain") is None
    assert store.get("pods", "default", "gm0") is not None
