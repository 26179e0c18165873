"""The wave and the round of kubernetes_tpu_torch (ops/kernel.py) against
the JAX package's schedule_wave / schedule_round, on the same numpy
inputs. Every output plane is compared bit-equal: chosen, score,
feasible_count, fail_counts, masks, rr_end, finite and the usage carry.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernel as jk
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import kernel as tk
from kubernetes_tpu_torch.sched import scheduler as tsched

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import (LIVE_VECTOR, RICH_WEIGHTS, WAVE_PLANES,
                          compare_rounds, eq, round_inputs)
from torch_worlds import op_world


@pytest.mark.parametrize("weights", ["default", "vector"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_schedule_wave(seed, weights):
    snap, pb, _ = op_world("kubernetes_tpu", seed, n_pending=14)
    nt, pm, tt = snap.host_tensors()
    P, N = pb.req.shape[0], nt.valid.shape[0]
    # host-plugin mask rows and pre-weighted extra scores ride along
    rng = np.random.RandomState(seed)
    extra_mask = rng.rand(P, N) < 0.95
    extra_scores = rng.randint(0, 3, size=(P, N)).astype(np.float32)
    if weights == "default":
        kw_j = dict(weights=jk.Weights())
        kw_t = dict(weights=tk.Weights())
    else:
        kw_j = dict(weights=jk.Weights(**RICH_WEIGHTS),
                    weight_vec=LIVE_VECTOR)
        kw_t = dict(weights=tk.Weights(**RICH_WEIGHTS),
                    weight_vec=tenc.weight_vec_to_torch(LIVE_VECTOR, "cpu"))
    zl = dict(num_zones=snap.caps.Z, num_label_values=snap.num_label_values)
    want = jk.schedule_wave(nt, pm, tt, pb, extra_mask, np.int32(seed),
                            extra_scores, **kw_j, **zl)
    ntt, pmt, ttt, pbt = tenc.to_torch(nt, pm, tt, pb, "cpu")
    got = tk.schedule_wave(ntt, pmt, ttt, pbt, torch.from_numpy(extra_mask),
                           torch.tensor(seed, dtype=torch.int32),
                           torch.from_numpy(extra_scores), **kw_t, **zl)
    for name in WAVE_PLANES:
        eq(getattr(want, name), getattr(got, name), name)
    assert got.deco is None
    chosen = got.chosen.numpy()
    assert (chosen[:14] >= 0).any() and (chosen[14:] == -1).all()


def _compare_rounds(seed, wave_sizes, weights):
    """The JAX round and the port's round on the same op_world inputs:
    every output bit-equal. Returns the stacked pod batch."""
    snap, inputs = round_inputs(seed, wave_sizes, world=op_world, caps=None)
    pbs = inputs[3]
    assert pbs.req.shape[0] > len(wave_sizes)  # the bucket pads
    chosen = compare_rounds(
        snap, inputs, vector=weights == "vector",
        gating=None if weights == "default" else RICH_WEIGHTS)
    assert (chosen[len(wave_sizes):] == -1).all()
    return pbs


@pytest.mark.parametrize("seed,wave_sizes,weights", [
    (0, (8, 8, 5), "default"), (1, (9, 3), "vector"),
    (2, (8, 8, 8, 8, 2), "default"), (3, (8, 8, 8, 8, 2), "vector")])
def test_schedule_round(seed, wave_sizes, weights):
    _compare_rounds(seed, wave_sizes, weights)


@pytest.mark.parametrize("seed,wave_sizes", [(4, (8, 8, 5)),
                                             (5, (8, 8, 8, 8, 2))])
def test_round_launches_the_kernel_on_live_waves_only(seed, wave_sizes,
                                                       monkeypatch):
    """The trailing pad waves of the bucket get no taint/port rows: the
    one launch covers the live waves' rows, and the round's outputs
    still equal the JAX round's."""
    launched = []
    launch = tk.taint_ports_masks

    def counting(nt, pb, **kw):
        launched.append(pb.tol_key.shape[0])
        return launch(nt, pb, **kw)

    monkeypatch.setattr(tk, "taint_ports_masks", counting)
    pbs = _compare_rounds(seed, wave_sizes, "default")
    W, P = pbs.req.shape[:2]
    live = int(np.asarray(pbs.valid).any(axis=1).sum())
    assert live == len(wave_sizes) < W
    assert launched == [live * P]


def test_stage_placements_drops_pad_entries():
    """Pad and unplaced entries scatter nowhere (the JAX mode="drop");
    placed ones flip their pod-matrix and term rows."""
    snap, _, _ = op_world("kubernetes_tpu", 0, n_pending=4)
    pm, tt = tenc.to_torch(None, snap.pod_matrix(), snap.term_table(), None,
                           "cpu")[1:3]
    chosen = torch.tensor([3, -1, 5, 2], dtype=torch.int32)
    rows = torch.tensor([10, 11, -1, 12], dtype=torch.int32)
    trows = torch.tensor([[1, -1], [2, 3], [4, -1], [-1, -1]],
                         dtype=torch.int32)
    pm2, tt2 = tk._stage_placements(pm, tt, chosen, rows, trows)
    node, valid = pm2.node.clone(), pm2.valid.clone()
    assert node[10] == 3 and node[12] == 2 and bool(valid[10] & valid[12])
    untouched = torch.ones_like(valid)
    untouched[[10, 12]] = False
    assert torch.equal(node[untouched], pm.node[untouched])
    assert torch.equal(valid[untouched], pm.valid[untouched])
    assert tt2.node[1] == 3 and bool(tt2.valid[1])
    assert torch.equal(tt2.node[2:5], tt.node[2:5])
    assert pm2.node.shape == pm.node.shape


@pytest.mark.parametrize("flag", ["collect_scores"])
def test_later_slice_flags_raise(flag):
    """collect_scores, which raised NotImplementedError until the score
    decomposition was ported, now raises nothing: on the op_world round
    and its first wave it returns the ScoreDeco planes the JAX package
    returns, bit-equal (tests/test_torch_deco.py covers the worlds)."""
    snap, (nt, pm, tt, pbs, rows, trows) = round_inputs(
        0, (4,), world=op_world, caps=None)
    ntt, pmt, ttt, pbst = tenc.to_torch(nt, pm, tt, pbs, "cpu")
    zl = dict(num_zones=snap.caps.Z, num_label_values=snap.num_label_values)
    got = tk.schedule_round(ntt, pmt, ttt, pbst,
                            (ntt.requested, ntt.nonzero, ntt.pod_count),
                            torch.tensor(0, dtype=torch.int32),
                            torch.from_numpy(rows), torch.from_numpy(trows),
                            weights=tk.Weights(), **{flag: True}, **zl)
    want = jk.schedule_round(nt, pm, tt, pbs,
                             (nt.requested, nt.nonzero, nt.pod_count),
                             np.int32(0), rows, trows, weights=jk.Weights(),
                             **{flag: True}, **zl)
    for name, a, b in zip(want[4]._fields, want[4], got[4]):
        eq(a, b, f"round {name}")
    pb0 = tenc.PodBatch(*[a[0] for a in pbst])
    P, N = pb0.req.shape[0], ntt.valid.shape[0]
    wave = tk.schedule_wave(ntt, pmt, ttt, pb0,
                            torch.ones((P, N), dtype=torch.bool),
                            torch.tensor(0, dtype=torch.int32),
                            weights=tk.Weights(), **{flag: True}, **zl)
    for name, a, b in zip(want[4]._fields, want[4], wave.deco):
        eq(np.asarray(a)[0], b, f"wave {name}")


def test_round_helpers_match_the_reference():
    from kubernetes_tpu.sched import scheduler as jsched

    assert tsched.PIPELINE_MAX_WAVES == jsched.PIPELINE_MAX_WAVES
    for n in (1, 3, 4, 5, 17, 64, 100, 128, 500):
        assert tsched.pipeline_bucket(n) == jsched.pipeline_bucket(n)
