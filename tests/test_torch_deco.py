"""The score decomposition of kubernetes_tpu_torch (ops/kernel.py
`collect_scores`, ops/scores.py `ScoreDeco`) against the JAX package's,
on the same numpy inputs, with no tolerance: the chosen node's raw
parts, the top-k node indices, their totals and their parts, of
`schedule_wave` ([P, ...]) and `schedule_round` ([W, P, ...], pad waves
included), f32 planes compared bit for bit.

Worlds: three seeds of `ipa_world` with inter-pod affinity on and off
(their pods carry spread constraints, so has_ts is on), pre-weighted
extra scores under a live vector, a profile whose every weight is 0, a
pod with a NaN request, and a world of identical nodes where most nodes
tie. With collect_scores on and off the port's chosen, rr_end and finite
are identical. The top-k order is lax.top_k's: IEEE total order, the
lower index first on ties.
"""

import numpy as np
import pytest
import torch
from jax import lax

from kubernetes_tpu.ops import kernel as jk
from kubernetes_tpu.ops.scores import SCORE_STACK as J_STACK
from kubernetes_tpu.ops.scores import SCORE_TOPK as J_TOPK
from kubernetes_tpu.ops.scores import WEIGHT_FIELDS as J_FIELDS
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import kernel as tk
from kubernetes_tpu_torch.ops import scores as tscores

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import (LIVE_VECTOR, RICH_WEIGHTS, eq, parity_world,
                          round_inputs)

ZERO_WEIGHTS = {f: 0.0 for f in jk.Weights._fields
                if f != "hard_pod_affinity"}


def bits_eq(want, got, name):
    """eq, and the f32 planes equal as bit patterns (NaN payloads and the
    sign of zero included)."""
    eq(want, got, name)
    a, b = np.asarray(want), got.numpy()
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)


def _world(seed, variant):
    """(snapshot, numpy wave inputs, gating keywords, vector or None,
    extra_scores or None)."""
    snap, (nt, pm, tt, pb), _ = parity_world(seed)
    P, N = pb.req.shape[0], nt.valid.shape[0]
    rng = np.random.RandomState(100 + seed)
    gating, vec, extra = {}, None, None
    if variant == "extra":
        gating, vec = RICH_WEIGHTS, LIVE_VECTOR
        extra = rng.randint(0, 4, size=(P, N)).astype(np.float32)
    elif variant == "zero":
        gating = ZERO_WEIGHTS
    elif variant == "nan":
        pb = pb._replace(req=pb.req.copy())
        pb.req[3, 0] = np.nan
    elif variant == "ties":
        # every node the same: one allocatable row, nothing requested
        nt = nt._replace(
            alloc=np.repeat(nt.alloc[:1], N, axis=0),
            requested=np.zeros_like(nt.requested),
            nonzero=np.zeros_like(nt.nonzero),
            pod_count=np.zeros_like(nt.pod_count))
    return snap, (nt, pm, tt, pb), gating, vec, extra


def _both_waves(snap, inputs, gating, vec, extra, has_ipa, rr=3):
    nt, pm, tt, pb = inputs
    P, N = pb.req.shape[0], nt.valid.shape[0]
    mask = np.ones((P, N), bool)
    zl = dict(num_zones=snap.caps.Z, num_label_values=snap.num_label_values,
              has_ipa=has_ipa)
    want = jk.schedule_wave(nt, pm, tt, pb, mask, np.int32(rr), extra,
                            weights=jk.Weights(**gating), weight_vec=vec,
                            collect_scores=True, **zl)
    ntt, pmt, ttt, pbt = tenc.to_torch(nt, pm, tt, pb, "cpu")
    tkw = dict(weights=tk.Weights(**gating),
               weight_vec=(None if vec is None
                           else tenc.weight_vec_to_torch(vec, "cpu")), **zl)
    args = (ntt, pmt, ttt, pbt, torch.from_numpy(mask),
            torch.tensor(rr, dtype=torch.int32),
            None if extra is None else torch.from_numpy(extra))
    got = tk.schedule_wave(*args, collect_scores=True, **tkw)
    off = tk.schedule_wave(*args, **tkw)
    return want, got, off


@pytest.mark.parametrize("variant", ["ipa", "plain", "extra", "zero", "nan",
                                     "ties"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wave_deco_equals_jax(seed, variant):
    snap, inputs, gating, vec, extra = _world(seed, variant)
    want, got, off = _both_waves(snap, inputs, gating, vec, extra,
                                 has_ipa=variant != "plain")
    for name in ("chosen", "score", "feasible_count", "fail_counts",
                 "rr_end", "finite"):
        bits_eq(getattr(want, name), getattr(got, name), name)
        # the decomposition changes no placement
        eq(getattr(want, name), getattr(off, name), f"{name} (off)")
    assert off.deco is None
    for name, a, b in zip(want.deco._fields, want.deco, got.deco):
        bits_eq(a, b, name)
    P = inputs[3].req.shape[0]
    S, K = len(tscores.SCORE_STACK), min(tscores.SCORE_TOPK,
                                         inputs[0].valid.shape[0])
    assert got.deco.chosen_parts.shape == (P, S)
    assert got.deco.top_parts.shape == (P, S, K)
    if variant == "nan":
        assert not got.finite.numpy()[3]
    if variant == "ties":
        top = got.deco.top_vals.numpy()
        assert (top[:, 0] == top[:, 1]).any()


@pytest.mark.parametrize("has_ipa", [True, False])
@pytest.mark.parametrize("seed,wave_sizes", [(0, (16, 16, 9)),
                                             (1, (16, 5)), (2, (16, 16, 16))])
def test_round_deco_equals_jax(seed, wave_sizes, has_ipa):
    """The round's [W, P, ...] planes, the bucket's pad waves with zero
    parts and top_vals of -1, under a live vector; collect_scores on and
    off place identically."""
    snap, (nt, pm, tt, pbs, rows, trows) = round_inputs(seed, wave_sizes)
    zl = dict(num_zones=snap.caps.Z, num_label_values=snap.num_label_values,
              has_ipa=has_ipa)
    want = jk.schedule_round(nt, pm, tt, pbs,
                             (nt.requested, nt.nonzero, nt.pod_count),
                             np.int32(3), rows, trows, weights=jk.Weights(),
                             weight_vec=LIVE_VECTOR, collect_scores=True,
                             **zl)
    ntt, pmt, ttt, pbst = tenc.to_torch(nt, pm, tt, pbs, "cpu")

    def port(collect):
        return tk.schedule_round(
            ntt, pmt, ttt, pbst, (ntt.requested, ntt.nonzero, ntt.pod_count),
            torch.tensor(3, dtype=torch.int32), torch.from_numpy(rows),
            torch.from_numpy(trows), weights=tk.Weights(),
            weight_vec=tenc.weight_vec_to_torch(LIVE_VECTOR, "cpu"),
            collect_scores=collect, **zl)

    got, off = port(True), port(False)
    for i, name in ((0, "chosen"), (1, "fail_counts"), (3, "rr_end"),
                    (5, "finite")):
        bits_eq(want[i], got[i], name)
        eq(want[i], off[i], f"{name} (off)")
    assert off[4] is None
    for name, a, b in zip(want[4]._fields, want[4], got[4]):
        bits_eq(a, b, name)
    W = pbs.req.shape[0]
    assert W > len(wave_sizes)  # the bucket pads
    pad = got[4].top_vals.numpy()[len(wave_sizes):]
    assert (pad == -1.0).all()


def _lax_top_k(x, k):
    vals, idx = lax.top_k(np.asarray(x, np.float32), k)
    return np.asarray(vals), np.asarray(idx)


@pytest.mark.parametrize("values,k", [
    ([1, 5, np.nan, 5, -1, 5, np.inf], 4),
    ([0.0, -0.0, -np.float32("nan"), 1.0, -np.inf, np.nan, -0.0, 0.0], 8),
    ([-1.0] * 9, 4),
    ([3.0, -1.0, 3.0, 3.0, -1.0, 3.0], 4)])
def test_top_k_order_matches_lax(values, k):
    """top_k_first gives lax.top_k's order: [1, 5, nan, 5, -1, 5, inf]
    -> [2, 6, 1, 3] (torch.topk would give [2, 6, 3, 5]); -NaN ranks
    below -inf and -0.0 below +0.0, ties go to the lower index."""
    x = np.asarray(values, np.float32)
    want_v, want_i = _lax_top_k(x, k)
    got_v, got_i = tk.top_k_first(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  want_v.view(np.int32))
    if len(values) == 7:
        assert got_i.numpy().tolist() == [2, 6, 1, 3]
        assert torch.topk(torch.from_numpy(x), k).indices.tolist() != [
            2, 6, 1, 3]


def test_score_stack_contract_matches_jax():
    """SCORE_STACK, SCORE_TOPK and WEIGHT_FIELDS are the JAX package's."""
    assert tscores.SCORE_STACK == J_STACK
    assert tscores.SCORE_TOPK == J_TOPK
    assert tscores.WEIGHT_FIELDS == J_FIELDS
    assert tscores.ScoreDeco._fields == (
        "chosen_parts", "top_idx", "top_vals", "top_parts")
