"""The scheduling wave and round.

A wave schedules a wavefront of pending pods:

  1. static predicate masks + raw priority scores, batched [P, N]
     (replaces hot loops generic_scheduler.go:378 findNodesThatFit and
     :609 PrioritizeNodes across BOTH axes at once);
  2. a loop over the wave that, per pod: re-applies resource fit
     against live usage, runs the normalizing reduces over the pod's
     feasible set, weighted-sums, and commits the argmax into the
     carried usage tensors — so later pods in the wave see earlier
     placements exactly like the reference's assume step
     (scheduler.go:486) makes assumed pods visible to the next cycle;
  3. host-name round-robin tie-break emulating selectHost
     (generic_scheduler.go:178) with a carried counter.

A round chains W waves on the device and stages each wave's placements
into the pod matrix / term table before the next wave runs; the caller
fetches `chosen` once per round. Nothing here reads a device value on
the host inside a wave or between waves: the per-pod loop is a sequence
of queued tensor ops.

Failure attribution follows the reference's short-circuit predicate
ordering (generic_scheduler.go:503 breaks at the first failed predicate;
predicates.go:133 predicatesOrdering): a node is charged only to its
first failing predicate.

This slice runs the round without inter-pod affinity (`has_ipa`),
topology spread (`has_ts`) and the score decomposition
(`collect_scores`); each raises NotImplementedError until its slice
lands. Every op follows the JAX kernel's f32 op order (see ops/scores.py)
so the outputs are bit-equal to it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import encoding as enc
from .filters import resource_fit, static_predicate_masks
from .scores import (
    W_AFFINITY,
    W_AVOID,
    W_BALANCED,
    W_COMPACT,
    W_IMAGE,
    W_LEAST,
    W_MOST,
    W_SPREAD,
    W_TAINT,
    balanced_allocation,
    image_locality,
    least_requested,
    most_requested,
    node_affinity_raw,
    normalize_reduce,
    prefer_avoid,
    spread_counts,
    spread_reduce,
    stack_weights,
    taint_intolerable_raw,
)
from .taint_ports import taint_ports_masks


class Weights(NamedTuple):
    """Priority weights (reference defaults:
    algorithmprovider/defaults/defaults.go:219 — weight 1 each, except
    NodePreferAvoidPods at 10000; ImageLocality/MostRequested optional)."""

    least_requested: float = 1.0
    balanced: float = 1.0
    most_requested: float = 0.0
    node_affinity: float = 1.0
    taint_toleration: float = 1.0
    selector_spread: float = 1.0
    prefer_avoid: float = 10000.0
    image_locality: float = 0.0
    interpod: float = 1.0
    # PodTopologySpread skew score + gang rack/superpod compactness &
    # accel-gen steering
    topology_spread: float = 1.0
    topology_compactness: float = 1.0
    # HardPodAffinitySymmetricWeight (componentconfig default 1,
    # pkg/apis/componentconfig/types.go)
    hard_pod_affinity: float = 1.0


class WaveResult(NamedTuple):
    chosen: torch.Tensor  # i32 [P]  node index or -1
    score: torch.Tensor  # f32 [P]  winning weighted score (-1 if none)
    feasible_count: torch.Tensor  # i32 [P]
    fail_counts: torch.Tensor  # i32 [Q, P]  first-fail per predicate
    masks: torch.Tensor  # bool [Q, P, N]  per-predicate pass masks
    rr_end: torch.Tensor  # i32  round-robin counter after the wave
    # score decomposition: collect_scores is a later slice, always None
    deco: Optional[tuple] = None
    # numeric-integrity sentinel: bool [P] — False where the pod's own
    # inputs (req/nonzero) or its winning score are non-finite (a NaN
    # req poisons the usage carry for every later pod in the wave)
    finite: Optional[torch.Tensor] = None


def _not_in_slice(has_ipa: bool, has_ts: bool, collect_scores: bool) -> None:
    if has_ipa:
        raise NotImplementedError(
            "has_ipa: inter-pod affinity (kubernetes_tpu/ops/affinity.py) "
            "is a later slice of the port")
    if has_ts:
        raise NotImplementedError(
            "has_ts: topology spread (kubernetes_tpu/ops/topology.py) is a "
            "later slice of the port")
    if collect_scores:
        raise NotImplementedError(
            "collect_scores: the score decomposition is a later slice of "
            "the port")


def _wave_body(nt: enc.NodeTensors, pm: enc.PodMatrix, tt: enc.TermTable,
               pb: enc.PodBatch, extra_mask, rr_start, extra_scores,
               weights: Weights, num_zones: int, num_label_values: int,
               has_ipa: bool = False, usage_in=None, taint_ports=None,
               collect_scores: bool = False, weight_vec=None,
               has_ts: bool = False):
    """Shared wave computation. usage_in: optional (requested, nonzero,
    pod_count) overriding nt's usage columns — the device-resident carry
    that lets consecutive waves chain without a host roundtrip (never
    written in place). taint_ports: precomputed (taints_ok, ports_ok)
    [P, N] from the round's single kernel launch. Returns
    (WaveResult, usage_out).

    weight_vec: optional f32 [S] SCORE_STACK-aligned weight vector on the
    device; it supplies the multipliers of the weighted sum. The static
    `weights` gates which score planes are computed. None uses
    stack_weights(weights)."""
    _not_in_slice(has_ipa, has_ts, collect_scores)
    dev = nt.valid.device
    N = nt.valid.shape[0]
    P = pb.req.shape[0]
    R = nt.alloc.shape[1]
    is_core = torch.arange(R, device=dev) < enc.RES_FIXED
    masks = static_predicate_masks(nt, pb, is_core, taint_ports)
    # placeholder rows for the scan-filled predicates (PodTopologySpread,
    # MatchInterPodAffinity), in DEVICE_PREDICATES order
    placeholder = torch.ones((1, P, N), dtype=torch.bool, device=dev)
    masks = torch.cat([masks, placeholder, placeholder, extra_mask[None]],
                      dim=0)
    res_i = enc.PRED_IDX["PodFitsResources"]
    static_nonres = torch.cat([masks[:res_i], masks[res_i + 1:]]).all(dim=0)
    alloc2 = nt.alloc[:, :2]

    w = weights
    wv = (weight_vec if weight_vec is not None
          else torch.from_numpy(stack_weights(w)).to(dev))
    aff_raw = (node_affinity_raw(nt, pb) if w.node_affinity
               else torch.zeros((P, N), dtype=torch.float32, device=dev))
    taint_raw = (taint_intolerable_raw(nt, pb) if w.taint_toleration
                 else torch.zeros((P, N), dtype=torch.float32, device=dev))
    spread_cnt = (spread_counts(pm, pb, N) if w.selector_spread
                  else torch.zeros((P, N), dtype=torch.int32, device=dev))
    static_score = torch.zeros((P, N), dtype=torch.float32, device=dev)
    if w.image_locality:
        static_score = static_score + wv[W_IMAGE] * image_locality(nt, pb)
    if w.prefer_avoid:
        static_score = static_score + wv[W_AVOID] * prefer_avoid(nt, pb)
    if extra_scores is not None:
        static_score = static_score + extra_scores

    usage0 = usage_in if usage_in is not None else (
        nt.requested, nt.nonzero, nt.pod_count)
    # the carry is updated in place below: never write into the caller's
    # (or the snapshot cache's) tensors
    req_c, nz_c, cnt_c = (u.clone() for u in usage0)
    # wave-start pod counts: the compactness plane measures co-location
    # against placements made THIS wave
    pod_count0 = usage0[2]
    rr = torch.as_tensor(rr_start, dtype=torch.int32, device=dev).clone()
    rack = nt.rack_id.long()
    superpod = nt.superpod_id.long()

    chosen_l, best_l, fits_l, feas_l = [], [], [], []
    for i in range(P):
        preq, pnz = pb.req[i], pb.nonzero[i]
        fits = resource_fit(nt.alloc, nt.allowed_pods, req_c, cnt_c,
                            preq[None, :], is_core)[0]  # [N]
        feasible = static_nonres[i] & fits & nt.valid & pb.valid[i]
        # the weighted sum, plane by plane in the JAX kernel's order
        # (kernel.py:504-576); each `total + wv * plane` is two ops
        total = static_score[i]
        if w.node_affinity:
            aff_n = normalize_reduce(aff_raw[i], feasible, False)
            total = total + wv[W_AFFINITY] * aff_n
        if w.taint_toleration:
            taint_n = normalize_reduce(taint_raw[i], feasible, True)
            total = total + wv[W_TAINT] * taint_n
        if w.selector_spread:
            spread_n = spread_reduce(spread_cnt[i], feasible, nt.zone_id,
                                     num_zones)
            total = total + wv[W_SPREAD] * spread_n
        if w.least_requested:
            total = total + wv[W_LEAST] * least_requested(nz_c, alloc2, pnz)
        if w.balanced:
            total = total + wv[W_BALANCED] * balanced_allocation(
                nz_c, alloc2, pnz)
        if w.most_requested:
            total = total + wv[W_MOST] * most_requested(nz_c, alloc2, pnz)
        if w.topology_compactness:
            # count this wave's placements per rack/superpod (ids intern
            # into the shared zone vocabulary, so num_zones bounds both
            # segment sums). The sums add integer counts: the atomic order
            # of index_add_ on CUDA cannot change them.
            wave_placed = (cnt_c - pod_count0).to(torch.float32)
            rsum = torch.zeros((num_zones,), dtype=torch.float32, device=dev)
            rsum.index_add_(0, rack, wave_placed)
            rackc = rsum[rack] * (nt.rack_id > 0)
            ssum = torch.zeros((num_zones,), dtype=torch.float32, device=dev)
            ssum.index_add_(0, superpod, wave_placed)
            spc = ssum[superpod] * (nt.superpod_id > 0)
            gen = nt.accel_gen.to(torch.float32) * (pb.prio[i] > 0)
            compact_raw = 3.0 * rackc + spc + gen
            compact_n = normalize_reduce(compact_raw, feasible, False)
            total = total + wv[W_COMPACT] * compact_n
        sm = torch.where(feasible, total, -1.0)
        best = sm.max()  # NaN propagates, as jnp.max does
        has = best >= 0
        ties = feasible & (sm == best)
        k = ties.sum(dtype=torch.int32).clamp(min=1)
        rank = torch.cumsum(ties.to(torch.int32), 0, dtype=torch.int32) - 1
        # first index whose tie rank is rr % k; argmax over int32 (not
        # bool) returns the first maximal index
        pick = (ties & (rank == rr % k)).to(torch.int32)
        chosen = torch.where(has, pick.argmax().to(torch.int32), -1)
        safe = chosen.clamp(min=0).long().reshape(1)
        gain = torch.where(has, 1.0, 0.0)
        req_c.index_add_(0, safe, (preq * gain)[None, :])
        nz_c.index_add_(0, safe, (pnz * gain)[None, :])
        cnt_c.index_add_(0, safe, has.to(torch.int32).reshape(1))
        rr = rr + has.to(torch.int32)
        chosen_l.append(chosen)
        best_l.append(best)
        fits_l.append(fits)
        feas_l.append(feasible.sum(dtype=torch.int32))

    chosen = torch.stack(chosen_l)
    best = torch.stack(best_l)
    masks[res_i] = torch.stack(fits_l)
    # short-circuit first-fail attribution in predicate order
    prefix_ok = torch.cumprod(masks.to(torch.int8), 0,
                              dtype=torch.int8).to(torch.bool)
    first = torch.cat([torch.ones_like(masks[:1]), prefix_ok[:-1]], dim=0)
    first_fail = ~masks & first & nt.valid[None, None, :]
    fail_counts = first_fail.sum(dim=-1, dtype=torch.int32)  # [Q, P]
    # numeric-integrity sentinel: the pod's own inputs plus its winning
    # score (a NaN in extra_scores surfaces through the max's NaN
    # propagation in `best`). Pad rows are zero inputs, best == -1.
    finite = (torch.isfinite(pb.req).all(dim=1)
              & torch.isfinite(pb.nonzero).all(dim=1)
              & torch.isfinite(best))
    res = WaveResult(chosen=chosen, score=best,
                     feasible_count=torch.stack(feas_l),
                     fail_counts=fail_counts, masks=masks, rr_end=rr,
                     deco=None, finite=finite)
    return res, (req_c, nz_c, cnt_c)


def schedule_wave(nt: enc.NodeTensors, pm: enc.PodMatrix, tt: enc.TermTable,
                  pb: enc.PodBatch, extra_mask, rr_start, extra_scores=None,
                  *, weights: Weights, num_zones: int,
                  num_label_values: int = 64, has_ipa: bool = False,
                  has_ts: Optional[bool] = None,
                  collect_scores: bool = False,
                  weight_vec=None) -> WaveResult:
    """One wave. extra_mask: bool [P, N] — host-evaluated predicates,
    appended to the mask stack as a final "HostPlugins" pseudo-predicate.
    extra_scores: optional f32 [P, N] — host-evaluated score
    contributions, pre-multiplied by their weights.

    has_ts defaults to whether any pod carries a topology spread
    constraint, as the JAX entry point derives it."""
    if has_ts is None:
        has_ts = bool(pb.ts_valid.any())
    res, _ = _wave_body(nt, pm, tt, pb, extra_mask, rr_start, extra_scores,
                        weights, num_zones, num_label_values, has_ipa,
                        collect_scores=collect_scores,
                        weight_vec=weight_vec, has_ts=has_ts)
    return res


def _stage_placements(pm: enc.PodMatrix, tt: enc.TermTable, chosen,
                      pm_rows, term_rows):
    """Flip this wave's placements into the pod matrix / term table ON
    DEVICE so the next chained wave sees them (spreading counts read pm;
    required (anti)affinity reads tt). Returns new tuples; the inputs are
    not written.

    Pad/unplaced entries go to one extra dump row past the end that is
    cut off afterwards — the JAX kernel's scatter mode="drop". Clipping
    them to row 0 instead would race real updates to row 0, and torch
    indexing raises on an out-of-range index."""
    ok = (chosen >= 0) & (pm_rows >= 0)
    safe_choice = chosen.clamp(min=0)
    M = pm.node.shape[0]
    target = torch.where(ok, pm_rows, M).long()
    node = torch.cat([pm.node, pm.node.new_zeros(1)])
    node[target] = safe_choice
    valid = torch.cat([pm.valid, pm.valid.new_zeros(1)])
    valid[target] = True
    pm2 = pm._replace(node=node[:M], valid=valid[:M])
    TPP = term_rows.shape[1]
    E = tt.node.shape[0]
    tok = ok[:, None] & (term_rows >= 0)
    ttarget = torch.where(tok, term_rows, E).reshape(-1).long()
    tchoice = safe_choice.repeat_interleave(TPP)
    tnode = torch.cat([tt.node, tt.node.new_zeros(1)])
    tnode[ttarget] = tchoice
    tvalid = torch.cat([tt.valid, tt.valid.new_zeros(1)])
    tvalid[ttarget] = True
    tt2 = tt._replace(node=tnode[:E], valid=tvalid[:E])
    return pm2, tt2


def _flat_taint_ports(nt: enc.NodeTensors, pbs: enc.PodBatch, W: int):
    """One taint/port kernel launch over the pod rows of the first W
    waves: [W*P] flattened rows in, (taints, ports) bool [W, P, N] out.
    At full width the two outputs are 2 * W*P * N bytes — 128 waves of
    128 pods against an 8192-node bucket is 268 MB — so the round does
    not chunk them."""
    P = pbs.req.shape[1]
    N = nt.valid.shape[0]

    def flat(a):
        return a[:W].reshape(W * P, -1)

    flat_pb = pbs._replace(
        req=flat(pbs.req), tol_key=flat(pbs.tol_key),
        tol_val=flat(pbs.tol_val), tol_op=flat(pbs.tol_op),
        tol_effect=flat(pbs.tol_effect), ports=flat(pbs.ports))
    taints, ports = taint_ports_masks(nt, flat_pb)
    return taints.reshape(W, P, N), ports.reshape(W, P, N)


def schedule_round(nt: enc.NodeTensors, pm: enc.PodMatrix,
                   tt: enc.TermTable, pbs: enc.PodBatch, usage, rr_start,
                   pm_rows, term_rows, *, weights: Weights, num_zones: int,
                   num_label_values: int = 64, has_ipa: bool = False,
                   has_ts: Optional[bool] = None,
                   collect_scores: bool = False, weight_vec=None):
    """An ENTIRE scheduling round: W waves, each a full _wave_body pass
    whose placements are staged into the pod matrix / term table before
    the next wave runs.

    pbs: a PodBatch whose fields are stacked [W, ...] (padded waves have
    valid=False rows and schedule nothing). pm_rows [W, P] / term_rows
    [W, P, TPP]: pre-staged row ids (-1 pads).

    The taint/port masks of every live wave come from one kernel launch
    before the wave loop (the JAX round hoists its Pallas call the same
    way). Which waves are live is read on the host once, from the
    stacked inputs, before any wave is queued; pad waves (the bucket's
    trailing ones) skip the wave body, and the launch covers the waves
    up to the last live one only, since no pad wave reads its masks.

    Returns (chosen [W, P], fail_counts [W, Q, P], usage', rr_end, deco,
    finite [W, P]); deco is None (collect_scores is a later slice)."""
    if has_ts is None:
        has_ts = bool(pbs.ts_valid.any())
    _not_in_slice(has_ipa, has_ts, collect_scores)
    dev = nt.valid.device
    W = pbs.req.shape[0]
    P = pbs.req.shape[1]
    N = nt.valid.shape[0]
    Q = len(enc.MASK_STACK_NAMES)
    ones = torch.ones((P, N), dtype=torch.bool, device=dev)
    active = pbs.valid.any(dim=1).tolist()
    n_live = max((wi + 1 for wi, a in enumerate(active) if a), default=0)
    if n_live:
        taints_all, ports_all = _flat_taint_ports(nt, pbs, n_live)

    pm_c, tt_c = pm, tt
    usage_c = tuple(usage)
    rr_c = torch.as_tensor(rr_start, dtype=torch.int32, device=dev)
    chosen_w, fail_w, finite_w = [], [], []
    for wi in range(W):
        if not active[wi]:
            chosen_w.append(torch.full((P,), -1, dtype=torch.int32,
                                       device=dev))
            fail_w.append(torch.zeros((Q, P), dtype=torch.int32, device=dev))
            # pad waves schedule nothing: their sentinel rows are clean
            finite_w.append(torch.ones((P,), dtype=torch.bool, device=dev))
            continue
        pb = enc.PodBatch(*[a[wi] for a in pbs])
        res, usage_c = _wave_body(
            nt, pm_c, tt_c, pb, ones, rr_c, None, weights, num_zones,
            num_label_values, usage_in=usage_c,
            taint_ports=(taints_all[wi], ports_all[wi]),
            weight_vec=weight_vec)
        pm_c, tt_c = _stage_placements(pm_c, tt_c, res.chosen, pm_rows[wi],
                                       term_rows[wi])
        rr_c = res.rr_end
        chosen_w.append(res.chosen)
        fail_w.append(res.fail_counts)
        finite_w.append(res.finite)
    return (torch.stack(chosen_w), torch.stack(fail_w), usage_c, rr_c, None,
            torch.stack(finite_w))
