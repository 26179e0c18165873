"""Vectorized numpy host twin of the device wave, gang and what-if.

A copy of kubernetes_tpu/ops/hostwave.py (imports rewritten): the rung
the port's scheduler drains through while its device-path breaker is
open (sched/breaker.py), the input-fault attribution replay, and the
autoscaler's what-if backend="host" (ops/simulate.py). The device
kernels are re-stated as dense numpy ops over the SAME Snapshot feature
planes (state/snapshot.py host_tensors — no upload, no device touch: a
tripped or wedged card is never dispatched to), with the same mask
stack, score formulas, f32 arithmetic and commit-scan semantics. The
JAX package holds its kernels to this twin bit for bit on the CPU, and
the port's wave and gang are bit-equal to the JAX kernels on the CPU
and to themselves on the card, so twin == card holds too
(tests/test_torch_hostwave.py on the CPU; chip_smoke.py phase 17 on the
card).

Twinned programs:

  schedule_wave_host       ops/kernel.py _wave_body (filters + scores +
                           sequential greedy commit with usage carry),
                           including the inter-pod affinity plane
                           (incoming_statics_host twins ops/affinity.py
                           incoming_statics) and topology spread
                           (topo_statics_host)
  schedule_gang_host       ops/gang.py all-or-nothing count feasibility
  preemption_stats_host    ops/preempt.py batched what-if stat planes
                           (with victim_levels, the level list)
  cluster_telemetry_host   ops/telemetry.py cluster_telemetry

Still NOT twinned: multi-topology-key required affinity — the same
single-anchor encoding limit as the device path (needs_host_path); such
pods take the exact golden path on BOTH backends.

dtype discipline: every float op stays in float32 in the device order of
operations. Segment sums accumulate in f64 (np.bincount) and round once
to f32 — identical for the integer-valued counts and priorities these
planes carry.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import encoding as enc
from .kernel import Weights, WaveResult
from .scores import (SCORE_STACK, SCORE_TOPK, W_AFFINITY, W_AVOID,
                     W_BALANCED, W_COMPACT, W_IMAGE, W_INTERPOD, W_LEAST,
                     W_MOST, W_SPREAD, W_TAINT, W_TOPO_SPREAD, ScoreDeco,
                     stack_weights)

F = np.float32
MAX_PRIORITY = F(10.0)
EPS = F(1e-5)
NEG = np.int32(-(2 ** 31) + 1)
INT32_MIN = np.int32(np.iinfo(np.int32).min)


def floor_div(x):
    """ops/scores.py floor_div: Go integer-division emulation, f32."""
    return np.floor(x + EPS)


# -- selector programs (ops/selectors.py twin) --------------------------------


def eval_expr_batch(labels, label_nums, key, op, vals, num, entity_ids):
    """Numpy twin of selectors.eval_expr_batch; same shapes/semantics.
    Unlike the device formulation (where dead lanes are free), each
    operand plane is computed only when some program in the batch uses
    its op — pad-heavy batches skip the [B, X, V] broadcasts."""
    K = labels.shape[1]
    safe_key = np.clip(key, 0, K - 1)
    row_vals = labels[:, safe_key].T  # [B, X]
    has_key = row_vals != 0
    opc = op[:, None]
    zeros = np.zeros_like(has_key)
    if np.any((op == enc.OP_IN) | (op == enc.OP_NOT_IN)):
        in_set = np.any(row_vals[:, :, None] == vals[:, None, :], axis=-1)
    else:
        in_set = zeros
    if np.any(op == enc.OP_NODE_NAME_IN):
        name_in = np.any(entity_ids[None, :, None] == vals[:, None, :],
                         axis=-1)
    else:
        name_in = zeros
    if label_nums is not None and np.any((op == enc.OP_GT)
                                         | (op == enc.OP_LT)):
        row_nums = label_nums[:, safe_key].T
        with np.errstate(invalid="ignore"):
            gt = has_key & (row_nums > num[:, None])  # NaN -> False
            lt = has_key & (row_nums < num[:, None])
    else:
        gt = lt = zeros
    return np.select(
        [
            opc == enc.OP_IN,
            opc == enc.OP_NOT_IN,
            opc == enc.OP_EXISTS,
            opc == enc.OP_DOES_NOT_EXIST,
            opc == enc.OP_GT,
            opc == enc.OP_LT,
            opc == enc.OP_NODE_NAME_IN,
            opc == enc.OP_FALSE,
        ],
        [
            has_key & in_set,
            ~(has_key & in_set),
            has_key,
            ~has_key,
            gt,
            lt,
            name_in,
            zeros,
        ],
        default=np.ones_like(has_key),  # OP_PAD
    )


def eval_and_program(labels, label_nums, key, op, vals, num, entity_ids):
    """Numpy twin of selectors.eval_and_program (AND over last axis).
    Expression slots that are OP_PAD across the whole batch evaluate to
    all-True by definition and are skipped — programs are typically 1-2
    expressions wide in an 8-slot cap."""
    lead = key.shape[:-1]
    E = key.shape[-1]
    B = 1
    for s in lead:
        B *= s
    k2 = key.reshape(B, E)
    o2 = op.reshape(B, E)
    v2 = vals.reshape(B, E, vals.shape[-1])
    n2 = num.reshape(B, E)
    X = labels.shape[0]
    out = np.ones((B, X), bool)
    for e in range(E):
        if np.all(o2[:, e] == enc.OP_PAD):
            continue
        out &= eval_expr_batch(labels, label_nums, k2[:, e], o2[:, e],
                               v2[:, e], n2[:, e], entity_ids)
    return out.reshape(*lead, X)


# -- filter predicates (ops/filters.py twin) ----------------------------------


def check_node_condition(nt):
    c = nt.cond
    return ~(c[:, enc.COND_NOT_READY] | c[:, enc.COND_OUT_OF_DISK]
             | c[:, enc.COND_NET_UNAVAIL])


def check_node_unschedulable(nt):
    return ~nt.cond[:, enc.COND_UNSCHEDULABLE]


def host_name(nt, pb):
    N = nt.valid.shape[0]
    idx = np.arange(N, dtype=np.int32)
    return (pb.host_idx[:, None] == -1) | (idx[None, :] == pb.host_idx[:, None])


def host_ports(nt, pb):
    P, PQ = pb.ports.shape
    N = nt.ports.shape[0]
    conflict = np.zeros((P, N), bool)
    for q in range(PQ):
        pq = pb.ports[:, q]
        hit = np.any(pq[:, None, None] == nt.ports[None, :, :], axis=-1)
        conflict |= (pq > 0)[:, None] & hit
    return ~conflict


def match_node_selector(nt, pb):
    N = nt.labels.shape[0]
    node_ids = np.arange(N, dtype=np.int32)
    ok = np.ones((pb.ns_key.shape[0], N), bool)
    K = nt.labels.shape[1]
    for s in range(pb.ns_key.shape[1]):
        key = pb.ns_key[:, s]
        val = pb.ns_val[:, s]
        safe = np.clip(key, 0, K - 1)
        node_val = nt.labels[:, safe].T  # [P, N]
        pair_ok = node_val == val[:, None]
        ok &= np.where((key == 0)[:, None], True,
                       np.where((key < 0)[:, None], False, pair_ok))
    term_match = eval_and_program(nt.labels, nt.label_nums, pb.at_key,
                                  pb.at_op, pb.at_vals, pb.at_num,
                                  node_ids)  # [P, AT, N]
    any_term = np.any(term_match & pb.at_valid[:, :, None], axis=1)
    aff_ok = np.where(pb.has_aff[:, None], any_term, True)
    return ok & aff_ok


def _tolerated(nt, pb, t: int):
    tk = nt.taint_key[:, t]
    tv = nt.taint_val[:, t]
    te = nt.taint_effect[:, t]
    key_ok = (pb.tol_key == 0)[:, :, None] | (
        pb.tol_key[:, :, None] == tk[None, None, :])
    val_ok = (pb.tol_op == enc.TOL_EXISTS)[:, :, None] | (
        pb.tol_val[:, :, None] == tv[None, None, :])
    eff_ok = (pb.tol_effect == 0)[:, :, None] | (
        pb.tol_effect[:, :, None] == te[None, None, :])
    live = (pb.tol_op != enc.TOL_PAD)[:, :, None]
    return np.any(live & key_ok & val_ok & eff_ok, axis=1)


def tolerates_taints(nt, pb, effects):
    P = pb.req.shape[0]
    N = nt.taint_key.shape[0]
    untol = np.zeros((P, N), bool)
    T = nt.taint_key.shape[1]
    for t in range(T):
        te = nt.taint_effect[:, t]
        relevant = np.zeros((N,), bool)
        for e in effects:
            relevant |= te == e
        untol |= relevant[None, :] & ~_tolerated(nt, pb, t)
    return ~untol


def pressure_checks(nt, pb):
    mem = ~(pb.best_effort[:, None] & nt.cond[None, :, enc.COND_MEM_PRESSURE])
    disk = ~nt.cond[:, enc.COND_DISK_PRESSURE]
    pid = ~nt.cond[:, enc.COND_PID_PRESSURE]
    return mem, disk, pid


def resource_fit(alloc, allowed_pods, requested, pod_count, req, is_core):
    """ops/filters.py resource_fit, numpy. req: f32 [..., R]."""
    reqb = req[..., None, :]
    fits_col = requested[None, :, :] + reqb <= alloc[None, :, :]
    check = is_core[None, :] | (reqb > 0)
    dims_ok = np.all(fits_col | ~check, axis=-1)
    empty = np.all(req == 0, axis=-1)[..., None]
    pods_ok = pod_count + 1 <= allowed_pods
    return (dims_ok | empty) & pods_ok[None, :]


def static_predicate_masks(nt, pb, is_core):
    """[Q, P, N] stack in enc.DEVICE_PREDICATES order (pure-XLA
    formulation of ops/filters.py static_predicate_masks)."""
    P = pb.req.shape[0]
    N = nt.valid.shape[0]
    ones = np.ones((P, N), bool)
    cond = check_node_condition(nt)[None, :] & ones
    unsched = check_node_unschedulable(nt)[None, :] & ones
    res = resource_fit(nt.alloc, nt.allowed_pods, nt.requested, nt.pod_count,
                       pb.req, is_core)
    host = host_name(nt, pb)
    sel = match_node_selector(nt, pb)
    ports = host_ports(nt, pb)
    taints = tolerates_taints(
        nt, pb, (enc.EFFECT_NO_SCHEDULE, enc.EFFECT_NO_EXECUTE))
    mem, disk, pid = pressure_checks(nt, pb)
    disk = disk[None, :] & ones
    pid = pid[None, :] & ones
    return np.stack([cond, unsched, res, host, ports, sel, taints, mem,
                     disk, pid])


# -- score kernels (ops/scores.py twin) ---------------------------------------


def least_requested(nz, alloc2, pod_nz):
    r = nz + pod_nz[None, :]
    per = floor_div((alloc2 - r) * MAX_PRIORITY / np.maximum(alloc2, F(1.0)))
    per = np.where((alloc2 == 0) | (r > alloc2), F(0.0), per)
    return floor_div((per[:, 0] + per[:, 1]) / F(2.0))


def most_requested(nz, alloc2, pod_nz):
    r = nz + pod_nz[None, :]
    per = floor_div(r * MAX_PRIORITY / np.maximum(alloc2, F(1.0)))
    per = np.where((alloc2 == 0) | (r > alloc2), F(0.0), per)
    return floor_div((per[:, 0] + per[:, 1]) / F(2.0))


def balanced_allocation(nz, alloc2, pod_nz):
    r = nz + pod_nz[None, :]
    frac = np.where(alloc2 == 0, F(1.0), r / np.maximum(alloc2, F(1.0)))
    diff = np.abs(frac[:, 0] - frac[:, 1])
    score = floor_div((F(1.0) - diff) * MAX_PRIORITY)
    return np.where(np.any(frac >= 1.0, axis=1), F(0.0), score)


def node_affinity_raw(nt, pb):
    N = nt.labels.shape[0]
    if not np.any(pb.pt_weight):
        return np.zeros((pb.req.shape[0], N), np.float32)
    node_ids = np.arange(N, dtype=np.int32)
    term_match = eval_and_program(nt.labels, nt.label_nums, pb.pt_key,
                                  pb.pt_op, pb.pt_vals, pb.pt_num, node_ids)
    w = pb.pt_weight[:, :, None]
    return np.sum(np.where(term_match, w, F(0.0)), axis=1,
                  dtype=np.float64).astype(np.float32)


def taint_intolerable_raw(nt, pb):
    P = pb.req.shape[0]
    N = nt.taint_key.shape[0]
    eligible = (pb.tol_effect == 0) | (pb.tol_effect == enc.EFFECT_PREFER_NO_SCHEDULE)
    eligible &= pb.tol_op != enc.TOL_PAD
    count = np.zeros((P, N), np.float32)
    for t in range(nt.taint_key.shape[1]):
        tk = nt.taint_key[:, t]
        tv = nt.taint_val[:, t]
        te = nt.taint_effect[:, t]
        relevant = te == enc.EFFECT_PREFER_NO_SCHEDULE
        key_ok = (pb.tol_key == 0)[:, :, None] | (
            pb.tol_key[:, :, None] == tk[None, None, :])
        val_ok = (pb.tol_op == enc.TOL_EXISTS)[:, :, None] | (
            pb.tol_val[:, :, None] == tv[None, None, :])
        eff_ok = (pb.tol_effect == 0)[:, :, None] | (
            pb.tol_effect[:, :, None] == te[None, None, :])
        tol = np.any((eligible[:, :, None]) & key_ok & val_ok & eff_ok, axis=1)
        count += (relevant[None, :] & ~tol).astype(np.float32)
    return count


def spread_counts(pm, pb, num_nodes: int):
    if not np.any(pb.sg_valid):
        # no spreading selectors anywhere in the batch: counts are all
        # zero by the has_sel gate below — skip the [P, SG, M] evals
        return np.zeros((pb.req.shape[0], num_nodes), np.int32)
    M = pm.labels.shape[0]
    ep_ids = np.arange(M, dtype=np.int32)
    m = eval_and_program(pm.labels, None, pb.sg_key, pb.sg_op, pb.sg_vals,
                         pb.sg_num, ep_ids)  # [P, SG, M]
    any_sel = np.any(m & pb.sg_valid[:, :, None], axis=1)
    has_sel = np.any(pb.sg_valid, axis=1)
    eligible = pm.valid & pm.alive
    same_ns = pm.ns[None, :] == pb.ns_id[:, None]
    matched = any_sel & eligible[None, :] & same_ns & has_sel[:, None]
    node = np.clip(pm.node, 0, None)
    out = np.zeros((matched.shape[0], num_nodes), np.int32)
    for p in range(matched.shape[0]):
        out[p] = np.bincount(node, weights=matched[p],
                             minlength=num_nodes)[:num_nodes].astype(np.int32)
    return out


def spread_reduce(cnt, feasible, zone_id, num_zones: int):
    cntf = np.where(feasible, cnt, 0).astype(np.float32)
    max_node = np.max(cntf)
    zc = np.bincount(zone_id, weights=np.where(zone_id > 0, cntf, 0.0),
                     minlength=num_zones)[:num_zones].astype(np.float32)
    zc0 = zc.copy()
    zc0[0] = 0.0
    max_zone = np.max(zc0)
    have_zones = np.any(feasible & (zone_id > 0))
    f = np.where(max_node > 0,
                 MAX_PRIORITY * (max_node - cntf) / np.maximum(max_node, F(1.0)),
                 MAX_PRIORITY)
    node_zc = zc[zone_id]
    zscore = np.where(max_zone > 0,
                      MAX_PRIORITY * (max_zone - node_zc) / np.maximum(max_zone, F(1.0)),
                      MAX_PRIORITY)
    f = np.where(have_zones & (zone_id > 0),
                 f / F(3.0) + F(2.0 / 3.0) * zscore, f)
    return floor_div(f)


def image_locality(nt, pb):
    P, PI = pb.img_id.shape
    total = np.zeros((P, nt.img_id.shape[0]), np.float32)
    for i in range(PI):
        pid = pb.img_id[:, i]
        hit = pid[:, None, None] == nt.img_id[None, :, :]
        # Twin of ops/scores.py image_locality — must mirror the device
        # op order exactly, not re-associate.
        # ktpu: allow[f32-reduction] device-mirrored op order
        sz = np.sum(np.where(hit, nt.img_size[None, :, :], F(0.0)), axis=-1)
        total += np.where((pid > 0)[:, None], sz, F(0.0))
    mb = F(1024.0 * 1024.0)
    min_img, max_img = F(23.0) * mb, F(1000.0) * mb
    mid = floor_div(MAX_PRIORITY * (total - min_img) / (max_img - min_img)) + F(1.0)
    return np.where(total < min_img, F(0.0),
                    np.where(total >= max_img, MAX_PRIORITY, mid))


def prefer_avoid(nt, pb):
    avoid = nt.avoid[None, :] & pb.owned[:, None]
    return np.where(avoid, F(0.0), MAX_PRIORITY)


def normalize_reduce(raw, feasible, reverse: bool):
    m = np.max(np.where(feasible, raw, F(0.0)))
    score = floor_div(MAX_PRIORITY * raw / np.maximum(m, F(1.0)))
    if reverse:
        score = MAX_PRIORITY - score
        return np.where(m > 0, score, MAX_PRIORITY)
    return np.where(m > 0, score, F(0.0))


# -- inter-pod affinity (ops/affinity.py twin) --------------------------------
#
# Same shapes, same semantics, numpy: the [P, E] term-entry match times
# the [E, N] same-domain matrix (an exact f32 contraction over 0/1 and
# integer weights), the deduplicated incoming required/preferred
# programs anchored through the label-value vocabulary, and the wave-
# internal [P, P] cross matrices the commit loop consumes. Bitwise
# parity with the device plane is asserted in tests/test_hostwave.py.


def _ipa_ns_match(ns_sets, ns_ids):
    """affinity.ns_match twin: bool [..., X] — is ns_ids[x] in
    ns_sets[...]? (0 pad: an all-pad set matches nothing)."""
    expanded = ns_sets[..., :, None]  # [..., TNS, 1]
    ids = np.reshape(ns_ids, (1,) * (ns_sets.ndim - 1) + (1, -1))
    return np.any((expanded == ids) & (expanded > 0), axis=-2)


def _ipa_eval_programs(label_matrix, key, op, vals):
    """affinity._eval_programs twin: AND programs (no numeric ops)
    against a label matrix; key/op [..., E], vals [..., E, V] ->
    bool [..., X]."""
    num = np.full(key.shape, np.nan, np.float32)
    ids = np.arange(label_matrix.shape[0], dtype=np.int32)
    return eval_and_program(label_matrix, None, key, op, vals, num, ids)


def _ipa_bool_matmul(a, b):
    """bool [P, E] @ bool [E, N] via f32 — 0/1 sums are integers, exact
    in f32 regardless of accumulation order (device parity)."""
    return (a.astype(np.float32) @ b.astype(np.float32)) > 0.5


def term_entry_match_host(tt, pb):
    """affinity.term_entry_match twin: bool [P, E]."""
    sel = _ipa_eval_programs(pb.pl_val, tt.key, tt.op, tt.vals)  # [E, P]
    nsm = _ipa_ns_match(tt.ns, pb.ns_id)  # [E, P]
    return (sel & nsm & tt.valid[:, None]).T


def same_domain_host(tt, nt):
    """affinity.same_domain twin: bool [E, N]."""
    K = nt.labels.shape[1]
    tk = np.clip(tt.tk, 0, K - 1)
    own = np.take_along_axis(nt.labels[tt.node], tk[:, None], axis=1)[:, 0]
    node_dom = nt.labels[:, tk].T  # [E, N]
    return ((node_dom == own[:, None]) & (own > 0)[:, None] & (node_dom > 0)
            & (tt.tk > 0)[:, None] & tt.valid[:, None] & nt.valid[None, :])


def node_domains_host(nt, tk):
    """affinity.node_domains twin: i32 [..., N]."""
    K = nt.labels.shape[1]
    flat = np.reshape(tk, (-1,))
    safe = np.clip(flat, 0, K - 1)
    dom = nt.labels[:, safe].T  # [B, N]
    dom = np.where((flat > 0)[:, None], dom, 0)
    return dom.reshape(tuple(np.shape(tk)) + (nt.labels.shape[0],))


def _anchored_hit_host(match, dom_m, num_segments, count=False):
    """affinity._anchored_hit twin: segment-reduce matching pods by
    their node's domain value; [P/U, M] -> [P/U, LV]. bincount
    accumulates in f64 and the counts are integers, so the f32 round is
    exact (matches the device's f32 segment_sum bit-for-bit)."""
    contrib = (match & (dom_m > 0)).astype(np.float32)
    B = match.shape[0]
    hit = np.zeros((B, num_segments), np.float32)
    for b in range(B):
        hit[b] = np.bincount(
            dom_m[b], weights=contrib[b],
            minlength=num_segments)[:num_segments].astype(np.float32)
    return hit if count else hit > 0.5


def incoming_statics_host(nt, pm, tt, pb, num_label_values: int,
                          hard_weight: float):
    """affinity.incoming_statics twin — the per-wave static (pre-commit)
    inter-pod affinity state, as the same IncomingStatics tuple over
    numpy planes."""
    from .affinity import IncomingStatics

    em = term_entry_match_host(tt, pb)  # [P, E]
    sd = same_domain_host(tt, nt)  # [E, N]
    kind = tt.kind
    sym_blocked = _ipa_bool_matmul(
        em & (kind == enc.TERM_REQ_ANTI)[None, :], sd)

    # incoming required (anti)affinity, deduplicated (pb.iu_*, row 0 =
    # never-matches); per-pod views are gathers through ra_uid/rn_uid
    u_sel = _ipa_eval_programs(pm.labels, pb.iu_key, pb.iu_op,
                               pb.iu_vals)  # [U, M]
    u_m = u_sel & _ipa_ns_match(pb.iu_ns, pm.ns) & pm.valid[None, :]
    node_dom_u = node_domains_host(nt, pb.iu_tk)  # [U, N]
    dom_m_u = np.take_along_axis(
        node_dom_u, np.broadcast_to(pm.node[None, :], u_m.shape), axis=1)
    hit_u = _anchored_hit_host(u_m, dom_m_u, num_label_values)  # [U, LV]
    ok_u = np.take_along_axis(hit_u, node_dom_u, axis=1) & (node_dom_u > 0)
    any_u = np.any(u_m, axis=1)  # [U]

    ok_aff = ok_u[pb.ra_uid]  # [P, N]
    any_aff = any_u[pb.ra_uid]
    node_dom_ra = node_dom_u[pb.ra_uid]
    blocked_anti = ok_u[pb.rn_uid]
    node_dom_rn = node_dom_u[pb.rn_uid]

    # priority counts: hard symmetric weight for required affinity,
    # signed weights for preferred terms — integer-valued, so the f32
    # contraction is exact in any order
    we = np.select(
        [kind == enc.TERM_REQ_AFF, kind == enc.TERM_PREF_AFF,
         kind == enc.TERM_PREF_ANTI],
        [np.full_like(tt.weight, hard_weight), tt.weight, -tt.weight],
        default=np.zeros_like(tt.weight))
    counts = (em.astype(np.float32) * we[None, :]) @ sd.astype(np.float32)
    pu_sel = _ipa_eval_programs(pm.labels, pb.pu_key, pb.pu_op, pb.pu_vals)
    pu_m = pu_sel & _ipa_ns_match(pb.pu_ns, pm.ns) & pm.valid[None, :]
    dom_pu = node_domains_host(nt, pb.pu_tk)  # [UP, N]
    dom_m_pu = np.take_along_axis(
        dom_pu, np.broadcast_to(pm.node[None, :], pu_m.shape), axis=1)
    cnt_u = _anchored_hit_host(pu_m, dom_m_pu, num_label_values, count=True)
    cnt_node_u = (np.take_along_axis(cnt_u, dom_pu, axis=1)
                  * (dom_pu > 0))  # [UP, N]
    PA = pb.pa_w.shape[1]
    for t in range(PA):
        counts = counts + pb.pa_w[:, t, None] * cnt_node_u[pb.pa_uid[:, t]]
    counts = counts * nt.valid[None, :]

    # wave-internal cross matrices (pod j vs pod i's required props)
    wave_aff_sel = _ipa_eval_programs(pb.pl_val, pb.ra_key, pb.ra_op,
                                      pb.ra_vals)
    wm_aff = (wave_aff_sel & _ipa_ns_match(pb.ra_ns, pb.ns_id)
              & pb.ra_has[:, None] & pb.valid[None, :])
    wave_anti_sel = _ipa_eval_programs(pb.pl_val, pb.rn_key, pb.rn_op,
                                       pb.rn_vals)
    wm_anti = (wave_anti_sel & _ipa_ns_match(pb.rn_ns, pb.ns_id)
               & pb.rn_has[:, None] & pb.valid[None, :])

    return IncomingStatics(
        sym_blocked=sym_blocked, ok_aff=ok_aff, any_aff=any_aff,
        blocked_anti=blocked_anti, counts=counts,
        node_dom_ra=node_dom_ra, node_dom_rn=node_dom_rn,
        wm_aff=wm_aff, wm_anti=wm_anti)


# -- topology spread (ops/topology.py twin) -----------------------------------


def topo_statics_host(nt, pm, pb, num_label_values: int):
    """ops/topology.py topo_statics twin — the per-wave static
    PodTopologySpread state as the same TopoStatics tuple over numpy
    planes. Counts go through the f64 bincount + f32 round of
    _anchored_hit_host (integer-valued, so bitwise with the device's
    f32 segment_sum)."""
    from .topology import TopoStatics

    P, TS = pb.ts_tk.shape
    N = nt.labels.shape[0]
    dom = node_domains_host(nt, pb.ts_tk)  # [P, TS, N]
    dom = dom * nt.valid[None, None, :]
    dom_f = dom.reshape(P * TS, N)

    live = pb.ts_valid[:, :, None]  # [P, TS, 1]
    sel = _ipa_eval_programs(pm.labels, pb.ts_key, pb.ts_op,
                             pb.ts_vals)  # [P, TS, M]
    same_ns = (pm.ns[None, None, :] == pb.ns_id[:, None, None])
    match = sel & same_ns & (pm.valid & pm.alive)[None, None, :] & live
    M = pm.labels.shape[0]
    dom_m = np.take_along_axis(
        dom_f, np.broadcast_to(pm.node[None, :], (P * TS, M)), axis=1)
    counts = _anchored_hit_host(match.reshape(P * TS, M), dom_m,
                                num_label_values, count=True)
    present = _anchored_hit_host(
        np.broadcast_to(nt.valid[None, :], (P * TS, N)), dom_f,
        num_label_values)

    wsel = _ipa_eval_programs(pb.pl_val, pb.ts_key, pb.ts_op,
                              pb.ts_vals)  # [P, TS, P]
    wave_ns = (pb.ns_id[None, None, :] == pb.ns_id[:, None, None])
    wm = wsel & wave_ns & pb.valid[None, None, :] & live
    selfm = wm[np.arange(P), :, np.arange(P)]  # [P, TS]
    return TopoStatics(node_dom=dom.astype(np.int32),
                       counts=counts.reshape(P, TS, num_label_values),
                       present=present.reshape(P, TS, num_label_values),
                       wm=wm, selfm=selfm)


# -- the wave (ops/kernel.py _wave_body twin) ---------------------------------


def schedule_wave_host(nt, pm, tt, pb, extra_mask, rr_start: int,
                       extra_scores=None, *, weights: Weights,
                       num_zones: int, num_label_values: int = 64,
                       has_ipa: bool = False, has_ts=None,
                       usage_in=None,
                       collect_scores: bool = False,
                       weight_vec=None) -> WaveResult:
    """One batched host wave: masks + scores over (P x N), then the
    sequential greedy commit with usage carry — the numpy statement of
    _wave_body's lax.scan. has_ipa compiles in the inter-pod affinity
    plane (incoming_statics_host + the wave-internal symmetry /
    required-(anti)affinity logic mirrored from the scan step), bit-for-
    bit with the device kernel; only multi-topology-key pods still route
    golden (needs_host_path), exactly like the device path.

    usage_in: optional (requested, nonzero, pod_count) override (the
    gang wrapper and chained degraded waves carry usage the same way
    the device-resident round does). The input planes are never
    mutated — carries are copies.

    collect_scores: emit the per-priority decomposition (WaveResult.deco,
    see ops/scores.py ScoreDeco) bit-for-bit matching the device
    kernel's — top-k is argsort-stable descending, exactly lax.top_k's
    lowest-index-first tie order.

    weight_vec: optional f32 [S] SCORE_STACK-aligned weight vector
    mirroring the kernel's traced live-profile input — supplies the
    weighted-sum multipliers while `weights` keeps gating which planes
    compute, in the identical f32 op order (degraded mode and the
    shadow exact-mode twin run under the same hot-swapped vector the
    device path uses).
    """
    N = nt.valid.shape[0]
    P = pb.req.shape[0]
    R = nt.alloc.shape[1]
    # the device wrapper's has_ts derivation (ops/kernel.py
    # schedule_wave): spread-free waves skip the topology plane exactly
    # like the compiled program does
    if has_ts is None:
        has_ts = bool(np.any(pb.ts_valid))
    is_core = np.arange(R) < enc.RES_FIXED
    masks = static_predicate_masks(nt, pb, is_core)  # [Q-3, P, N]
    ts_placeholder = np.ones((1, P, N), bool)
    ipa_placeholder = np.ones((1, P, N), bool)
    masks = np.concatenate([masks, ts_placeholder, ipa_placeholder,
                            np.asarray(extra_mask, bool)[None]], axis=0)
    res_i = enc.PRED_IDX["PodFitsResources"]
    ipa_i = enc.PRED_IDX["MatchInterPodAffinity"]
    ts_i = enc.PRED_IDX["PodTopologySpread"]
    m2 = masks.copy()
    m2[res_i] = True
    static_nonres = np.all(m2, axis=0)  # [P, N]
    alloc2 = nt.alloc[:, :2]
    ipa = (incoming_statics_host(nt, pm, tt, pb, num_label_values,
                                 weights.hard_pod_affinity)
           if has_ipa else None)
    topo = (topo_statics_host(nt, pm, pb, num_label_values)
            if has_ts else None)
    lv_ids = np.arange(num_label_values, dtype=np.int32)

    w = weights
    # the kernel's wv twin: the caller's live vector, or the static
    # weights — wv[s] is np.float32, the same scalar the device
    # multiplies by
    wv = (np.asarray(weight_vec, np.float32) if weight_vec is not None
          else stack_weights(w))
    # mirrors the kernel: under collect_scores the raw planes are
    # computed even at weight 0, so the decomposition never fabricates
    # flat rows for priorities a profile disabled
    aff_raw = (node_affinity_raw(nt, pb)
               if w.node_affinity or collect_scores
               else np.zeros((P, N), np.float32))
    taint_raw = (taint_intolerable_raw(nt, pb)
                 if w.taint_toleration or collect_scores
                 else np.zeros((P, N), np.float32))
    spread_cnt = (spread_counts(pm, pb, N)
                  if w.selector_spread or collect_scores
                  else np.zeros((P, N), np.int32))
    # computed once and shared between static_score and the
    # decomposition (numpy has no CSE to dedupe a second call)
    avoid_full = (prefer_avoid(nt, pb)
                  if w.prefer_avoid or collect_scores else None)
    img_full = (image_locality(nt, pb)
                if w.image_locality or collect_scores else None)
    static_score = np.zeros((P, N), np.float32)
    if w.image_locality:
        static_score = static_score + wv[W_IMAGE] * img_full
    if w.prefer_avoid:
        static_score = static_score + wv[W_AVOID] * avoid_full
    if extra_scores is not None:
        static_score += np.asarray(extra_scores, np.float32)
    if collect_scores:
        extra_full = (np.asarray(extra_scores, np.float32)
                      if extra_scores is not None
                      else np.zeros((P, N), np.float32))
        S = len(SCORE_STACK)
        KK = min(SCORE_TOPK, N)
        d_cparts = np.zeros((P, S), np.float32)
        d_tidx = np.zeros((P, KK), np.int32)
        d_tvals = np.full((P, KK), -1.0, np.float32)
        d_tparts = np.zeros((P, S, KK), np.float32)

    usage0 = usage_in if usage_in is not None else (
        nt.requested, nt.nonzero, nt.pod_count)
    req_c = np.array(usage0[0], np.float32, copy=True)
    nz_c = np.array(usage0[1], np.float32, copy=True)
    cnt_c = np.array(usage0[2], np.int32, copy=True)
    # wave-start pod counts: the compactness plane's baseline (the
    # kernel's pod_count0 closure)
    cnt0 = cnt_c.copy()
    rr = int(rr_start)

    chosen = np.full((P,), -1, np.int32)
    best_s = np.full((P,), -1.0, np.float32)
    feas_cnt = np.zeros((P,), np.int32)
    dyn_fits = np.zeros((P, N), bool)
    ipa_masks = np.ones((P, N), bool)
    ts_masks = np.ones((P, N), bool)

    for i in range(P):
        fits = resource_fit(nt.alloc, nt.allowed_pods, req_c, cnt_c,
                            pb.req[i][None, :], is_core)[0]
        dyn_fits[i] = fits
        feasible = static_nonres[i] & fits & nt.valid & bool(pb.valid[i])
        if has_ipa:
            # the scan step's wave-internal (anti)affinity logic,
            # mirrored: `chosen` holds this wave's placements so far
            # (the device scan's `placed` carry)
            active = chosen >= 0  # [P]
            safe_pl = np.clip(chosen, 0, None)
            dra_row = ipa.node_dom_ra[i]  # [N]
            # incoming required affinity vs pods placed earlier
            pl_dom = dra_row[safe_pl]  # [P]
            src = ipa.wm_aff[i] & active & (pl_dom > 0)
            wave_aff = np.any(
                src[:, None] & (pl_dom[:, None] == dra_row[None, :]),
                axis=0) & (dra_row > 0)
            any_aff = bool(ipa.any_aff[i]) | bool(
                np.any(ipa.wm_aff[i] & active))
            ok_aff = (ipa.ok_aff[i] | wave_aff
                      | ((not any_aff) & bool(pb.ra_self[i])))
            ok_aff = np.where(bool(pb.ra_has[i]), ok_aff, True)
            # incoming required anti-affinity vs wave placements
            drn_row = ipa.node_dom_rn[i]
            pl_dom_n = drn_row[safe_pl]
            srcn = ipa.wm_anti[i] & active & (pl_dom_n > 0)
            wave_anti = np.any(
                srcn[:, None] & (pl_dom_n[:, None] == drn_row[None, :]),
                axis=0) & (drn_row > 0)
            ok_anti = ~(bool(pb.rn_has[i])
                        & (ipa.blocked_anti[i] | wave_anti))
            # symmetry: wave pod j's required anti terms vs me, under
            # j's topology key
            node_dom_rn_full = ipa.node_dom_rn  # [P, N]
            pd_sym = np.take_along_axis(
                node_dom_rn_full, safe_pl[:, None], axis=1)[:, 0]  # [P]
            srcs = ipa.wm_anti[:, i] & active & (pd_sym > 0)
            sym_wave = np.any(
                srcs[:, None] & (pd_sym[:, None] == node_dom_rn_full)
                & (node_dom_rn_full > 0), axis=0)
            ipa_ok = ~(ipa.sym_blocked[i] | sym_wave) & ok_aff & ok_anti
            feasible = feasible & ipa_ok
            ipa_masks[i] = ipa_ok
        if has_ts:
            # the scan step's PodTopologySpread logic, mirrored:
            # resident counts + same-wave placements via `chosen`
            active_t = chosen >= 0
            safe_pl_t = np.clip(chosen, 0, None)
            tdom = topo.node_dom[i]  # [TS, N]
            tcnt = topo.counts[i]  # [TS, LV]
            tpres = topo.present[i]  # [TS, LV]
            twm = topo.wm[i]  # [TS, P]
            pl_dom_ts = tdom[:, safe_pl_t]  # [TS, P]
            addm = twm & active_t[None, :] & (pl_dom_ts > 0)
            onehot = ((pl_dom_ts[:, :, None] == lv_ids[None, None, :])
                      & addm[:, :, None])
            # integer-valued one-hot sum, device-mirrored op order.
            # ktpu: allow[f32-reduction] integer-valued, twin of kernel
            cnt_dyn = tcnt + np.sum(onehot.astype(np.float32), axis=1)
            cnt_at = np.take_along_axis(cnt_dyn, tdom, axis=1)  # [TS, N]
            key_ok = tdom > 0
            anyp = np.any(tpres, axis=1)  # [TS]
            minm = np.where(
                anyp,
                np.min(np.where(tpres, cnt_dyn, F(np.inf)), axis=1),
                F(0.0))
            cand = cnt_at + topo.selfm[i][:, None].astype(np.float32)
            hard = (pb.ts_valid[i] & pb.ts_hard[i])[:, None]
            ok_rows = np.where(
                hard,
                key_ok & ((cand - minm[:, None]) <= pb.ts_skew[i][:, None]),
                True)
            ts_ok = np.all(ok_rows, axis=0)  # [N]
            feasible = feasible & ts_ok
            ts_masks[i] = ts_ok
        total = static_score[i]
        fscore = None
        if has_ipa and (w.interpod or collect_scores):
            counts_row = ipa.counts[i]
            cmasked = np.where(feasible, counts_row, F(0.0))
            cmin = np.minimum(np.min(cmasked), F(0.0))
            cmax = np.maximum(np.max(cmasked), F(0.0))
            crange = cmax - cmin
            with np.errstate(divide="ignore", invalid="ignore"):
                fscore = np.where(
                    crange > 0,
                    floor_div(F(10.0) * (counts_row - cmin) / crange),
                    F(0.0))
        if has_ipa and w.interpod:
            total = total + wv[W_INTERPOD] * fscore
        aff_n = (normalize_reduce(aff_raw[i], feasible, False)
                 if w.node_affinity or collect_scores else None)
        if w.node_affinity:
            total = total + wv[W_AFFINITY] * aff_n
        taint_n = (normalize_reduce(taint_raw[i], feasible, True)
                   if w.taint_toleration or collect_scores else None)
        if w.taint_toleration:
            total = total + wv[W_TAINT] * taint_n
        spread_n = (spread_reduce(spread_cnt[i], feasible, nt.zone_id,
                                  num_zones)
                    if w.selector_spread or collect_scores else None)
        if w.selector_spread:
            total = total + wv[W_SPREAD] * spread_n
        lr = (least_requested(nz_c, alloc2, pb.nonzero[i])
              if w.least_requested or collect_scores else None)
        if w.least_requested:
            total = total + wv[W_LEAST] * lr
        ba = (balanced_allocation(nz_c, alloc2, pb.nonzero[i])
              if w.balanced or collect_scores else None)
        if w.balanced:
            total = total + wv[W_BALANCED] * ba
        mr = (most_requested(nz_c, alloc2, pb.nonzero[i])
              if w.most_requested or collect_scores else None)
        if w.most_requested:
            total = total + wv[W_MOST] * mr
        ts_n = None
        if has_ts and (w.topology_spread or collect_scores):
            maxm = np.where(
                anyp,
                np.max(np.where(tpres, cnt_dyn, F(-np.inf)), axis=1),
                F(0.0))
            # TS-axis sum of integer-valued f32, device-mirrored.
            # ktpu: allow[f32-reduction] twin of kernel ts_raw
            ts_raw = np.sum(
                np.where(key_ok & pb.ts_valid[i][:, None],
                         np.maximum(maxm[:, None] - cnt_at, F(0.0)),
                         F(0.0)),
                axis=0)
            ts_n = normalize_reduce(ts_raw, feasible, False)
        if has_ts and w.topology_spread:
            total = total + wv[W_TOPO_SPREAD] * ts_n
        compact_n = None
        if w.topology_compactness or collect_scores:
            # kernel compactness plane, mirrored: this wave's placements
            # per rack/superpod (f64 bincount -> f32, integer-exact) with
            # the rack-over-superpod gradient and accel-gen priority bias
            wave_placed = (cnt_c - cnt0).astype(np.float32)
            rsum = np.bincount(
                nt.rack_id, weights=wave_placed,
                minlength=num_zones)[:num_zones].astype(np.float32)
            rackc = rsum[nt.rack_id] * (nt.rack_id > 0)
            ssum = np.bincount(
                nt.superpod_id, weights=wave_placed,
                minlength=num_zones)[:num_zones].astype(np.float32)
            spc = ssum[nt.superpod_id] * (nt.superpod_id > 0)
            gen = nt.accel_gen.astype(np.float32) * (pb.prio[i] > 0)
            compact_raw = F(3.0) * rackc + spc + gen
            compact_n = normalize_reduce(compact_raw, feasible, False)
        if w.topology_compactness:
            total = total + wv[W_COMPACT] * compact_n
        sm = np.where(feasible, total, F(-1.0))
        best = np.max(sm) if N else F(-1.0)
        best_s[i] = best
        feas_cnt[i] = int(np.sum(feasible))
        if collect_scores:
            zr = np.zeros_like(total)
            parts = np.stack([
                lr, ba, mr, aff_n, taint_n, spread_n,
                avoid_full[i], img_full[i],
                fscore if fscore is not None else zr,
                ts_n if ts_n is not None else zr,
                compact_n if compact_n is not None else zr,
                extra_full[i]])
            # lax.top_k order: descending value, lowest index on ties
            order = np.argsort(-sm, kind="stable")[:KK]
            d_tidx[i] = order.astype(np.int32)
            d_tvals[i] = sm[order]
            d_tparts[i] = parts[:, order]
        if best >= 0:
            ties = feasible & (sm == best)
            k = max(int(np.sum(ties)), 1)
            rank = np.cumsum(ties.astype(np.int32)) - 1
            c = int(np.argmax(ties & (rank == rr % k)))
            chosen[i] = c
            req_c[c] += pb.req[i]
            nz_c[c] += pb.nonzero[i]
            cnt_c[c] += 1
            rr += 1
            if collect_scores:
                d_cparts[i] = parts[:, c]
        elif collect_scores:
            # the device kernel gathers column `safe`=0 for unplaced
            # pods; mirror it for bitwise parity
            d_cparts[i] = parts[:, 0]

    masks[res_i] = dyn_fits
    if has_ts:
        masks[ts_i] = ts_masks
    if has_ipa:
        masks[ipa_i] = ipa_masks
    prefix_ok = np.cumprod(masks.astype(np.int8), axis=0).astype(bool)
    first = np.concatenate(
        [np.ones((1,) + masks.shape[1:], bool), prefix_ok[:-1]], axis=0)
    first_fail = ~masks & first & nt.valid[None, None, :]
    fail_counts = np.sum(first_fail.astype(np.int32), axis=-1)
    deco = (ScoreDeco(chosen_parts=d_cparts, top_idx=d_tidx,
                      top_vals=d_tvals, top_parts=d_tparts)
            if collect_scores else None)
    # numeric-integrity sentinel, bitwise with the device kernel
    # (ops/kernel.py WaveResult.finite): the pod's own inputs plus its
    # winning score — np.max propagates NaN exactly like jnp.max
    finite = (np.all(np.isfinite(pb.req), axis=1)
              & np.all(np.isfinite(pb.nonzero), axis=1)
              & np.isfinite(best_s))
    res = WaveResult(chosen=chosen, score=best_s, feasible_count=feas_cnt,
                     fail_counts=fail_counts, masks=masks,
                     rr_end=np.int32(rr), deco=deco, finite=finite)
    return res, (req_c, nz_c, cnt_c)


def schedule_gang_host(nt, pm, tt, pb, extra_mask, rr_start: int,
                       extra_scores, need: int, *, weights: Weights,
                       num_zones: int, num_label_values: int = 64,
                       has_ipa: bool = False, weight_vec=None):
    """All-or-nothing count feasibility: the ops/gang.py wrapper over the
    host wave. Unless the greedy commit placed >= `need` members, every
    placement is discarded and the round-robin counter rewinds — the
    same no-partial-gang guarantee the device program gives, restored to
    degraded mode."""
    from .gang import GangResult

    res, _usage = schedule_wave_host(
        nt, pm, tt, pb, extra_mask, rr_start, extra_scores,
        weights=weights, num_zones=num_zones,
        num_label_values=num_label_values, has_ipa=has_ipa,
        weight_vec=weight_vec)
    placed = int(np.sum(res.chosen >= 0))
    ok = placed >= int(need)
    chosen = res.chosen if ok else np.full_like(res.chosen, -1)
    rr_end = res.rr_end if ok else np.int32(rr_start)
    return GangResult(ok=np.bool_(ok), chosen=chosen,
                      placed=np.int32(placed), fail_counts=res.fail_counts,
                      masks=res.masks, rr_end=rr_end, finite=res.finite)


# -- cluster-state telemetry (ops/telemetry.py twin) --------------------------


def cluster_telemetry_host(nt, *, num_zones: int) -> np.ndarray:
    """Host twin of ops/telemetry.py cluster_telemetry over the
    snapshot's host planes: the port's `_telemetry_body` on CPU tensors
    made from the numpy planes without a copy, so the breaker-open path
    never dispatches to the card. Its f32 sums go through the fixed
    halving tree, so the packed vector is bit-equal to the card's and to
    both JAX forms (tests/test_torch_telemetry.py)."""
    import torch

    from .telemetry import _telemetry_body, shape_requests

    R = nt.alloc.shape[1]
    ntc = enc.NodeTensors(*[None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)) for a in nt])
    return _telemetry_body(ntc, torch.from_numpy(shape_requests(R)),
                           num_zones).numpy()


# -- preemption what-if (ops/preempt.py twin) ---------------------------------


def victim_levels(ep_prio, live, num_levels: int) -> Optional[List[int]]:
    """Candidate priority thresholds from the live existing-pod rows —
    the exact level list Scheduler._preempt_chunk builds for the device
    program (distinct priorities + 1, highest always kept, padded)."""
    prios = sorted({int(x) + 1 for x in np.asarray(ep_prio)[np.asarray(live)]})
    if len(prios) > num_levels:
        prios = prios[:num_levels - 1] + [prios[-1]]
    if not prios:
        return None
    return prios + [prios[-1]] * (num_levels - len(prios))


def preemption_stats_host(nt, pm, pb, levels, *, num_levels: int,
                          gang_w=None) -> np.ndarray:
    """Numpy twin of ops/preempt.py preemption_stats: one packed i32
    [5, P, N] plane stack (ok, victim count, priority max, f32 priority
    sum bitcast, f32 gang-disruption sum bitcast) — byte-compatible with
    the device output, so ops.preempt.PreemptStats wraps either.

    Classes are deduplicated by threshold value: pods stamped from one
    controller share a priority, so each level computes its segment sums
    once, not per pod."""
    levels = np.asarray(levels, np.int32)
    P = pb.req.shape[0]
    N = nt.valid.shape[0]
    R = nt.alloc.shape[1]
    is_core = np.arange(R) < enc.RES_FIXED

    masks = static_predicate_masks(nt, pb, is_core)
    masks[enc.PRED_IDX["PodFitsResources"]] = True
    masks[enc.PRED_IDX["PodFitsHostPorts"]] = True
    static_ok = np.all(masks, axis=0)
    static_ok = static_ok & nt.valid[None, :] & pb.valid[:, None]

    live = pm.valid & pm.alive
    node_ids = np.clip(pm.node, 0, None)
    prio_f = pm.prio.astype(np.float64)

    ok = np.zeros((P, N), bool)
    victims = np.zeros((P, N), np.int32)
    prio_sum = np.zeros((P, N), np.float32)
    prio_max = np.full((P, N), NEG, np.int32)
    gang_viol = np.zeros((P, N), np.float32)

    def seg(weights):
        return np.bincount(node_ids, weights=weights, minlength=N)[:N]

    for l in range(num_levels):
        thresh = np.minimum(levels[l], pb.prio)  # [P]
        for t in np.unique(thresh):
            sel = np.flatnonzero(thresh == t)
            w_row = (live & (pm.prio < t)).astype(np.float64)
            rem_cnt = seg(w_row)
            rem_req = np.stack(
                [seg(w_row * pm.req[:, r]) for r in range(R)],
                axis=1).astype(np.float32)  # [N, R]
            rem_psum = seg(w_row * prio_f).astype(np.float32)
            rem_pmax = np.full((N,), INT32_MIN, np.int32)
            np.maximum.at(rem_pmax, node_ids,
                          np.where(w_row > 0, pm.prio, NEG).astype(np.int32))
            if gang_w is not None:
                rem_gang = seg(w_row * np.asarray(gang_w,
                                                  np.float64)).astype(np.float32)
            else:
                rem_gang = np.zeros((N,), np.float32)
            used = (nt.requested - rem_req)[None, :, :] + pb.req[sel][:, None, :]
            col_ok = used <= nt.alloc[None]  # [S, N, R]
            check = is_core[None, None, :] | (pb.req[sel][:, None, :] > 0)
            fits = np.all(col_ok | ~check, axis=-1)
            fits &= (nt.pod_count[None] - rem_cnt.astype(np.int32)[None] + 1
                     <= nt.allowed_pods[None])
            feasible = fits & static_ok[sel]
            sub_ok = ok[sel]
            take = feasible & ~sub_ok
            ok[sel] = sub_ok | feasible
            victims[sel] = np.where(take, rem_cnt.astype(np.int32)[None],
                                    victims[sel])
            prio_sum[sel] = np.where(take, rem_psum[None], prio_sum[sel])
            prio_max[sel] = np.where(take, rem_pmax[None], prio_max[sel])
            gang_viol[sel] = np.where(take, rem_gang[None], gang_viol[sel])

    return np.stack([
        ok.astype(np.int32),
        victims,
        prio_max,
        np.ascontiguousarray(prio_sum).view(np.int32),
        np.ascontiguousarray(gang_viol).view(np.int32),
    ])
