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

Inter-pod affinity (`has_ipa`, ops/affinity.py) and topology spread
(`has_ts`, ops/topology.py) add per-wave statics and a step each to the
per-pod loop, which sees the wave's earlier placements through its
`placed` tensor. Every op follows the JAX kernel's f32 op order (see
ops/scores.py) so the outputs are bit-equal to it.

With `collect_scores` (the scheduler sets it exactly when tracing is
on), the loop also keeps each pod's per-priority score planes long
enough to gather the chosen node's raw parts and the top
min(SCORE_TOPK, N) nodes by total, with their totals and parts
(`ScoreDeco`). The planes a 0 weight leaves out of the total are
computed too, so a priority that did not move the decision still
explains it; the total is the same expression either way, so the
placements do not change.

Every entry point (`schedule_wave`, `schedule_round`, ops/gang.py
`schedule_gang`, ops/preempt.py `preemption_stats`, ops/telemetry.py
`cluster_telemetry`) runs through `record_dispatch`, which counts its
dispatches by shape bucket in the metrics registered by
`set_telemetry`, as the JAX package counts its jit cache hits and
misses, and which is the seam of the dispatch watchdog (`set_watchdog`)
and of the `kernel.hang`, `device.lost` and `device.oom` fault points.
The wave, the
round and the gang fire `kernel.wave`, `kernel.round` and `kernel.gang`
at their entry, as the JAX entry points do.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from ..utils import faultpoints, tracing
from . import encoding as enc
from .affinity import IncomingStatics, gather_domains, incoming_statics
from .filters import resource_fit, static_predicate_masks
from .scores import (
    SCORE_STACK,
    SCORE_TOPK,
    W_AFFINITY,
    W_AVOID,
    W_BALANCED,
    W_COMPACT,
    W_IMAGE,
    W_INTERPOD,
    W_LEAST,
    W_MOST,
    W_SPREAD,
    W_TAINT,
    W_TOPO_SPREAD,
    ScoreDeco,
    balanced_allocation,
    floor_div,
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
from .topology import TopoStatics, topo_statics


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
    # per-priority decomposition of the decision (collect_scores only;
    # None otherwise)
    deco: Optional[ScoreDeco] = None
    # numeric-integrity sentinel: bool [P] — False where the pod's own
    # inputs (req/nonzero) or its winning score are non-finite (a NaN
    # req poisons the usage carry for every later pod in the wave)
    finite: Optional[torch.Tensor] = None


# -- dispatch accounting, the watchdog seam and the fault seams --------------
#
# The scheduler registers its Metrics here (set_telemetry) so every
# dispatch is counted by program and shape bucket, as the JAX package
# counts its jit program-cache hits and misses
# (kubernetes_tpu/ops/kernel.py:143-290). Process-global like the JAX
# hook; the last scheduler built owns the series. A "miss" is the first
# dispatch at a bucket in this process: no program is compiled here, so
# its seconds are the host's time to issue the call, plus the kernels'
# first build on the card.
_TELEMETRY = None
_COMPILED: set = set()
# Device-dispatch watchdog (utils/watchdog.py), registered by the
# scheduler like the telemetry hook (set_watchdog; the last scheduler
# built owns it, None disables): every dispatch through record_dispatch
# then runs under a deadline, and one that overruns it is abandoned with
# DispatchTimeout.
_WATCHDOG = None
# The device names the scheduler dispatches to (set_devices; () = none
# registered). The `device.lost` fault point receives them as its
# payload, and a failed dispatch is attributed to one of them for the
# scheduling_errors_total{stage=dispatch, device=...} series.
_DEVICES: tuple = ()


def set_telemetry(metrics) -> None:
    global _TELEMETRY
    _TELEMETRY = metrics


def set_watchdog(watchdog) -> None:
    global _WATCHDOG
    _WATCHDOG = watchdog


def set_devices(devices) -> None:
    """Register the device names the scheduler dispatches to (the port
    has no mesh: the one active device; ()/None clears)."""
    global _DEVICES
    _DEVICES = tuple(str(d) for d in (devices or ()))


def _attribute_device(exc: BaseException) -> str:
    """Culprit device name of a failed dispatch: the exception carries
    one (DeviceLost.device), or its text names exactly one registered
    device as an exact token (a name followed by another digit is a
    different device's); 'unknown' otherwise
    (kubernetes_tpu/ops/kernel.py:161)."""
    dev = getattr(exc, "device", None)
    if isinstance(dev, str) and dev in _DEVICES:
        return dev
    text = str(exc)
    hits = []
    for d in _DEVICES:
        if not d:
            continue
        idx = text.find(d)
        while idx != -1:
            end = idx + len(d)
            if end == len(text) or not text[end].isdigit():
                hits.append(d)
                break
            idx = text.find(d, idx + 1)
    return hits[0] if len(hits) == 1 else "unknown"


def _count_dispatch_error(tel, exc: BaseException) -> None:
    """One failed dispatch on scheduling_errors_total, its device label
    bounded to the registered devices and 'unknown'."""
    if tel is None:
        return
    from ..utils.metrics import bounded_label

    tel.scheduling_errors.labels(
        stage="dispatch",
        device=bounded_label(_attribute_device(exc), _DEVICES,
                             other="unknown")).inc()


def dispatch_bucket(nt, pm, tt, kw, lead=()) -> tuple:
    """The shape bucket of a dispatch: the JAX bucket tuple
    (kubernetes_tpu/ops/kernel.py:214) — the caller's wave/pod rows
    (`lead`), node rows, pod-matrix and term-table caps, one device (the
    port has no mesh), num_label_values, num_zones and the formulation
    flags; weight values are left out, the weight_vec's presence is in.
    `use_pallas` is 1 on the card, where the taint/port kernel launches,
    and 0 on the CPU (the JAX package's pallas_default() there)."""
    return tuple(lead) + (
        nt.valid.shape[0], pm.node.shape[0], tt.node.shape[0], 1,
        int(kw.get("num_label_values", 64)), int(kw.get("num_zones", 0)),
        int(bool(kw.get("has_ipa", False))),
        int(bool(kw.get("has_ts", False))),
        int(bool(kw.get("use_pallas", False))),
        int(bool(kw.get("collect_scores", False))),
        int(kw.get("weight_vec") is not None))


def record_dispatch(program: str, bucket_key: tuple, fn):
    """Run one dispatch (kubernetes_tpu/ops/kernel.py:238-300).

    The `kernel.hang`, `device.lost` and `device.oom` fault points fire
    inside the guarded dispatch, once each a dispatch (`device.oom` is the
    capacity seam: the scheduler compacts, halves the wave or takes the
    twin, and never charges a device). With a watchdog registered
    (set_watchdog) the dispatch runs on its worker thread under the
    deadline and raises DispatchTimeout on abandonment; a bucket not
    seen before in this process gets the compile-scaled budget. With
    metrics registered (set_telemetry) the dispatch is counted as a hit
    or a miss of its shape bucket (`device_jit_events`), a miss's
    seconds observed (`device_jit_compile_seconds`, and a `jit_compile`
    tracing event), and a failure counted on
    scheduling_errors{stage="dispatch", device=...} before it raises."""
    tel = _TELEMETRY
    wd = _WATCHDOG
    if tel is None and (wd is None or not wd.armed()):
        # unarmed: the fault seams still fire, nothing else is paid
        faultpoints.fire("kernel.hang")
        faultpoints.fire("device.lost", payload=_DEVICES or None)
        faultpoints.fire("device.oom", payload=_DEVICES or None)
        return fn()
    key = (program,) + bucket_key
    miss = key not in _COMPILED
    inner = fn

    def dispatch():
        faultpoints.fire("kernel.hang")
        faultpoints.fire("device.lost", payload=_DEVICES or None)
        faultpoints.fire("device.oom", payload=_DEVICES or None)
        return inner()

    if wd is not None and wd.armed():
        fn = lambda: wd.run(dispatch, program=program, warm=not miss)
    else:
        fn = dispatch
    if tel is None:
        out = fn()
        _COMPILED.add(key)  # warm-tracking feeds the watchdog's scaling
        return out
    t0 = time.monotonic()
    try:
        out = fn()
    except Exception as e:
        _count_dispatch_error(tel, e)
        raise
    _COMPILED.add(key)
    bucket = "x".join(str(d) for d in bucket_key)
    tel.device_jit_events.labels(
        program=program, bucket=bucket,
        event="miss" if miss else "hit").inc()
    if miss:
        dt = time.monotonic() - t0
        tel.device_jit_compile_seconds.observe(dt)
        tracing.event("jit_compile", program=program, bucket=bucket,
                      seconds=round(dt, 3))
    return out


def top_k_first(sm: torch.Tensor, k: int):
    """The k largest entries of sm [N] in lax.top_k's order: descending
    in IEEE total order (+NaN above +inf, -0.0 below +0.0, -NaN below
    -inf), the lower index first among equal values. Returns (values
    f32 [k], indices i32 [k]).

    torch.topk keeps no order among equal values and torch.sort orders
    neither NaNs by sign nor -0.0 against +0.0, so each value is mapped
    to an int32 key monotone in the total order (a negative float's low
    31 bits flipped) and the key is widened to a unique int64 whose low
    32 bits rank the lower index higher; topk over unique keys has one
    answer, and it reads no value on the host."""
    bits = sm.view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    n = sm.shape[0]
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=sm.device)
    comp = key.to(torch.int64) * 4294967296 + rev
    idx = torch.topk(comp, k).indices
    return sm[idx], idx.to(torch.int32)


def _ipa_step(ipa: IncomingStatics, pb: enc.PodBatch, i: int, active,
              safe_pl):
    """MatchInterPodAffinity of wave pod i against the resident pods
    (the statics) and the pods placed earlier in this wave (`active`,
    `safe_pl`: placed mask and clamped node of every wave pod). bool [N].
    Every per-pod flag stays a device tensor: no host read."""
    dra_row = ipa.node_dom_ra[i]
    drn_row = ipa.node_dom_rn[i]
    # incoming required affinity vs pods placed earlier this wave
    pl_dom = dra_row[safe_pl]  # [P] placement domain under MY aff tk
    src = ipa.wm_aff[i] & active & (pl_dom > 0)
    wave_aff = ((src[:, None] & (pl_dom[:, None] == dra_row[None, :]))
                .any(dim=0) & (dra_row > 0))
    # bootstrap existence check is topology-independent
    # (predicates.go:1410: matchingPods counts props matches on ANY
    # node, labeled or not)
    any_aff = ipa.any_aff[i] | (ipa.wm_aff[i] & active).any()
    ok_aff = ipa.ok_aff[i] | wave_aff | (~any_aff & pb.ra_self[i])
    ok_aff = torch.where(pb.ra_has[i], ok_aff, True)
    # incoming required anti-affinity vs wave placements
    pl_dom_n = drn_row[safe_pl]
    srcn = ipa.wm_anti[i] & active & (pl_dom_n > 0)
    wave_anti = ((srcn[:, None] & (pl_dom_n[:, None] == drn_row[None, :]))
                 .any(dim=0) & (drn_row > 0))
    ok_anti = ~(pb.rn_has[i] & (ipa.blocked_anti[i] | wave_anti))
    # symmetry: wave pod j's required anti terms vs me, under j's tk
    pd_sym = ipa.node_dom_rn.gather(1, safe_pl[:, None])[:, 0]  # [P]
    srcs = ipa.wm_anti[:, i] & active & (pd_sym > 0)
    sym_wave = (srcs[:, None] & (pd_sym[:, None] == ipa.node_dom_rn)
                & (ipa.node_dom_rn > 0)).any(dim=0)
    return ~(ipa.sym_blocked[i] | sym_wave) & ok_aff & ok_anti


def _ts_step(topo: TopoStatics, pb: enc.PodBatch, i: int, active, safe_pl,
             seg_dom, cnt_pad):
    """PodTopologySpread of wave pod i against the resident pods and this
    wave's earlier placements (upstream's assume semantics). Returns
    (ts_ok bool [N], cnt_dyn f32 [TS, LV], cnt_at f32 [TS, N],
    anyp bool [TS]).

    seg_dom: i32 [TS, N] topo.node_dom[i] with ids >= LV sent to a dump
    column LV; cnt_pad: f32 [TS, LV + 1] topo.counts[i] with that column
    appended. The placements are added to the resident counts by one
    scatter of 0/1 values — the JAX kernel's one-hot sum, exact in any
    order — and the dump column is cut off, as the one-hot sum drops
    such ids."""
    tsv, tsh, tss = pb.ts_valid[i], pb.ts_hard[i], pb.ts_skew[i]
    tdom = topo.node_dom[i]  # [TS, N]
    LV = topo.counts.shape[2]
    tpres = topo.present[i]  # [TS, LV]
    pl_seg = seg_dom[:, safe_pl]  # [TS, P] placement domains
    addm = topo.wm[i] & active[None, :] & (pl_seg > 0)
    cnt_dyn = cnt_pad.scatter_add(1, pl_seg.long(),
                                  addm.to(torch.float32))[:, :LV]
    cnt_at = gather_domains(cnt_dyn, tdom)  # [TS, N]
    key_ok = tdom > 0  # node has the constraint's topology key
    anyp = tpres.any(dim=1)  # [TS]
    minm = torch.where(
        anyp, torch.where(tpres, cnt_dyn, float("inf")).amin(dim=1), 0.0)
    # skew = count-if-placed-here minus global min; self counts only
    # when the pod matches its own selector (selfMatchNum)
    cand = cnt_at + topo.selfm[i][:, None].to(torch.float32)
    hard = (tsv & tsh)[:, None]
    ok_rows = torch.where(
        hard, key_ok & ((cand - minm[:, None]) <= tss[:, None]), True)
    return ok_rows.all(dim=0), cnt_dyn, cnt_at, anyp


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

    has_ipa / has_ts: compute the inter-pod affinity / topology spread
    statics and run their steps for every pod of the wave, as the JAX
    kernel's static flags compile them in.

    weight_vec: optional f32 [S] SCORE_STACK-aligned weight vector on the
    device; it supplies the multipliers of the weighted sum. The static
    `weights` gates which score planes are computed. None uses
    stack_weights(weights).

    collect_scores: also return, per pod, the SCORE_STACK-ordered raw
    planes at the chosen node (column max(chosen, 0): an unplaced pod
    reports column 0) and the top min(SCORE_TOPK, N) nodes by `sm` with
    their totals and raw planes (WaveResult.deco), as the JAX kernel does
    (kernel.py:405-415, :595-612). The planes are computed whatever
    their weight; the total gains no term."""
    dev = nt.valid.device
    N = nt.valid.shape[0]
    P = pb.req.shape[0]
    R = nt.alloc.shape[1]
    is_core = torch.arange(R, device=dev) < enc.RES_FIXED
    masks = static_predicate_masks(nt, pb, is_core, taint_ports)
    # placeholder rows for the loop-filled predicates (PodTopologySpread,
    # MatchInterPodAffinity), in DEVICE_PREDICATES order
    placeholder = torch.ones((1, P, N), dtype=torch.bool, device=dev)
    masks = torch.cat([masks, placeholder, placeholder, extra_mask[None]],
                      dim=0)
    res_i = enc.PRED_IDX["PodFitsResources"]
    ipa_i = enc.PRED_IDX["MatchInterPodAffinity"]
    ts_i = enc.PRED_IDX["PodTopologySpread"]
    static_nonres = torch.cat([masks[:res_i], masks[res_i + 1:]]).all(dim=0)
    alloc2 = nt.alloc[:, :2]
    ipa = (incoming_statics(nt, pm, tt, pb, num_label_values,
                            weights.hard_pod_affinity)
           if has_ipa else None)
    if has_ts:
        topo = topo_statics(nt, pm, pb, num_label_values)
        seg_dom = torch.where(topo.node_dom < num_label_values,
                              topo.node_dom, num_label_values)
        cnt_pad = torch.cat([topo.counts, topo.counts.new_zeros(
            topo.counts.shape[:2] + (1,))], dim=2)

    w = weights
    collect = collect_scores
    wv = (weight_vec if weight_vec is not None
          else torch.from_numpy(stack_weights(w)).to(dev))
    # raw planes also feed the decomposition: under collect_scores they
    # are computed even at weight 0
    aff_raw = (node_affinity_raw(nt, pb) if w.node_affinity or collect
               else torch.zeros((P, N), dtype=torch.float32, device=dev))
    taint_raw = (taint_intolerable_raw(nt, pb)
                 if w.taint_toleration or collect
                 else torch.zeros((P, N), dtype=torch.float32, device=dev))
    spread_cnt = (spread_counts(pm, pb, N) if w.selector_spread or collect
                  else torch.zeros((P, N), dtype=torch.int32, device=dev))
    static_score = torch.zeros((P, N), dtype=torch.float32, device=dev)
    if w.image_locality:
        static_score = static_score + wv[W_IMAGE] * image_locality(nt, pb)
    if w.prefer_avoid:
        static_score = static_score + wv[W_AVOID] * prefer_avoid(nt, pb)
    if extra_scores is not None:
        static_score = static_score + extra_scores
    if collect:
        # the raw planes the total takes pre-weighted, never added again
        avoid_full = prefer_avoid(nt, pb)
        img_full = image_locality(nt, pb)
        extra_full = (extra_scores if extra_scores is not None
                      else torch.zeros((P, N), dtype=torch.float32,
                                       device=dev))
        kk = min(SCORE_TOPK, N)
        cparts_l, tidx_l, tvals_l, tparts_l = [], [], [], []

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
    # node of each wave pod placed so far (-1: not placed), written in
    # place as the loop commits
    placed = torch.full((P,), -1, dtype=torch.int32, device=dev)

    chosen_l, best_l, fits_l, feas_l, ipa_l, ts_l = [], [], [], [], [], []
    for i in range(P):
        preq, pnz = pb.req[i], pb.nonzero[i]
        fits = resource_fit(nt.alloc, nt.allowed_pods, req_c, cnt_c,
                            preq[None, :], is_core)[0]  # [N]
        feasible = static_nonres[i] & fits & nt.valid & pb.valid[i]
        if has_ipa or has_ts:
            active = placed >= 0
            safe_pl = placed.clamp(min=0).long()
        if has_ipa:
            ipa_ok = _ipa_step(ipa, pb, i, active, safe_pl)
            feasible = feasible & ipa_ok
            ipa_l.append(ipa_ok)
        if has_ts:
            ts_ok, cnt_dyn, cnt_at, anyp = _ts_step(
                topo, pb, i, active, safe_pl, seg_dom[i], cnt_pad[i])
            feasible = feasible & ts_ok
            ts_l.append(ts_ok)
        # the weighted sum, plane by plane in the JAX kernel's order
        # (kernel.py:504-576); each `total + wv * plane` is two ops
        # each plane is computed when its weight or collect_scores asks
        # for it, and added only when its weight does
        total = static_score[i]
        fscore = aff_n = taint_n = spread_n = lr = ba = mr = None
        ts_n = compact_n = None
        if has_ipa and (w.interpod or collect):
            counts_row = ipa.counts[i]
            cmasked = torch.where(feasible, counts_row, 0.0)
            cmin = torch.clamp(cmasked.min(), max=0.0)
            cmax = torch.clamp(cmasked.max(), min=0.0)
            crange = cmax - cmin
            # a tensor divisor: IEEE division on every device
            fscore = torch.where(
                crange > 0, floor_div(10.0 * (counts_row - cmin) / crange),
                0.0)
        if has_ipa and w.interpod:
            total = total + wv[W_INTERPOD] * fscore
        if w.node_affinity or collect:
            aff_n = normalize_reduce(aff_raw[i], feasible, False)
        if w.node_affinity:
            total = total + wv[W_AFFINITY] * aff_n
        if w.taint_toleration or collect:
            taint_n = normalize_reduce(taint_raw[i], feasible, True)
        if w.taint_toleration:
            total = total + wv[W_TAINT] * taint_n
        if w.selector_spread or collect:
            spread_n = spread_reduce(spread_cnt[i], feasible, nt.zone_id,
                                     num_zones)
        if w.selector_spread:
            total = total + wv[W_SPREAD] * spread_n
        if w.least_requested or collect:
            lr = least_requested(nz_c, alloc2, pnz)
        if w.least_requested:
            total = total + wv[W_LEAST] * lr
        if w.balanced or collect:
            ba = balanced_allocation(nz_c, alloc2, pnz)
        if w.balanced:
            total = total + wv[W_BALANCED] * ba
        if w.most_requested or collect:
            mr = most_requested(nz_c, alloc2, pnz)
        if w.most_requested:
            total = total + wv[W_MOST] * mr
        if has_ts and (w.topology_spread or collect):
            # raw spread score: headroom below the fullest domain — a
            # node in a less-crowded domain scores higher; key-less
            # nodes score 0. The TS-axis sum adds integer-valued f32:
            # exact in any order.
            maxm = torch.where(
                anyp, torch.where(topo.present[i], cnt_dyn,
                                  float("-inf")).amax(dim=1), 0.0)
            ts_raw = torch.where(
                (topo.node_dom[i] > 0) & pb.ts_valid[i][:, None],
                torch.clamp(maxm[:, None] - cnt_at, min=0.0), 0.0).sum(dim=0)
            ts_n = normalize_reduce(ts_raw, feasible, False)
        if has_ts and w.topology_spread:
            total = total + wv[W_TOPO_SPREAD] * ts_n
        if w.topology_compactness or collect:
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
        if w.topology_compactness:
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
        if has_ipa or has_ts:
            placed[i] = chosen
        if collect:
            # SCORE_STACK-ordered raw planes [S, N]: the chosen node's
            # column and the top-k nodes' columns leave the loop
            zr = torch.zeros_like(total)
            parts = torch.stack([
                lr, ba, mr, aff_n, taint_n, spread_n, avoid_full[i],
                img_full[i], fscore if fscore is not None else zr,
                ts_n if ts_n is not None else zr,
                compact_n if compact_n is not None else zr, extra_full[i]])
            top_vals, top_idx = top_k_first(sm, kk)
            cparts_l.append(parts.index_select(1, safe)[:, 0])
            tidx_l.append(top_idx)
            tvals_l.append(top_vals)
            tparts_l.append(parts.index_select(1, top_idx.long()))
        chosen_l.append(chosen)
        best_l.append(best)
        fits_l.append(fits)
        feas_l.append(feasible.sum(dtype=torch.int32))

    chosen = torch.stack(chosen_l)
    best = torch.stack(best_l)
    masks[res_i] = torch.stack(fits_l)
    if has_ts:
        masks[ts_i] = torch.stack(ts_l)
    if has_ipa:
        masks[ipa_i] = torch.stack(ipa_l)
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
    deco = None
    if collect:
        deco = ScoreDeco(chosen_parts=torch.stack(cparts_l),
                         top_idx=torch.stack(tidx_l),
                         top_vals=torch.stack(tvals_l),
                         top_parts=torch.stack(tparts_l))
    res = WaveResult(chosen=chosen, score=best,
                     feasible_count=torch.stack(feas_l),
                     fail_counts=fail_counts, masks=masks, rr_end=rr,
                     deco=deco, finite=finite)
    return res, (req_c, nz_c, cnt_c)


def schedule_wave(nt: enc.NodeTensors, pm: enc.PodMatrix, tt: enc.TermTable,
                  pb: enc.PodBatch, extra_mask, rr_start, extra_scores=None,
                  *, weights: Weights, num_zones: int,
                  num_label_values: int = 64, has_ipa: bool = False,
                  has_ts: Optional[bool] = None,
                  collect_scores: bool = False,
                  weight_vec=None, account: bool = True) -> WaveResult:
    """One wave. extra_mask: bool [P, N] — host-evaluated predicates,
    appended to the mask stack as a final "HostPlugins" pseudo-predicate.
    extra_scores: optional f32 [P, N] — host-evaluated score
    contributions, pre-multiplied by their weights.

    has_ts defaults to whether any pod carries a topology spread
    constraint, as the JAX entry point derives it. collect_scores adds
    the decomposition (WaveResult.deco, [P, ...] planes). Counted as a
    "wave" dispatch (record_dispatch), after the `kernel.wave` fault
    point fires, unless account is False: the scheduler's exact shadow
    replays, which the JAX package runs on its numpy twin outside its
    dispatch counts and its fault seams."""
    if not account:
        return _wave_body(nt, pm, tt, pb, extra_mask, rr_start, extra_scores,
                          weights, num_zones, num_label_values, has_ipa,
                          collect_scores=collect_scores,
                          weight_vec=weight_vec,
                          has_ts=(bool(pb.ts_valid.any()) if has_ts is None
                                  else has_ts))[0]
    faultpoints.fire("kernel.wave")
    if has_ts is None:
        has_ts = bool(pb.ts_valid.any())

    def run():
        return _wave_body(nt, pm, tt, pb, extra_mask, rr_start, extra_scores,
                          weights, num_zones, num_label_values, has_ipa,
                          collect_scores=collect_scores,
                          weight_vec=weight_vec, has_ts=has_ts)[0]

    kw = dict(num_zones=num_zones, num_label_values=num_label_values,
              has_ipa=has_ipa, has_ts=has_ts, use_pallas=nt.valid.is_cuda,
              collect_scores=collect_scores, weight_vec=weight_vec)
    bucket = dispatch_bucket(nt, pm, tt, kw, lead=(pb.req.shape[0],))
    return record_dispatch("wave", bucket, run)


def _stage_placements(pm: enc.PodMatrix, tt: enc.TermTable, chosen,
                      pm_rows, term_rows):
    """Flip this wave's placements into the pod matrix / term table ON
    DEVICE so the next chained wave sees them (spreading counts read pm;
    required (anti)affinity reads tt). Returns new tuples; the inputs are
    not written.

    Pad/unplaced entries go to one extra dump row past the end that is
    cut off afterwards — the JAX kernel's scatter mode="drop". Clipping
    them to row 0 instead would race real updates to row 0, and torch
    indexing raises on an out-of-range index. The valid flags are set
    with index_fill_: an index assignment of a Python scalar copies it
    to the card first, which blocks the host until the queued waves
    have run."""
    ok = (chosen >= 0) & (pm_rows >= 0)
    safe_choice = chosen.clamp(min=0)
    M = pm.node.shape[0]
    target = torch.where(ok, pm_rows, M).long()
    node = torch.cat([pm.node, pm.node.new_zeros(1)])
    node[target] = safe_choice
    valid = torch.cat([pm.valid, pm.valid.new_zeros(1)])
    valid.index_fill_(0, target, True)
    pm2 = pm._replace(node=node[:M], valid=valid[:M])
    TPP = term_rows.shape[1]
    E = tt.node.shape[0]
    tok = ok[:, None] & (term_rows >= 0)
    ttarget = torch.where(tok, term_rows, E).reshape(-1).long()
    tchoice = safe_choice.repeat_interleave(TPP)
    tnode = torch.cat([tt.node, tt.node.new_zeros(1)])
    tnode[ttarget] = tchoice
    tvalid = torch.cat([tt.valid, tt.valid.new_zeros(1)])
    tvalid.index_fill_(0, ttarget, True)
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

    has_ipa: run every wave with the inter-pod affinity statics and step
    (the scheduler resolves it from the snapshot's terms and the round's
    batches). has_ts defaults to whether any pod of the round carries a
    spread constraint: one host read, as the JAX entry point derives it
    from its numpy inputs.

    Returns (chosen [W, P], fail_counts [W, Q, P], usage', rr_end, deco,
    finite [W, P]); deco is a ScoreDeco of [W, P, ...] planes with
    collect_scores, pad waves carrying zeros and top_vals of -1 as in
    the JAX round, and None otherwise. Counted as a "round" dispatch
    (record_dispatch), after the `kernel.round` fault point fires."""
    faultpoints.fire("kernel.round")
    if has_ts is None:
        has_ts = bool(pbs.ts_valid.any())
    kw = dict(num_zones=num_zones, num_label_values=num_label_values,
              has_ipa=has_ipa, has_ts=has_ts, use_pallas=nt.valid.is_cuda,
              collect_scores=collect_scores, weight_vec=weight_vec)
    bucket = dispatch_bucket(nt, pm, tt, kw,
                             lead=(pbs.req.shape[0], pbs.req.shape[1]))
    return record_dispatch("round", bucket, lambda: _schedule_round(
        nt, pm, tt, pbs, usage, rr_start, pm_rows, term_rows,
        weights=weights, num_zones=num_zones,
        num_label_values=num_label_values, has_ipa=has_ipa, has_ts=has_ts,
        collect_scores=collect_scores, weight_vec=weight_vec))


def _schedule_round(nt, pm, tt, pbs, usage, rr_start, pm_rows, term_rows, *,
                    weights: Weights, num_zones: int, num_label_values: int,
                    has_ipa: bool, has_ts: bool, collect_scores: bool,
                    weight_vec):
    dev = nt.valid.device
    W = pbs.req.shape[0]
    P = pbs.req.shape[1]
    N = nt.valid.shape[0]
    Q = len(enc.MASK_STACK_NAMES)
    S = len(SCORE_STACK)
    KK = min(SCORE_TOPK, N)
    ones = torch.ones((P, N), dtype=torch.bool, device=dev)
    active = pbs.valid.any(dim=1).tolist()
    n_live = max((wi + 1 for wi, a in enumerate(active) if a), default=0)
    if n_live:
        taints_all, ports_all = _flat_taint_ports(nt, pbs, n_live)

    pm_c, tt_c = pm, tt
    usage_c = tuple(usage)
    rr_c = torch.as_tensor(rr_start, dtype=torch.int32, device=dev)
    chosen_w, fail_w, finite_w, deco_w = [], [], [], []
    for wi in range(W):
        if not active[wi]:
            chosen_w.append(torch.full((P,), -1, dtype=torch.int32,
                                       device=dev))
            fail_w.append(torch.zeros((Q, P), dtype=torch.int32, device=dev))
            # pad waves schedule nothing: their sentinel rows are clean
            finite_w.append(torch.ones((P,), dtype=torch.bool, device=dev))
            if collect_scores:
                # top_vals at -1 read as infeasible to every consumer
                deco_w.append(ScoreDeco(
                    torch.zeros((P, S), dtype=torch.float32, device=dev),
                    torch.zeros((P, KK), dtype=torch.int32, device=dev),
                    torch.full((P, KK), -1.0, dtype=torch.float32,
                               device=dev),
                    torch.zeros((P, S, KK), dtype=torch.float32,
                                device=dev)))
            continue
        pb = enc.PodBatch(*[a[wi] for a in pbs])
        res, usage_c = _wave_body(
            nt, pm_c, tt_c, pb, ones, rr_c, None, weights, num_zones,
            num_label_values, has_ipa, usage_in=usage_c,
            taint_ports=(taints_all[wi], ports_all[wi]),
            collect_scores=collect_scores, weight_vec=weight_vec,
            has_ts=has_ts)
        pm_c, tt_c = _stage_placements(pm_c, tt_c, res.chosen, pm_rows[wi],
                                       term_rows[wi])
        rr_c = res.rr_end
        chosen_w.append(res.chosen)
        fail_w.append(res.fail_counts)
        finite_w.append(res.finite)
        if collect_scores:
            deco_w.append(res.deco)
    deco = (ScoreDeco(*[torch.stack(planes) for planes in zip(*deco_w)])
            if collect_scores else None)
    return (torch.stack(chosen_w), torch.stack(fail_w), usage_c, rr_c, deco,
            torch.stack(finite_w))
