"""Batched score (priority) kernels.

Each function reproduces one reference priority
(pkg/scheduler/algorithm/priorities/) as a dense computation. Scores are
integers 0..10 per the reference's Map/Reduce model
(generic_scheduler.go:544 PrioritizeNodes, :636 weighted sum); integer
divisions are emulated as float32 floor with a +1e-5 guard (all
quotients live in [0, 10], far above f32 resolution).

Normalizing reduces (NormalizeReduce, priorities/reduce.go:29) run over
the *feasible* node set of each pod — in the reference, Reduce sees only
nodes that passed filtering — so they execute inside the commit scan in
ops/kernel.py where per-pod feasibility is known.

Bit-equality with the JAX package rests on the f32 op order below: one
torch op per JAX op, in the same order, no fused multiply-add
(`addcmul`, `lerp`). A division by a constant goes through `_div`,
which divides by a tensor on the operand's device: PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal instead, which
can differ in the last bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import encoding as enc
from .encoding import NodeTensors, PodBatch, PodMatrix
from .selectors import eval_and_program

MAX_PRIORITY = 10.0
EPS = 1e-5

# --- score decomposition (the decision observatory) --------------------------
#
# With collect_scores on (tracing), the per-pod loop of ops/kernel.py
# keeps the per-priority planes alive long enough to gather, per pod, the
# raw contributions of the chosen node and of the top-k candidates by
# total score. Row order here is the contract every consumer of a weight
# vector or a decomposition relies on (ledger, decisions, tests).
SCORE_STACK = (
    "LeastRequested",
    "BalancedAllocation",
    "MostRequested",
    "NodeAffinity",
    "TaintToleration",
    "SelectorSpread",
    "PreferAvoid",
    "ImageLocality",
    "InterPodAffinity",
    "TopologySpread",  # PodTopologySpread skew score
    "TopologyCompactness",  # gang rack/superpod co-location + accel-gen steering
    "HostExtra",  # pre-weighted host/extender scores (weight renders as 1)
)

# candidates gathered per pod (the chosen node is gathered separately:
# round-robin tie-breaks can pick a node top-k would rank past K)
SCORE_TOPK = 4

# SCORE_STACK row -> ops/kernel.py Weights field. HostExtra rows arrive
# pre-weighted (weight renders as 1), so it maps to no field. The live
# WeightProfile machinery (sched/weights.py) uses this to gate planes and
# to build SCORE_STACK-aligned vectors from name-keyed weight tables.
WEIGHT_FIELDS = {
    "LeastRequested": "least_requested",
    "BalancedAllocation": "balanced",
    "MostRequested": "most_requested",
    "NodeAffinity": "node_affinity",
    "TaintToleration": "taint_toleration",
    "SelectorSpread": "selector_spread",
    "PreferAvoid": "prefer_avoid",
    "ImageLocality": "image_locality",
    "InterPodAffinity": "interpod",
    "TopologySpread": "topology_spread",
    "TopologyCompactness": "topology_compactness",
    "HostExtra": None,
}

# SCORE_STACK row indices, named
(W_LEAST, W_BALANCED, W_MOST, W_AFFINITY, W_TAINT, W_SPREAD, W_AVOID,
 W_IMAGE, W_INTERPOD, W_TOPO_SPREAD, W_COMPACT,
 W_EXTRA) = range(len(SCORE_STACK))


class ScoreDeco(NamedTuple):
    """Per-pod score decomposition planes fetched alongside a wave's
    placements (only when tracing): raw 0-10 per-priority scores — NOT
    weighted — for the chosen node and the top-k nodes by weighted
    total. Leading axes match the producing call ([P] per wave, [W, P]
    per round)."""

    chosen_parts: torch.Tensor  # f32 [..., S]     chosen node's raw scores
    top_idx: torch.Tensor  # i32 [..., K]     top-k node indices by total
    top_vals: torch.Tensor  # f32 [..., K]     their weighted totals (-1 infeasible)
    top_parts: torch.Tensor  # f32 [..., S, K]  their raw per-priority scores


def stack_weights(w) -> np.ndarray:
    """f32 [S] weight vector aligned with SCORE_STACK (HostExtra rows
    arrive pre-weighted, so weight 1)."""
    return np.asarray(
        [w.least_requested, w.balanced, w.most_requested, w.node_affinity,
         w.taint_toleration, w.selector_spread, w.prefer_avoid,
         w.image_locality, w.interpod, w.topology_spread,
         w.topology_compactness, 1.0], np.float32)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c in IEEE f32 division on every device (see module doc)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def floor_div(x):
    """Go integer-division / truncation emulation for non-negative values."""
    return torch.floor(x + EPS)


# --- resource allocation family (in-scan dynamic) ---------------------------


def least_requested(nz, alloc2, pod_nz):
    """[N] — reference least_requested.go:36 leastResourceScorer:
    (cpuScore + memScore) / 2, score_r = (cap - req) * 10 / cap.
    nz: f32 [N, 2] current nonzero-defaulted usage; alloc2: f32 [N, 2];
    pod_nz: f32 [2]."""
    r = nz + pod_nz[None, :]
    per = floor_div((alloc2 - r) * MAX_PRIORITY / alloc2.clamp(min=1.0))
    per = torch.where((alloc2 == 0) | (r > alloc2), 0.0, per)
    return floor_div(_div(per[:, 0] + per[:, 1], 2.0))


def most_requested(nz, alloc2, pod_nz):
    """[N] — reference most_requested.go mostResourceScorer."""
    r = nz + pod_nz[None, :]
    per = floor_div(r * MAX_PRIORITY / alloc2.clamp(min=1.0))
    per = torch.where((alloc2 == 0) | (r > alloc2), 0.0, per)
    return floor_div(_div(per[:, 0] + per[:, 1], 2.0))


def balanced_allocation(nz, alloc2, pod_nz):
    """[N] — reference balanced_resource_allocation.go:41
    balancedResourceScorer: 10 - |cpuFrac - memFrac| * 10 (truncated)."""
    r = nz + pod_nz[None, :]
    frac = torch.where(alloc2 == 0, 1.0, r / alloc2.clamp(min=1.0))
    diff = (frac[:, 0] - frac[:, 1]).abs()
    score = floor_div((1.0 - diff) * MAX_PRIORITY)
    return torch.where((frac >= 1.0).any(dim=1), 0.0, score)


# --- static [P, N] raw scores ------------------------------------------------


def node_affinity_raw(nt: NodeTensors, pb: PodBatch) -> torch.Tensor:
    """f32 [P, N] — sum of matched preferred-term weights (reference:
    priorities/node_affinity.go:34 CalculateNodeAffinityPriorityMap).
    Normalized per-pod in the scan (NormalizeReduce(10, false)). The
    term-axis sum adds integer-valued weights <= 100*PT: exact in f32 in
    any order."""
    N = nt.labels.shape[0]
    node_ids = torch.arange(N, dtype=torch.int32, device=nt.labels.device)
    term_match = eval_and_program(nt.labels, nt.label_nums, pb.pt_key,
                                  pb.pt_op, pb.pt_vals, pb.pt_num,
                                  node_ids)  # [P, PT, N]
    w = pb.pt_weight[:, :, None]
    return torch.where(term_match, w, 0.0).sum(dim=1)


def taint_intolerable_raw(nt: NodeTensors, pb: PodBatch) -> torch.Tensor:
    """f32 [P, N] — count of PreferNoSchedule taints not tolerated by the
    pod's PreferNoSchedule-eligible tolerations (reference:
    priorities/taint_toleration.go:55; tolerations with empty effect or
    PreferNoSchedule are eligible, :43). Normalized reversed in the scan."""
    P = pb.req.shape[0]
    N = nt.taint_key.shape[0]
    eligible = ((pb.tol_effect == 0)
                | (pb.tol_effect == enc.EFFECT_PREFER_NO_SCHEDULE))
    eligible &= pb.tol_op != enc.TOL_PAD
    count = torch.zeros((P, N), dtype=torch.float32,
                        device=nt.taint_key.device)
    for t in range(nt.taint_key.shape[1]):
        tk = nt.taint_key[:, t]
        tv = nt.taint_val[:, t]
        te = nt.taint_effect[:, t]
        relevant = te == enc.EFFECT_PREFER_NO_SCHEDULE  # [N]
        key_ok = ((pb.tol_key == 0)[:, :, None]
                  | (pb.tol_key[:, :, None] == tk[None, None, :]))
        val_ok = ((pb.tol_op == enc.TOL_EXISTS)[:, :, None]
                  | (pb.tol_val[:, :, None] == tv[None, None, :]))
        eff_ok = ((pb.tol_effect == 0)[:, :, None]
                  | (pb.tol_effect[:, :, None] == te[None, None, :]))
        tol = (eligible[:, :, None] & key_ok & val_ok & eff_ok).any(dim=1)
        count += (relevant[None, :] & ~tol).to(torch.float32)
    return count


def spread_counts(pm: PodMatrix, pb: PodBatch, num_nodes: int) -> torch.Tensor:
    """i32 [P, N] — per-node count of existing same-namespace, live pods
    matching any of the pod's group selectors (reference:
    priorities/selector_spreading.go:66 CalculateSpreadPriorityMap).
    The zone-weighted reduce happens in the scan.

    The per-node count is a segment sum over each existing pod's node.
    On CUDA `index_add_` sums with atomics in no fixed order; that is
    exact here only because the summands are 0/1 integers."""
    M = pm.labels.shape[0]
    dev = pm.labels.device
    ep_ids = torch.arange(M, dtype=torch.int32, device=dev)
    m = eval_and_program(pm.labels, None, pb.sg_key, pb.sg_op, pb.sg_vals,
                         pb.sg_num, ep_ids)  # [P, SG, M]
    any_sel = (m & pb.sg_valid[:, :, None]).any(dim=1)  # [P, M]
    has_sel = pb.sg_valid.any(dim=1)  # [P] — no selectors -> count 0
    eligible = pm.valid & pm.alive
    same_ns = pm.ns[None, :] == pb.ns_id[:, None]
    matched = any_sel & eligible[None, :] & same_ns & has_sel[:, None]
    P = matched.shape[0]
    out = torch.zeros((P, num_nodes), dtype=torch.int32, device=dev)
    # segment ids outside [0, num_nodes) are dropped, as segment_sum does
    node = pm.node.long()
    inside = (node >= 0) & (node < num_nodes)
    out.index_add_(1, node.clamp(0, num_nodes - 1),
                   (matched & inside[None, :]).to(torch.int32))
    return out


def spread_reduce(cnt, feasible, zone_id, num_zones: int):
    """[N] — reference selector_spreading.go:122 CalculateSpreadPriorityReduce
    with zoneWeighting = 2/3. The per-zone sum adds integer counts, so the
    atomic order of `index_add_` on CUDA cannot change it."""
    cntf = torch.where(feasible, cnt, 0).to(torch.float32)
    max_node = cntf.max()
    zc = torch.zeros((num_zones,), dtype=torch.float32, device=cnt.device)
    zc.index_add_(0, zone_id.long(), torch.where(zone_id > 0, cntf, 0.0))
    max_zone = torch.cat([zc.new_zeros(1), zc[1:]]).max()
    have_zones = (feasible & (zone_id > 0)).any()
    f = torch.where(max_node > 0,
                    MAX_PRIORITY * (max_node - cntf) / max_node.clamp(min=1.0),
                    MAX_PRIORITY)
    node_zc = zc[zone_id.long()]
    zscore = torch.where(
        max_zone > 0,
        MAX_PRIORITY * (max_zone - node_zc) / max_zone.clamp(min=1.0),
        MAX_PRIORITY)
    f = torch.where(have_zones & (zone_id > 0),
                    _div(f, 3.0) + (2.0 / 3.0) * zscore, f)
    return floor_div(f)


def image_locality(nt: NodeTensors, pb: PodBatch) -> torch.Tensor:
    """i32-valued f32 [P, N] — reference priorities/image_locality.go:39:
    bucketed sum of present image sizes, 23MB..1000MB -> 0..10. The
    image-slot sum runs over the slot axis as the JAX one does."""
    P, PI = pb.img_id.shape
    N = nt.img_id.shape[0]
    total = torch.zeros((P, N), dtype=torch.float32, device=nt.img_id.device)
    for i in range(PI):
        pid = pb.img_id[:, i]  # [P]
        hit = pid[:, None, None] == nt.img_id[None, :, :]  # [P, N, NI]
        sz = torch.where(hit, nt.img_size[None, :, :], 0.0).sum(dim=-1)
        total += torch.where((pid > 0)[:, None], sz, 0.0)
    mb = 1024.0 * 1024.0
    min_img, max_img = 23.0 * mb, 1000.0 * mb
    mid = floor_div(_div(MAX_PRIORITY * (total - min_img),
                         max_img - min_img)) + 1.0
    return torch.where(total < min_img, 0.0,
                       torch.where(total >= max_img, MAX_PRIORITY, mid))


def prefer_avoid(nt: NodeTensors, pb: PodBatch) -> torch.Tensor:
    """f32 [P, N] — reference priorities/node_prefer_avoid_pods.go:32.
    Simplified: any preferAvoidPods annotation on the node zeroes the
    score for RC/RS-controlled pods."""
    avoid = nt.avoid[None, :] & pb.owned[:, None]
    return torch.where(avoid, 0.0, MAX_PRIORITY).to(torch.float32)


def normalize_reduce(raw, feasible, reverse: bool):
    """[N] — reference priorities/reduce.go:29 NormalizeReduce(10, reverse)
    over the feasible set."""
    m = torch.where(feasible, raw, 0.0).max()
    score = floor_div(MAX_PRIORITY * raw / m.clamp(min=1.0))
    if reverse:
        score = MAX_PRIORITY - score
        return torch.where(m > 0, score, MAX_PRIORITY)
    return torch.where(m > 0, score, 0.0)
