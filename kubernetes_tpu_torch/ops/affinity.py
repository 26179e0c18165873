"""Batched inter-pod affinity/anti-affinity statics.

Reproduces the reference's InterPodAffinityMatches predicate
(pkg/scheduler/algorithm/predicates/predicates.go:1115, metadata path)
and CalculateInterPodAffinityPriority
(pkg/scheduler/algorithm/priorities/interpod_affinity.go:118) as dense
computations, in PyTorch, bit-equal to the JAX package's
kubernetes_tpu/ops/affinity.py.

Dense shape of the problem:

  * Existing pods' terms live in a TermTable (one row per term, E rows).
    An [P, E] "entry matches incoming pod" matrix times an [E, N]
    "entry's topology domain contains node" matrix yields both the
    anti-affinity symmetry mask and the existing-pod side of the
    priority in one contraction each.
  * The incoming pod's required terms collapse to one combined AND
    program with a single shared topology key; satisfaction is anchored
    through the label-value vocabulary: segment-reduce matching pods by
    the domain value of their node ([U, LV]), then gather at each
    node's domain value ([U, N]). Pods whose required terms span more
    than one topology key are refused by the port's scheduler (the JAX
    package sends them to its exact host path, plugins/golden.py).
  * Wave-internal visibility (a pod sees placements made earlier in the
    same wave) is handled in the per-pod loop of ops/kernel.py, using
    the [P, P] cross-match matrices computed here.

Exactness on every device:

  * The two [P, E] @ [E, N] products stay full f32 torch.matmul (no
    TF32: this package never sets `allow_tf32` or the float32 matmul
    precision). Their operands are 0/1 and integer weights (the
    default hard-affinity weight 1, preferred-term weights 1-100), so
    every partial sum is an integer below 2^24 and the result is the
    same in any reduction order.
  * The segment sums (`_anchored_hit`) add 0/1 values, so the order in
    which `scatter_add_` applies them (atomic on CUDA) cannot change
    them. Domain ids at or past `num_segments` go to one dump segment
    that is cut off — jax.ops.segment_sum drops them — so no index is
    ever out of range on the card. Label-value ids are below
    `num_segments` whenever it is the snapshot's `num_label_values`,
    which grows with the vocabulary (tests/test_torch_affinity.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import encoding as enc
from .encoding import NodeTensors, PodBatch, PodMatrix, TermTable
from .selectors import eval_and_program


def ns_match(ns_sets, ns_ids):
    """bool [..., X]: is ns_ids[x] in ns_sets[...]?
    ns_sets: i32 [..., TNS] (0 pad — an all-pad set matches nothing);
    ns_ids:  i32 [X]."""
    expanded = ns_sets[..., :, None]  # [..., TNS, 1]
    ids = ns_ids.reshape((1,) * (ns_sets.dim() - 1) + (1, -1))
    return ((expanded == ids) & (expanded > 0)).any(dim=-2)


def _eval_programs(label_matrix, key, op, vals):
    """Evaluate AND programs (no numeric ops) against a label matrix.
    key/op: [..., E]; vals: [..., E, V]; label_matrix [X, K] -> bool [..., X]."""
    num = torch.full(key.shape, float("nan"), dtype=torch.float32,
                     device=key.device)
    ids = torch.arange(label_matrix.shape[0], dtype=torch.int32,
                       device=key.device)
    return eval_and_program(label_matrix, None, key, op, vals, num, ids)


def term_entry_match(tt: TermTable, pb: PodBatch) -> torch.Tensor:
    """bool [P, E] — does TermTable entry e's (namespaces, selector) match
    incoming pod p? (predicates.go PodMatchesTermsNamespaceAndSelector,
    with the term owner's default namespace already baked into tt.ns)."""
    sel = _eval_programs(pb.pl_val, tt.key, tt.op, tt.vals)  # [E, P]
    nsm = ns_match(tt.ns, pb.ns_id)  # [E, P]
    return (sel & nsm & tt.valid[:, None]).T


def same_domain(tt: TermTable, nt: NodeTensors) -> torch.Tensor:
    """bool [E, N] — is node n in the same topology domain as entry e's
    owner node under e's topology key? (NodesHaveSameTopologyKey:
    both labels present and equal.) Pad entries' owner rows are clamped
    into range; the `tt.valid` factor masks them out."""
    N, K = nt.labels.shape
    tk = tt.tk.clamp(0, K - 1).long()
    owner = tt.node.clamp(0, N - 1).long()
    own = nt.labels[owner].gather(1, tk[:, None])[:, 0]  # [E]
    node_dom = nt.labels.index_select(1, tk).T  # [E, N]
    return ((node_dom == own[:, None]) & (own > 0)[:, None] & (node_dom > 0)
            & (tt.tk > 0)[:, None] & tt.valid[:, None] & nt.valid[None, :])


def _bool_matmul(a, b):
    """bool [P, E] @ bool [E, N] -> bool [P, N] via a full-f32 product
    (0/1 operands: exact in any order)."""
    return (a.to(torch.float32) @ b.to(torch.float32)) > 0.5


def node_domains(nt: NodeTensors, tk) -> torch.Tensor:
    """i32 [..., N] — each node's domain (label value id) under per-row
    topology keys tk [...]. 0 = key absent."""
    K = nt.labels.shape[1]
    flat = tk.reshape(-1)
    dom = nt.labels.index_select(1, flat.clamp(0, K - 1).long()).T  # [B, N]
    dom = torch.where((flat > 0)[:, None], dom, 0)
    return dom.reshape(tuple(tk.shape) + (nt.labels.shape[0],))


def pod_domains(dom, pod_node):
    """dom i32 [B, N], pod_node i32 [M] -> i32 [B, M]: the domain of each
    pod's node per row (take_along_axis). Pod rows whose node index is
    out of range (pads) are clamped; every caller masks them out."""
    N = dom.shape[1]
    idx = pod_node.clamp(0, N - 1).long()[None, :].expand(dom.shape[0], -1)
    return dom.gather(1, idx)


def gather_domains(table, dom):
    """table [B, LV] at domain ids dom i32 [B, N] -> [B, N]
    (take_along_axis). Ids are below LV (module doc); the clamp only
    keeps the card from faulting if that ever breaks."""
    return table.gather(1, dom.clamp(0, table.shape[1] - 1).long())


class IncomingStatics(NamedTuple):
    """Per-wave static (pre-loop) inter-pod affinity state."""

    sym_blocked: torch.Tensor  # bool [P, N] existing pods' req-anti symmetry
    ok_aff: torch.Tensor  # bool [P, N]  incoming req-affinity satisfied (static)
    any_aff: torch.Tensor  # bool [P]    any matching pod exists (bootstrap rule)
    blocked_anti: torch.Tensor  # bool [P, N] incoming req-anti violated (static)
    counts: torch.Tensor  # f32 [P, N]   priority raw counts
    node_dom_ra: torch.Tensor  # i32 [P, N] node domain under pod's aff tk
    node_dom_rn: torch.Tensor  # i32 [P, N] node domain under pod's anti tk
    wm_aff: torch.Tensor  # bool [P, P]  wave pod j matches pod i's aff props
    wm_anti: torch.Tensor  # bool [P, P] wave pod j matches pod i's anti props


def _anchored_hit(match, dom_m, num_segments, count=False):
    """match: bool [B, M]; dom_m: i32 [B, M] domain value of each matching
    pod's node. Segment-reduce over the label-value vocab: returns
    [B, num_segments] (bool any, or f32 counts). Ids >= num_segments go
    to a dump segment past the end that is cut off (segment_sum drops
    them); the 0/1 sums are exact in any order."""
    contrib = (match & (dom_m > 0)).to(torch.float32)
    seg = torch.where(dom_m < num_segments, dom_m, num_segments).long()
    hit = torch.zeros((match.shape[0], num_segments + 1),
                      dtype=torch.float32, device=match.device)
    hit.scatter_add_(1, seg, contrib)
    hit = hit[:, :num_segments]
    return hit if count else hit > 0.5


def incoming_statics(nt: NodeTensors, pm: PodMatrix, tt: TermTable,
                     pb: PodBatch, num_label_values: int,
                     hard_weight: float) -> IncomingStatics:
    em = term_entry_match(tt, pb)  # [P, E]
    sd = same_domain(tt, nt)  # [E, N]
    kind = tt.kind
    sym_blocked = _bool_matmul(em & (kind == enc.TERM_REQ_ANTI)[None, :], sd)

    # --- incoming required (anti)affinity, deduplicated ------------------
    # The wave's unique required programs (pb.iu_*, row 0 = never-matches)
    # are evaluated ONCE against the existing-pod matrix — [U, M] instead
    # of [P, M]; per-pod views are gathers through ra_uid/rn_uid.
    u_sel = _eval_programs(pm.labels, pb.iu_key, pb.iu_op, pb.iu_vals)  # [U, M]
    u_m = u_sel & ns_match(pb.iu_ns, pm.ns) & pm.valid[None, :]
    node_dom_u = node_domains(nt, pb.iu_tk)  # [U, N]
    dom_m_u = pod_domains(node_dom_u, pm.node)
    hit_u = _anchored_hit(u_m, dom_m_u, num_label_values)  # [U, LV]
    # "a matching pod exists in node n's domain" per unique program
    ok_u = gather_domains(hit_u, node_dom_u) & (node_dom_u > 0)
    any_u = u_m.any(dim=1)  # [U]

    ra = pb.ra_uid.long()
    rn = pb.rn_uid.long()
    ok_aff = ok_u[ra]  # [P, N]
    any_aff = any_u[ra]
    node_dom_ra = node_dom_u[ra]
    blocked_anti = ok_u[rn]
    node_dom_rn = node_dom_u[rn]

    # --- priority counts -------------------------------------------------
    # existing-pod side: hard symmetric weight for required affinity terms,
    # signed weights for preferred terms (interpod_affinity.go:149-188);
    # the kinds are exclusive, so the chain of wheres is jnp.select
    zero = torch.zeros_like(tt.weight)
    we = torch.where(kind == enc.TERM_PREF_ANTI, -tt.weight, zero)
    we = torch.where(kind == enc.TERM_PREF_AFF, tt.weight, we)
    we = torch.where(kind == enc.TERM_REQ_AFF,
                     torch.full_like(tt.weight, hard_weight), we)
    counts = (em.to(torch.float32) * we[None, :]) @ sd.to(torch.float32)
    # incoming pods' preferred terms: unique-table evaluation, then a
    # per-slot gather + weight (weights stay per-pod in pa_w)
    pu_sel = _eval_programs(pm.labels, pb.pu_key, pb.pu_op, pb.pu_vals)
    pu_m = pu_sel & ns_match(pb.pu_ns, pm.ns) & pm.valid[None, :]  # [UP, M]
    dom_pu = node_domains(nt, pb.pu_tk)  # [UP, N]
    dom_m_pu = pod_domains(dom_pu, pm.node)
    cnt_u = _anchored_hit(pu_m, dom_m_pu, num_label_values, count=True)
    cnt_node_u = gather_domains(cnt_u, dom_pu) * (dom_pu > 0)  # [UP, N]
    PA = pb.pa_w.shape[1]
    for t in range(PA):
        counts = counts + pb.pa_w[:, t, None] * cnt_node_u[
            pb.pa_uid[:, t].long()]
    counts = counts * nt.valid[None, :]

    # --- wave-internal cross matrices ------------------------------------
    wave_aff_sel = _eval_programs(pb.pl_val, pb.ra_key, pb.ra_op, pb.ra_vals)
    wm_aff = (wave_aff_sel & ns_match(pb.ra_ns, pb.ns_id)
              & pb.ra_has[:, None] & pb.valid[None, :])
    wave_anti_sel = _eval_programs(pb.pl_val, pb.rn_key, pb.rn_op, pb.rn_vals)
    wm_anti = (wave_anti_sel & ns_match(pb.rn_ns, pb.ns_id)
               & pb.rn_has[:, None] & pb.valid[None, :])

    return IncomingStatics(
        sym_blocked=sym_blocked, ok_aff=ok_aff, any_aff=any_aff,
        blocked_anti=blocked_anti, counts=counts,
        node_dom_ra=node_dom_ra, node_dom_rn=node_dom_rn,
        wm_aff=wm_aff, wm_anti=wm_anti)
