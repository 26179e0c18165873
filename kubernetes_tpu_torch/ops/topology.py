"""Batched topology-spread statics.

The PodTopologySpread plugin (upstream pkg/scheduler/framework/plugins/
podtopologyspread/, forward-ported by the JAX package) in the dense
wave formulation, in PyTorch, bit-equal to kubernetes_tpu/ops/topology.py.

  * Each pod carries up to Caps.TS spread constraints, featurized into
    per-constraint rows (state/featurize.py): a topology-key column id,
    maxSkew, a hard/soft flag and an AND selector program over pod
    labels. Resident matching-pod counts per topology-domain value are
    one batched segment sum over the pod matrix anchored through the
    label-value vocabulary — the shape of ops/affinity.py's
    `_anchored_hit` (0/1 sums: exact in any order).
  * Per-node skew is then a gather at each node's domain value; the
    global min/max match counts reduce over the domain values present
    among valid nodes (upstream's "global minimum matchNum"; an empty
    domain still pulls the minimum down).
  * Wave-internal visibility (a pod sees same-wave placements) rides
    the per-pod loop's `placed` tensor in ops/kernel.py via the
    [P, TS, P] cross-match matrix computed here.

Simplifications kept from the JAX package (PARITY.md): the min/max
match counts reduce over the domains of ALL valid nodes rather than the
per-pod filtered node set, and the incoming pod counts itself (+1) only
when it matches its own constraint's selector (upstream's
selfMatchNum).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .affinity import _anchored_hit, _eval_programs, node_domains, pod_domains
from .encoding import NodeTensors, PodBatch, PodMatrix


class TopoStatics(NamedTuple):
    """Per-wave static (pre-loop) topology-spread state. Leading axes:
    P wave pods x TS spread-constraint slots."""

    node_dom: torch.Tensor  # i32 [P, TS, N] node's domain value id (0 = key absent)
    counts: torch.Tensor  # f32 [P, TS, LV] resident matching pods per domain value
    present: torch.Tensor  # bool [P, TS, LV] domain value exists among valid nodes
    wm: torch.Tensor  # bool [P, TS, P] wave pod j matches constraint (i, t)
    selfm: torch.Tensor  # bool [P, TS]   pod i matches its own constraint (i, t)


def topo_statics(nt: NodeTensors, pm: PodMatrix, pb: PodBatch,
                 num_label_values: int) -> TopoStatics:
    """All loop-invariant PodTopologySpread state for one wave.

    match = selector(existing pod labels) & same-namespace & live, per
    constraint row (upstream counts only the constraint owner's
    namespace; a nil selector was featurized as OP_FALSE and matches
    nothing). Counts segment-reduce the matches by the domain value of
    each pod's node; `present` segment-reduces valid nodes themselves so
    empty domains still take part in the min."""
    P, TS = pb.ts_tk.shape
    N = nt.labels.shape[0]
    dom = node_domains(nt, pb.ts_tk)  # [P, TS, N]
    dom = dom * nt.valid[None, None, :]
    dom_f = dom.reshape(P * TS, N)

    live = pb.ts_valid[:, :, None]  # [P, TS, 1]
    sel = _eval_programs(pm.labels, pb.ts_key, pb.ts_op, pb.ts_vals)  # [P, TS, M]
    same_ns = pm.ns[None, None, :] == pb.ns_id[:, None, None]
    match = sel & same_ns & (pm.valid & pm.alive)[None, None, :] & live
    M = pm.labels.shape[0]
    dom_m = pod_domains(dom_f, pm.node)
    counts = _anchored_hit(match.reshape(P * TS, M), dom_m,
                           num_label_values, count=True)
    present = _anchored_hit(nt.valid[None, :].expand(P * TS, N), dom_f,
                            num_label_values)

    wsel = _eval_programs(pb.pl_val, pb.ts_key, pb.ts_op, pb.ts_vals)  # [P, TS, P]
    wave_ns = pb.ns_id[None, None, :] == pb.ns_id[:, None, None]
    wm = wsel & wave_ns & pb.valid[None, None, :] & live
    ar = torch.arange(P, device=wm.device)
    selfm = wm[ar, :, ar]  # [P, TS]
    return TopoStatics(node_dom=dom.to(torch.int32),
                       counts=counts.reshape(P, TS, num_label_values),
                       present=present.reshape(P, TS, num_label_values),
                       wm=wm, selfm=selfm)
