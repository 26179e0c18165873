"""Batched preemption what-if, with a hand-written CUDA kernel.

The port of kubernetes_tpu/ops/preempt.py `_preemption_stats` (:85), an
XLA program of the JAX package. For a batch of failed pods it computes,
per (pod, node), the lowest candidate priority level whose victim class
(every live existing pod below min(level, the pod's priority)) frees
enough of the node for the pod, and that class's count, priority max,
priority sum and gang-disruption weight — the stats the host ranks
candidate nodes by (sched/scheduler.py `_preempt_chunk`) before it runs
the exact victim selection on the first few (sched/preemption.py).

The sums must come out bit-equal to the JAX program's: victim requests
are bytes (a 100M request times more than 42 victims passes f32's exact
range) and priorities go up to 2e9, so the order of the f32 adds shows
in the result, and one flipped bit can change which node a preemptor
takes. XLA's segment_sum adds a node's rows in increasing row index on
the CPU; the plain version below (`whatif_plain`) does the same with
`index_add_` on a CPU tensor. On a CUDA tensor `index_add_` adds by
float atomics in an arbitrary order, so the card runs the kernel in
csrc/preempt_whatif.cu instead, which walks each node's rows in order
(see its header).

Dispatch follows ops/taint_ports.py: `preempt_whatif` takes the plain
version for CPU tensors and launches the kernel for CUDA tensors (counted
in `preempt_whatif.launches`) or raises. There is no fallback. The
static predicate masks come from `static_predicate_masks` with the
resource and host-port rows set True, as in the JAX program; on the card
that launches the taint/port kernel.

`preemption_stats_host` is the JAX package's numpy twin
(kubernetes_tpu/ops/hostwave.py preemption_stats_host) over the
snapshot's host planes, which the per-pod host preemption uses to rank
its candidates (sched/preemption.py `vector_candidate_order`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import encoding as enc
from .cuda_build import PKG, compile_shared
from .filters import static_predicate_masks

SOURCE = PKG / "csrc" / "preempt_whatif.cu"
NEG = -(2**31) + 1
INT32_MIN = -(2**31)


class PreemptStats:
    """Host view over ONE fetched [5, P, N] i32 plane stack (numpy):
    planes 0-2 (ok, victim count, priority max) are native i32; planes 3
    (priority SUM) and 4 (gang-disruption weight) are f32 bitcast to
    i32 for the ride and viewed back here."""

    __slots__ = ("ok", "victims", "prio_sum", "prio_max", "gang_viol")

    def __init__(self, packed):
        self.ok = packed[0] != 0            # [P, N] bool
        self.victims = packed[1]            # [P, N] i32
        self.prio_max = packed[2]           # [P, N] i32 (NEG sentinel)
        self.prio_sum = np.ascontiguousarray(packed[3]).view(np.float32)
        self.gang_viol = np.ascontiguousarray(packed[4]).view(np.float32)


def victim_levels(ep_prio, live, num_levels: int) -> Optional[List[int]]:
    """Candidate priority thresholds from the live existing-pod rows
    (kubernetes_tpu/ops/hostwave.py:971): distinct priorities + 1, the
    highest always kept, padded by repeating the last."""
    prios = sorted({int(x) + 1 for x in np.asarray(ep_prio)[np.asarray(live)]})
    if len(prios) > num_levels:
        prios = prios[:num_levels - 1] + [prios[-1]]
    if not prios:
        return None
    return prios + [prios[-1]] * (num_levels - len(prios))


class WhatIf(NamedTuple):
    """What the what-if reads, as tensors on one device: the node side
    [N] / [N, R], the existing-pod matrix [M] / [M, R], the levels [L],
    and the failed pods [P] / [P, R] with their static predicate mask
    [P, N]. gang_w is None for a gang-free cluster."""

    alloc: torch.Tensor  # f32 [N, R]
    requested: torch.Tensor  # f32 [N, R]
    pod_count: torch.Tensor  # i32 [N]
    allowed_pods: torch.Tensor  # i32 [N]
    ep_node: torch.Tensor  # i32 [M]
    live: torch.Tensor  # bool [M]  valid & alive
    ep_req: torch.Tensor  # f32 [M, R]
    ep_prio: torch.Tensor  # i32 [M]
    gang_w: Optional[torch.Tensor]  # f32 [M] or None
    levels: torch.Tensor  # i32 [L]
    pb_req: torch.Tensor  # f32 [P, R]
    pb_prio: torch.Tensor  # i32 [P]
    static_ok: torch.Tensor  # bool [P, N]


def static_ok_mask(nt: enc.NodeTensors, pb: enc.PodBatch) -> torch.Tensor:
    """[P, N] every static predicate except the ones eviction resolves
    (resources and host ports), on valid nodes and valid pods
    (kubernetes_tpu/ops/preempt.py:117-122)."""
    R = nt.alloc.shape[1]
    is_core = torch.arange(R, device=nt.valid.device) < enc.RES_FIXED
    masks = static_predicate_masks(nt, pb, is_core)
    masks[enc.PRED_IDX["PodFitsResources"]] = True
    masks[enc.PRED_IDX["PodFitsHostPorts"]] = True
    return masks.all(dim=0) & nt.valid[None, :] & pb.valid[:, None]


def whatif_inputs(nt: enc.NodeTensors, pm: enc.PodMatrix, pb: enc.PodBatch,
                  levels, gang_w=None) -> WhatIf:
    dev = nt.valid.device
    return WhatIf(
        alloc=nt.alloc, requested=nt.requested, pod_count=nt.pod_count,
        allowed_pods=nt.allowed_pods, ep_node=pm.node,
        live=pm.valid & pm.alive, ep_req=pm.req, ep_prio=pm.prio,
        gang_w=(None if gang_w is None else
                torch.as_tensor(gang_w, dtype=torch.float32, device=dev)),
        levels=torch.as_tensor(levels, dtype=torch.int32, device=dev),
        pb_req=pb.req, pb_prio=pb.prio, static_ok=static_ok_mask(nt, pb))


# --- the plain version -------------------------------------------------------


def whatif_plain(w: WhatIf, with_level: bool = False):
    """The plain PyTorch version: packed i32 [5, P, N] (ok, victim count,
    priority max, f32 priority sum and f32 gang sum as bits), in the JAX
    program's op order. Its float sums are in row order only on a CPU
    tensor (index_add_ on a CUDA tensor adds by atomics). with_level:
    also return the index of the level each (pod, node) took, i32
    [P, N] (L where none fits) — the levels the kernel walks there."""
    dev = w.alloc.device
    P, R = w.pb_req.shape
    N = w.alloc.shape[0]
    M = w.ep_node.shape[0]
    is_core = torch.arange(R, device=dev) < enc.RES_FIXED
    node_ids = w.ep_node.clamp(min=0).long()
    # XLA's segment ops drop ids past the last segment: send them to a
    # dump column that is cut off
    node_ids = torch.where(node_ids < N, node_ids, N)
    prio_f = w.ep_prio.to(torch.float32)
    neg = torch.tensor(NEG, dtype=torch.int32, device=dev)
    ok = torch.zeros((P, N), dtype=torch.bool, device=dev)
    victims = torch.zeros((P, N), dtype=torch.int32, device=dev)
    prio_sum = torch.zeros((P, N), dtype=torch.float32, device=dev)
    prio_max = torch.full((P, N), NEG, dtype=torch.int32, device=dev)
    gang_viol = torch.zeros((P, N), dtype=torch.float32, device=dev)
    check = is_core[None, None, :] | (w.pb_req[:, None, :] > 0)
    L = w.levels.shape[0]
    level = torch.full((P, N), L, dtype=torch.int32, device=dev)

    def seg_sum(vals):  # [P, M(, R)] -> [P, N(, R)], in row order on the CPU
        out = vals.new_zeros((P, N + 1) + tuple(vals.shape[2:]))
        return out.index_add_(1, node_ids, vals)[:, :N]

    for l in range(L):
        thresh = torch.minimum(w.levels[l], w.pb_prio)  # [P]
        cls = w.live[None, :] & (w.ep_prio[None, :] < thresh[:, None])
        wt = cls.to(torch.float32)  # [P, M]
        rem_req = seg_sum(wt[:, :, None] * w.ep_req[None])  # [P, N, R]
        rem_cnt = seg_sum(wt)
        rem_psum = seg_sum(wt * prio_f[None])
        rem_pmax = torch.full((P, N + 1), INT32_MIN, dtype=torch.int32,
                              device=dev)
        rem_pmax.scatter_reduce_(
            1, node_ids[None].expand(P, M),
            torch.where(wt > 0, w.ep_prio[None], neg), "amax")
        rem_pmax = rem_pmax[:, :N]
        rem_gang = (seg_sum(wt * w.gang_w[None]) if w.gang_w is not None
                    else torch.zeros((P, N), dtype=torch.float32, device=dev))
        used = w.requested[None] - rem_req + w.pb_req[:, None, :]
        col_ok = used <= w.alloc[None]  # [P, N, R]
        fits = (col_ok | ~check).all(dim=-1)
        fits &= (w.pod_count[None] - rem_cnt.to(torch.int32) + 1
                 <= w.allowed_pods[None])
        feasible = fits & w.static_ok
        take = feasible & ~ok  # the lowest feasible level wins
        ok |= feasible
        victims = torch.where(take, rem_cnt.to(torch.int32), victims)
        prio_sum = torch.where(take, rem_psum, prio_sum)
        prio_max = torch.where(take, rem_pmax, prio_max)
        gang_viol = torch.where(take, rem_gang, gang_viol)
        level = torch.where(take, l, level)
    packed = torch.stack([ok.to(torch.int32), victims, prio_max,
                          prio_sum.view(torch.int32),
                          gang_viol.view(torch.int32)])
    return (packed, level) if with_level else packed


# --- build -------------------------------------------------------------------

_LOCK = threading.Lock()
_LIB = None
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile csrc/preempt_whatif.cu for sm_90a (once per process; cached
    under _build/ by the source's hash) and load it. Fills `build_info`
    with the seconds it took and ptxas's report."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out, log, seconds = compile_shared(SOURCE, "preempt_whatif")
        lib = ctypes.CDLL(str(out))
        ptr = ctypes.c_void_p
        lib.kpw_preempt_whatif.argtypes = [ptr] * 14 + [ctypes.c_int] * 5 \
            + [ptr, ptr]
        lib.kpw_preempt_whatif.restype = ctypes.c_int
        lib.kpw_max_resources.restype = ctypes.c_int
        lib.kpw_error_string.argtypes = [ctypes.c_int]
        lib.kpw_error_string.restype = ctypes.c_char_p
        build_info.update(seconds=seconds, log=log, library=out.name)
        _LIB = lib
        return lib


def node_rows(ep_node: torch.Tensor, N: int):
    """The rows of each node as a CSR, each node's rows in increasing row
    index: (row_ptr i32 [N + 1], rows i32 [K]) from max(node, 0); ids at
    or past N belong to no node. Every row counts, free and pad rows
    (node 0) and removed rows (their old node) too."""
    ids = ep_node.clamp(min=0)
    ids = torch.where(ids < N, ids, N)
    rows = torch.sort(ids, stable=True).indices.to(torch.int32)
    counts = torch.bincount(ids.long(), minlength=N + 1)[:N]
    row_ptr = torch.zeros((N + 1,), dtype=torch.int32, device=ep_node.device)
    row_ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return row_ptr, rows


def _contig(name: str, t: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.contiguous()


def preempt_whatif(w: WhatIf) -> torch.Tensor:
    """The what-if -> packed i32 [5, P, N]. CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    `preempt_whatif.launches`) or raise."""
    device = w.alloc.device
    if device.type == "cpu":
        return whatif_plain(w)
    if device.type != "cuda":
        raise ValueError(f"preempt_whatif: unsupported device {device}")
    N, R = w.alloc.shape
    M = w.ep_node.shape[0]
    P = w.pb_req.shape[0]
    L = w.levels.shape[0]
    f32, i32 = torch.float32, torch.int32
    args = [
        _contig("alloc", w.alloc, f32, (N, R), device),
        _contig("requested", w.requested, f32, (N, R), device),
        _contig("pod_count", w.pod_count, i32, (N,), device),
        _contig("allowed_pods", w.allowed_pods, i32, (N,), device),
        _contig("ep_req", w.ep_req, f32, (M, R), device),
        _contig("ep_prio", w.ep_prio, i32, (M,), device),
        _contig("live", w.live, torch.bool, (M,), device),
    ]
    gang = (None if w.gang_w is None else
            _contig("gang_w", w.gang_w, f32, (M,), device))
    _contig("ep_node", w.ep_node, i32, (M,), device)
    row_ptr, rows = node_rows(w.ep_node, N)
    tail = [
        _contig("levels", w.levels, i32, (L,), device),
        _contig("pb_req", w.pb_req, f32, (P, R), device),
        _contig("pb_prio", w.pb_prio, i32, (P,), device),
        _contig("static_ok", w.static_ok, torch.bool, (P, N), device),
    ]
    out = torch.empty((5, P, N), dtype=i32, device=device)
    if P == 0 or N == 0:
        return out
    lib = build()
    if R > lib.kpw_max_resources():
        raise ValueError(f"preempt_whatif kernel holds at most "
                         f"{lib.kpw_max_resources()} resource columns, "
                         f"got R={R}")
    if max(P * N, M) >= 2**31:
        raise ValueError(f"preempt_whatif kernel: P*N={P * N}, M={M} "
                         "exceed int32")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.kpw_preempt_whatif(
        *[t.data_ptr() for t in args],
        None if gang is None else gang.data_ptr(),
        row_ptr.data_ptr(), rows.data_ptr(),
        *[t.data_ptr() for t in tail], P, N, R, L, enc.RES_FIXED,
        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("preempt_whatif kernel launch failed: "
                           f"{lib.kpw_error_string(err).decode()} "
                           f"(cudaError {err})")
    preempt_whatif.launches += 1
    return out


preempt_whatif.launches = 0


def preemption_stats(nt: enc.NodeTensors, pm: enc.PodMatrix,
                     pb: enc.PodBatch, levels, *, num_levels: int,
                     gang_w=None) -> torch.Tensor:
    """The what-if for a batch of failed pods -> packed i32 [5, P, N]
    (see PreemptStats), on the tensors' device: the kernel on the card,
    the plain version on the CPU. levels: i32 [num_levels] ascending
    thresholds; gang_w: optional f32 [M] gang-disruption weights."""
    if len(levels) != num_levels:
        raise ValueError(f"{len(levels)} levels, num_levels={num_levels}")
    return preempt_whatif(whatif_inputs(nt, pm, pb, levels, gang_w))


def preemption_stats_plain(nt: enc.NodeTensors, pm: enc.PodMatrix,
                           pb: enc.PodBatch, levels, *, num_levels: int,
                           gang_w=None) -> torch.Tensor:
    """preemption_stats through the plain version on any device."""
    if len(levels) != num_levels:
        raise ValueError(f"{len(levels)} levels, num_levels={num_levels}")
    return whatif_plain(whatif_inputs(nt, pm, pb, levels, gang_w))


# --- the numpy twin of the host per-pod path ---------------------------------


def preemption_stats_host(nt, pm, pb, levels, *, num_levels: int,
                          gang_w=None) -> np.ndarray:
    """The JAX package's numpy twin of the what-if
    (kubernetes_tpu/ops/hostwave.py preemption_stats_host) over numpy
    tuples: packed i32 [5, P, N]. Its sums run in float64 and are rounded
    to f32 once, as the twin's are; its classes are deduplicated by
    threshold value. The static masks come from the port's
    static_predicate_masks on CPU tensors (boolean, so the same as the
    twin's numpy masks)."""
    levels = np.asarray(levels, np.int32)
    P = pb.req.shape[0]
    N = nt.valid.shape[0]
    R = nt.alloc.shape[1]
    is_core = np.arange(R) < enc.RES_FIXED
    ntt, _, _, pbt = enc.to_torch(nt, None, None, pb, "cpu")
    static_ok = static_ok_mask(ntt, pbt).numpy()

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
                rem_gang = seg(w_row * np.asarray(
                    gang_w, np.float64)).astype(np.float32)
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


# --- seeded worlds at the kernel's edges --------------------------------------


def random_whatif(P: int, N: int, M: int, seed: int, *, R: int = 4,
                  large: bool = False, gang: bool = True,
                  free_rows: bool = True, device="cuda") -> WhatIf:
    """A seeded what-if input for holding the kernel to its plain version,
    at the traps of the JAX program:

    * large=True: memory requests of hundreds of MB that are not whole
      multiples of anything (their f32 sums round, so the order of the
      adds shows) and priorities up to 2e9;
    * free_rows: a fifth of the rows are free or pad rows at node 0
      (valid False), another tenth removed rows on their old node, so
      node 0 gets NEG, nodes without rows INT32_MIN;
    * levels repeat their last entry as victim_levels pads them, and some
      pods' priorities cut below the levels;
    * gang=False: no gang weights (plane 4 all zero);
    * invalid nodes and pad pods (static_ok False on their rows and
      columns), and extended resource columns that only some pods ask for.
    P and N need not be multiples of anything."""
    rng = np.random.RandomState(seed)
    hi = 2_000_000_000 if large else 100
    ep_prio = rng.randint(-5, hi, M).astype(np.int32)
    if large:
        top = rng.rand(M) < 0.3
        ep_prio[top] = hi - rng.randint(0, 50, int(top.sum()))
    ep_node = rng.randint(0, max(N, 1), M).astype(np.int32)
    valid = rng.rand(M) < 0.95
    alive = valid & (rng.rand(M) < 0.95)
    if free_rows:
        free = rng.rand(M) < 0.2
        ep_node[free] = 0
        valid &= ~free
        alive &= ~free
        removed = (rng.rand(M) < 0.1) & ~free
        valid &= ~removed
        alive &= ~removed
    ep_node[rng.rand(M) < 0.02] = -1  # clipped to node 0
    ep_req = np.zeros((M, R), np.float32)
    ep_req[:, 0] = rng.randint(0, 4000, M)  # milli-CPU
    if large:
        ep_req[:, 1] = (rng.rand(M) * 9e8 + 1e8).astype(np.float32)
        ep_req[:, 2] = (rng.rand(M) * 3e9).astype(np.float32)
    else:
        ep_req[:, 1] = rng.randint(0, 64, M) * 2**20
        ep_req[:, 2] = rng.randint(0, 8, M) * 2**30
    if R > 3:
        ep_req[:, 3:] = rng.randint(0, 3, (M, R - 3)) * (rng.rand(M, R - 3)
                                                         < 0.3)
    # node usage as the sum of its live rows plus noise, allocatable near it
    requested = np.zeros((N, R), np.float64)
    np.add.at(requested, np.clip(ep_node, 0, None)[valid],
              ep_req[valid].astype(np.float64))
    requested = requested.astype(np.float32)
    # allocatable near the usage, plus headroom on some nodes so that
    # nodes without rows can fit a pod with no victim at all
    alloc = requested * rng.uniform(0.9, 1.3, (N, R))
    room = rng.rand(N) < 0.5
    alloc[:, 0] += rng.randint(0, 3000, N) + room * 6000
    alloc[:, 1] += room * (2e9 if large else 2**32)
    alloc[:, 2] += room * 4 * 2**30
    alloc = alloc.astype(np.float32)
    pod_count = np.bincount(np.clip(ep_node, 0, None)[valid],
                            minlength=N)[:N].astype(np.int32)
    allowed = (pod_count + rng.randint(-2, 4, N)).astype(np.int32)
    prios = sorted({int(x) + 1 for x in ep_prio[alive]}) or [1]
    pick = sorted(rng.choice(len(prios), size=min(5, len(prios)),
                             replace=False))
    lv = [prios[i] for i in pick] + [prios[-1]]
    levels = np.asarray(lv + [lv[-1]] * (8 - len(lv)), np.int32)[:8]
    pb_req = np.zeros((P, R), np.float32)
    pb_req[:, 0] = rng.randint(0, 6000, P)
    pb_req[:, 1] = (rng.rand(P) * (2e9 if large else 2**32)).astype(np.float32)
    pb_req[:, 2] = rng.randint(0, 4, P) * 2**30
    if R > 3:
        pb_req[:, 3:] = rng.randint(0, 3, (P, R - 3)) * (rng.rand(P, R - 3)
                                                         < 0.3)
    pb_prio = rng.randint(0, hi, P).astype(np.int32)
    pb_prio[rng.rand(P) < 0.2] = hi  # above every level
    static_ok = rng.rand(P, N) < 0.9
    static_ok[:, rng.rand(N) < 0.05] = False  # invalid nodes
    static_ok[rng.rand(P) < 0.1] = False  # pad pods
    gang_w = ((rng.rand(M) < 0.4) * rng.choice([1.0, 0.5, 3.0], M)).astype(
        np.float32) if gang else None

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return WhatIf(alloc=t(alloc), requested=t(requested),
                  pod_count=t(pod_count), allowed_pods=t(allowed),
                  ep_node=t(ep_node), live=t(alive), ep_req=t(ep_req),
                  ep_prio=t(ep_prio), gang_w=None if gang_w is None
                  else t(gang_w), levels=t(levels), pb_req=t(pb_req),
                  pb_prio=t(pb_prio), static_ok=t(static_ok))


# (P, N, M, random_whatif keywords): P = 1, 16 and 128, N not a multiple
# of 32 and below it, large values and small, with and without gang
# weights, and a world with no free row
EDGE_WORLDS = (
    (1, 37, 64, dict(large=True)),
    (16, 45, 200, dict(large=True, gang=False)),
    (128, 100, 300, dict(large=True)),
    (16, 7, 40, dict(free_rows=False)),
    (128, 33, 128, dict(gang=False)),
    (1, 1, 8, dict(large=True)),
)
