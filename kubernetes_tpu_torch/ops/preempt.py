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
float atomics in an arbitrary order, so the card runs the kernels in
csrc/preempt_whatif.cu instead (see its header): `live_rows` lists each
node's kept rows in row order, `threshold_slots` the chunk's distinct
victim-class thresholds, then one pass sums each (threshold, node)
class and one picks each (pod, node)'s level.

Dispatch follows ops/taint_ports.py: `preempt_whatif` takes the plain
version for CPU tensors and launches the kernels for CUDA tensors
(counted once a call in `preempt_whatif.launches`) or raises; its steps
are `whatif_prepare` and `whatif_launch`. There is no fallback. The
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
        # XLA evaluates the JAX program's w * gang_w (w a converted bool)
        # as a select: a non-victim adds +0 even where its weight is not
        # finite (tests/test_torch_preempt.py), unlike the requests above
        rem_gang = (seg_sum(torch.where(cls, w.gang_w[None], 0.0))
                    if w.gang_w is not None
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


def class_stats_plain(w: WhatIf, values: torch.Tensor) -> torch.Tensor:
    """The plain version of the class-stats kernel: [S, R + 4, N] i32,
    each threshold of `values` [S] with its victim class (live rows below
    it) summed per node in row order on a CPU tensor, as `whatif_plain`
    sums one level — R request columns, the count, the priority sum and
    the gang sum (f32 bits), then the priority max."""
    N = w.alloc.shape[0]
    ids = w.ep_node.clamp(min=0).long()
    ids = torch.where(ids < N, ids, N)
    neg = torch.tensor(NEG, dtype=torch.int32, device=ids.device)

    def seg(v):  # [M(, R)] -> [N(, R)], a dump row for ids past N
        return v.new_zeros((N + 1,) + tuple(v.shape[1:])).index_add_(
            0, ids, v)[:N]

    out = []
    for t in values.tolist():
        cls = w.live & (w.ep_prio < t)
        wt = cls.to(torch.float32)
        gang = (seg(torch.where(cls, w.gang_w, 0.0)) if w.gang_w is not None
                else torch.zeros((N,), device=ids.device))
        pmax = torch.full((N + 1,), INT32_MIN, dtype=torch.int32,
                          device=ids.device)
        pmax.scatter_reduce_(0, ids, torch.where(cls, w.ep_prio, neg), "amax")
        floats = torch.cat([seg(wt[:, None] * w.ep_req).T, torch.stack(
            [seg(wt), seg(wt * w.ep_prio.to(torch.float32)), gang])])
        out.append(torch.cat([floats.view(torch.int32), pmax[None, :N]]))
    return torch.stack(out)


# --- the kernels -------------------------------------------------------------

_LOCK = threading.Lock()
_LIB = None
build_info: dict = {}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C entries of csrc/preempt_whatif.cu on a loaded
    library (the nvcc build, or a host build of the same source)."""
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.kpw_row_keys.argtypes = [ptr] * 3 + [c_int] * 3 + [ptr, ptr]
    lib.kpw_row_bounds.argtypes = [ptr, ptr, c_int, c_int, ptr, ptr, ptr]
    lib.kpw_threshold_slots.argtypes = [ptr, ptr, c_int, c_int] + [ptr] * 5
    lib.kpw_class_stats_and_pick.argtypes = ([ptr] * 15 + [c_int] * 6
                                             + [ptr, ptr, ptr])
    lib.kpw_max_slots.argtypes = [c_int, c_int]
    lib.kpw_error_string.argtypes = [c_int]
    lib.kpw_error_string.restype = ctypes.c_char_p
    return lib


def build() -> ctypes.CDLL:
    """Compile csrc/preempt_whatif.cu for sm_90a (once per process; cached
    under _build/ by the source's hash) and load it. Fills `build_info`
    with the seconds it took and ptxas's report."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out, log, seconds = compile_shared(SOURCE, "preempt_whatif")
        lib = bind(ctypes.CDLL(str(out)))
        build_info.update(seconds=seconds, log=log, library=out.name)
        _LIB = lib
        return lib


def _check(lib, err: int, step: str) -> None:
    if err != 0:
        raise RuntimeError(f"preempt_whatif: {step} launch failed: "
                           f"{lib.kpw_error_string(err).decode()} "
                           f"(cudaError {err})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _row_keys_plain(ep_node, live, ep_req, N: int) -> torch.Tensor:
    """The sort key of each existing-pod row (csrc whatif_row_keys): its
    node max(node, 0) when the row is kept — live, or carrying a
    non-finite request — N + 1 + node when it is left out, 2N + 1 when it
    belongs to no node."""
    ids = ep_node.clamp(min=0)
    kept = live | ~torch.isfinite(ep_req).all(dim=1)
    key = torch.where(kept, ids, ids + (N + 1))
    return torch.where(ids < N, key, 2 * N + 1).to(torch.int32)


def _row_csr(ep_node, live, ep_req, N: int, lib=None, stream=None):
    """(bounds i32 [2N + 2], rows i32 [M]): node n's kept rows, in
    increasing row index, are rows[bounds[n]:bounds[n + 1]], and its
    left-out rows rows[bounds[N + 1 + n]:bounds[N + 2 + n]]. A stable sort
    of the row keys; with `lib` the keys and bounds come from its kernels,
    without it from plain PyTorch."""
    M = ep_node.shape[0]
    if lib is None:
        keys = _row_keys_plain(ep_node, live, ep_req, N)
    else:
        keys = torch.empty((M,), dtype=torch.int32, device=ep_node.device)
        _check(lib, lib.kpw_row_keys(
            _ptr(ep_node), _ptr(live), _ptr(ep_req), M, N, ep_req.shape[1],
            _ptr(keys), stream), "row keys")
    skeys, order = torch.sort(keys, stable=True)
    if lib is None:
        marks = torch.arange(2 * N + 2, dtype=torch.int32,
                             device=ep_node.device)
        return (torch.searchsorted(skeys, marks).to(torch.int32),
                order.to(torch.int32))
    bounds = torch.empty((2 * N + 2,), dtype=torch.int32,
                         device=ep_node.device)
    rows = torch.empty((M,), dtype=torch.int32, device=ep_node.device)
    _check(lib, lib.kpw_row_bounds(_ptr(skeys), _ptr(order), M, N,
                                   _ptr(bounds), _ptr(rows), stream),
           "row bounds")
    return bounds, rows


def live_rows(ep_node: torch.Tensor, live: torch.Tensor,
              ep_req: torch.Tensor, N: int, *, lib=None, stream=None):
    """The rows the what-if walks, as a CSR: (row_ptr i32 [N + 1], rows
    i32 [M], dropped u8 [N]). Node n's rows are rows[row_ptr[n]:
    row_ptr[n + 1]], in increasing row index: the rows with
    max(node, 0) == n that are live (valid & alive) or carry a non-finite
    request; ids at or past N belong to no node.
    dropped[n] says that a row of node n was left out (it would add NEG
    to the priority max). rows past row_ptr[N] are the left-out rows.
    CUDA tensors go through the kernels (`lib`, default the nvcc build),
    CPU tensors through plain PyTorch unless `lib` is given."""
    if lib is None and ep_node.device.type == "cuda":
        lib = build()
        stream = torch.cuda.current_stream(ep_node.device).cuda_stream
    bounds, rows = _row_csr(ep_node, live, ep_req, N, lib, stream)
    dropped = (bounds[N + 2:] > bounds[N + 1:-1]).to(torch.uint8)
    return bounds[:N + 1], rows, dropped


def threshold_slots(levels: torch.Tensor, pb_prio: torch.Tensor, *,
                    lib=None, stream=None):
    """The chunk's distinct victim-class thresholds min(levels[l],
    prio_p): (slot_values i32 [S_max], ascending in their first S
    entries, slot_of i32 [P, L] each (pod, level)'s index into them,
    n_slots i32 [1] = S). S <= L + P - 1; S_max = L + P without `lib`,
    lib.kpw_max_slots(P, L) with it. CUDA tensors go through the kernel,
    CPU tensors through plain PyTorch unless `lib` is given."""
    P, L = pb_prio.shape[0], levels.shape[0]
    dev = levels.device
    if lib is None and dev.type == "cuda":
        lib = build()
        stream = torch.cuda.current_stream(dev).cuda_stream
    if lib is None:
        thresh = torch.minimum(levels[None, :], pb_prio[:, None])
        values, slot_of = torch.unique(thresh, sorted=True,
                                       return_inverse=True)
        slot_values = torch.zeros((L + P,), dtype=torch.int32, device=dev)
        slot_values[:values.shape[0]] = values
        return (slot_values, slot_of.to(torch.int32),
                torch.tensor([values.shape[0]], dtype=torch.int32,
                             device=dev))
    slot_values = torch.empty((lib.kpw_max_slots(P, L),), dtype=torch.int32,
                              device=dev)
    slot_of = torch.empty((P, L), dtype=torch.int32, device=dev)
    scratch = torch.empty((3 * (L + P) + 1,), dtype=torch.int32, device=dev)
    n_slots = scratch[-1:]
    _check(lib, lib.kpw_threshold_slots(
        _ptr(levels), _ptr(pb_prio), P, L, _ptr(slot_values), _ptr(slot_of),
        _ptr(scratch), _ptr(n_slots), stream), "threshold slots")
    return slot_values, slot_of, n_slots


def _contig(name: str, t: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.contiguous()


class KernelArgs(NamedTuple):
    """The tensor arguments of kpw_class_stats_and_pick, in its order."""

    alloc: torch.Tensor
    requested: torch.Tensor
    pod_count: torch.Tensor
    allowed: torch.Tensor
    ep_req: torch.Tensor
    ep_prio: torch.Tensor
    live: torch.Tensor
    gang_w: Optional[torch.Tensor]
    bounds: torch.Tensor  # i32 [2N + 2] (see _row_csr)
    rows: torch.Tensor  # i32 [M]
    slot_values: torch.Tensor  # i32 [max slots]
    n_slots: torch.Tensor  # i32 [1]
    slot_of: torch.Tensor  # i32 [P, L]
    pb_req: torch.Tensor
    static_ok: torch.Tensor
    stats: torch.Tensor  # i32 [max slots, R + 4, N] scratch


class Prepared(NamedTuple):
    """A what-if with its row lists and slot table built: what
    `whatif_launch` hands the class-stats and pick kernels."""

    lib: ctypes.CDLL
    tensors: Optional[KernelArgs]  # None when P or N is 0
    sizes: tuple  # P, N, R, L, r_fixed, max slots
    stream: Optional[int]
    out: torch.Tensor  # i32 [5, P, N]


def whatif_prepare(w: WhatIf, *, lib=None, stream=None) -> Prepared:
    """Checks the inputs (device, type, shape; contiguous copies where
    needed), builds the kept-row lists and the threshold slots with the
    first three kernels and allocates the stats table and the output.
    `lib` defaults to the nvcc build on the tensors' card."""
    device = w.alloc.device
    N, R = w.alloc.shape
    M = w.ep_node.shape[0]
    P = w.pb_req.shape[0]
    L = w.levels.shape[0]
    f32, i32 = torch.float32, torch.int32
    alloc = _contig("alloc", w.alloc, f32, (N, R), device)
    requested = _contig("requested", w.requested, f32, (N, R), device)
    pod_count = _contig("pod_count", w.pod_count, i32, (N,), device)
    allowed = _contig("allowed_pods", w.allowed_pods, i32, (N,), device)
    ep_node = _contig("ep_node", w.ep_node, i32, (M,), device)
    live = _contig("live", w.live, torch.bool, (M,), device)
    ep_req = _contig("ep_req", w.ep_req, f32, (M, R), device)
    ep_prio = _contig("ep_prio", w.ep_prio, i32, (M,), device)
    gang = (None if w.gang_w is None else
            _contig("gang_w", w.gang_w, f32, (M,), device))
    levels = _contig("levels", w.levels, i32, (L,), device)
    pb_req = _contig("pb_req", w.pb_req, f32, (P, R), device)
    pb_prio = _contig("pb_prio", w.pb_prio, i32, (P,), device)
    static_ok = _contig("static_ok", w.static_ok, torch.bool, (P, N), device)
    if lib is None:
        lib = build()
        stream = torch.cuda.current_stream(device).cuda_stream
    if R > lib.kpw_max_resources():
        raise ValueError(f"preempt_whatif kernel holds at most "
                         f"{lib.kpw_max_resources()} resource columns, "
                         f"got R={R}")
    if max(P * N, M, 2 * N + 2) >= 2**31 or N > 2**29:
        raise ValueError(f"preempt_whatif kernel: P*N={P * N}, M={M}, N={N} "
                         "exceed its int32 indexing")
    out = torch.empty((5, P, N), dtype=i32, device=device)
    if P == 0 or N == 0:
        return Prepared(lib, None, (P, N, R, L, enc.RES_FIXED, 0), stream,
                        out)
    bounds, rows = _row_csr(ep_node, live, ep_req, N, lib, stream)
    slot_values, slot_of, n_slots = threshold_slots(levels, pb_prio,
                                                    lib=lib, stream=stream)
    max_slots = slot_values.shape[0]
    stats = torch.empty((max_slots, R + 4, N), dtype=i32, device=device)
    tensors = KernelArgs(alloc, requested, pod_count, allowed, ep_req,
                         ep_prio, live, gang, bounds, rows, slot_values,
                         n_slots, slot_of, pb_req, static_ok, stats)
    return Prepared(lib, tensors, (P, N, R, L, enc.RES_FIXED, max_slots),
                    stream, out)


def whatif_launch(prep: Prepared) -> torch.Tensor:
    """The class-stats and pick kernels on a prepared what-if -> its
    packed i32 [5, P, N] output (the same tensor each call)."""
    if prep.tensors is not None:
        *ins, stats = prep.tensors
        _check(prep.lib, prep.lib.kpw_class_stats_and_pick(
            *[_ptr(t) for t in ins], *prep.sizes, _ptr(stats),
            _ptr(prep.out), prep.stream), "class stats and pick")
    return prep.out


def preempt_whatif(w: WhatIf) -> torch.Tensor:
    """The what-if -> packed i32 [5, P, N]. CPU tensors take the plain
    version; CUDA tensors launch the kernels (counted once a call in
    `preempt_whatif.launches`) or raise."""
    device = w.alloc.device
    if device.type == "cpu":
        return whatif_plain(w)
    if device.type != "cuda":
        raise ValueError(f"preempt_whatif: unsupported device {device}")
    out = whatif_launch(whatif_prepare(w))
    preempt_whatif.launches += 1
    return out


preempt_whatif.launches = 0


def preemption_stats(nt: enc.NodeTensors, pm: enc.PodMatrix,
                     pb: enc.PodBatch, levels, *, num_levels: int,
                     gang_w=None) -> torch.Tensor:
    """The what-if for a batch of failed pods -> packed i32 [5, P, N]
    (see PreemptStats), on the tensors' device: the kernels on the card,
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
                  free_rows: bool = True, nonfinite: bool = False,
                  sentinels: bool = False, dense: bool = False,
                  device="cuda") -> WhatIf:
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
      columns), and extended resource columns that only some pods ask for;
    * nonfinite=True: inf, -inf and NaN in the requests and gang weights
      of non-live rows (0 * inf is NaN, so such a request changes the sums
      and its row must stay in the kernel's row lists; the gang sum is a
      select, which such a weight does not reach);
    * sentinels=True (N >= 5): node 1's rows all non-live (NEG), nodes 2
      and 3 without rows (INT32_MIN), node 4's only rows live at priority
      INT32_MIN (victims whose max is INT32_MIN), all four with room;
    * dense=True: see `dense_whatif` (M is 110 N).
    P and N need not be multiples of anything."""
    if dense:
        if M != DENSE_ROWS * N:
            raise ValueError(f"a dense world has M = {DENSE_ROWS} N")
        return dense_whatif(P, N, seed, R=R, gang=gang, device=device)
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
    if sentinels:
        if N < 5:
            raise ValueError("sentinels need N >= 5")
        valid[ep_node == 1] = alive[ep_node == 1] = False
        ep_node[(ep_node == 2) | (ep_node == 3)] = 4
        at4 = ep_node == 4
        valid[at4] = alive[at4] = True
        ep_prio[at4] = INT32_MIN
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
    if sentinels:  # room without victims on the sentinel nodes
        alloc[1:5, 0] += 8000
        alloc[1:5, 1:3] += 8 * 2**30
        allowed[1:5] = pod_count[1:5] + 5
        static_ok[:, 1:5] = rng.rand(P, 4) < 0.9
    if nonfinite:
        bad = np.flatnonzero(~alive)
        bad = bad[rng.rand(bad.size) < 0.6]
        odd = np.asarray([np.inf, -np.inf, np.nan], np.float32)
        ep_req[bad, rng.randint(0, R, bad.size)] = rng.choice(odd, bad.size)
        if gang_w is not None:
            gw = bad[rng.rand(bad.size) < 0.5]
            gang_w[gw] = rng.choice(odd, gw.size)
    return _whatif_tensors(alloc, requested, pod_count, allowed, ep_node,
                           alive, ep_req, ep_prio, gang_w, levels, pb_req,
                           pb_prio, static_ok, device)


def _whatif_tensors(alloc, requested, pod_count, allowed, ep_node, alive,
                    ep_req, ep_prio, gang_w, levels, pb_req, pb_prio,
                    static_ok, device) -> WhatIf:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return WhatIf(alloc=t(alloc), requested=t(requested),
                  pod_count=t(pod_count), allowed_pods=t(allowed),
                  ep_node=t(ep_node), live=t(alive), ep_req=t(ep_req),
                  ep_prio=t(ep_prio), gang_w=None if gang_w is None
                  else t(gang_w), levels=t(levels), pb_req=t(pb_req),
                  pb_prio=t(pb_prio), static_ok=t(static_ok))


DENSE_ROWS = 110  # the default allocatable pod count of a node


def dense_whatif(P: int, N: int, seed: int, *, R: int = 4,
                 gang: bool = True, device="cuda") -> WhatIf:
    """A what-if at the kernels' most work: every node full, with
    DENSE_ROWS live rows (pod_count = allowed_pods, so a pod fits only by
    evicting), priorities drawn from 5 000 values, eight distinct levels
    (`victim_levels`), and P distinct pod priorities strictly between the
    first and last level and equal to none, so that the chunk has
    L + P - 1 distinct thresholds: the most any input can have (the top
    level is a threshold only through a pod priority that reaches it,
    which is then not one itself)."""
    rng = np.random.RandomState(seed)
    M = DENSE_ROWS * N
    ep_node = np.repeat(np.arange(N, dtype=np.int32), DENSE_ROWS)
    ep_prio = rng.randint(0, 5000, M).astype(np.int32)
    alive = np.ones(M, bool)
    ep_req = np.zeros((M, R), np.float32)
    ep_req[:, 0] = rng.randint(10, 300, M)
    ep_req[:, 1] = (rng.rand(M) * 3e8 + 1e6).astype(np.float32)
    ep_req[:, 2] = rng.randint(0, 3, M) * 2**28
    if R > 3:
        ep_req[:, 3:] = rng.randint(0, 3, (M, R - 3))
    requested = np.zeros((N, R), np.float64)
    np.add.at(requested, ep_node, ep_req.astype(np.float64))
    requested = requested.astype(np.float32)
    alloc = (requested * rng.uniform(1.0, 1.05, (N, R))).astype(np.float32)
    pod_count = np.full(N, DENSE_ROWS, np.int32)
    allowed = pod_count.copy()
    levels = np.asarray(victim_levels(ep_prio, alive, 8), np.int32)
    pool = sorted(set(range(int(levels[0]) + 1, int(levels[-1])))
                  - {int(v) for v in levels})
    pb_prio = rng.choice(pool, P, replace=False).astype(np.int32)
    pb_req = np.zeros((P, R), np.float32)
    pb_req[:, 0] = rng.randint(100, 3000, P)
    pb_req[:, 1] = (rng.rand(P) * 2e9).astype(np.float32)
    pb_req[:, 2] = rng.randint(0, 2, P) * 2**28
    if R > 3:
        pb_req[:, 3:] = rng.randint(0, 3, (P, R - 3)) * (rng.rand(P, R - 3)
                                                         < 0.3)
    static_ok = rng.rand(P, N) < 0.95
    gang_w = ((rng.rand(M) < 0.4) * rng.choice([1.0, 0.5, 3.0], M)).astype(
        np.float32) if gang else None
    return _whatif_tensors(alloc, requested, pod_count, allowed, ep_node,
                           alive, ep_req, ep_prio, gang_w, levels, pb_req,
                           pb_prio, static_ok, device)


# (P, N, M, random_whatif keywords): P = 1, 16 and 128, N not a multiple
# of 32 and below it, large values and small, with and without gang
# weights, a world with no free row; non-finite values in non-live rows,
# the priority-max sentinels (a node of non-live rows, nodes without
# rows, victims at INT32_MIN), the dense world (L + P - 1 thresholds,
# full nodes), P * N not a multiple of 4 (the pick's scalar stores, as
# with P = 1 and N = 37 or 1), R = 16 and 12 (one and two slots a
# class-stats warp; four at R = 4), nodes of more than 128 kept rows
# (staged in parts) and P = 4 100 (the slot table past shared memory)
EDGE_WORLDS = (
    (1, 37, 64, dict(large=True)),
    (16, 45, 200, dict(large=True, gang=False)),
    (128, 100, 300, dict(large=True)),
    (16, 7, 40, dict(free_rows=False)),
    (128, 33, 128, dict(gang=False)),
    (1, 1, 8, dict(large=True)),
    (16, 41, 400, dict(large=True, nonfinite=True)),
    (128, 37, 300, dict(nonfinite=True)),
    (16, 12, 200, dict(sentinels=True)),
    (128, 12, DENSE_ROWS * 12, dict(dense=True)),
    (3, 41, 150, {}),
    (16, 23, 150, dict(R=16, large=True)),
    (32, 10, DENSE_ROWS * 10, dict(dense=True, R=12)),
    (16, 3, 900, dict(free_rows=False, large=True)),
    (4100, 3, 24, {}),
)
