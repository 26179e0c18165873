"""Host->device cluster snapshot.

Maintains the dense NodeTensors / PodMatrix arrays (ops/encoding.py) as
numpy buffers, updated incrementally from scheduler events, and uploads
dirty groups to the device per scheduling cycle. This replaces the
reference's per-cycle `UpdateNodeNameToInfoMap` snapshot point
(pkg/scheduler/core/generic_scheduler.go:124) — instead of copying a Go
map, we keep the device mirror warm and re-upload only what changed.

Dirtiness is tracked in three groups with very different change rates:
  * resources  (requested/nonzero/pod_count)      — every bind
  * topology   (labels/taints/conds/ports/images) — node lifecycle only
  * pods       (the existing-pod matrix)          — every bind

and, within each group, per ROW: a bind/evict/heartbeat re-uploads only
the touched node/pod/term rows (gathered host rows + an index vector,
written with one `index_copy_` per cached tensor), so steady-state
upload bytes scale with the churn, not the cluster. A whole-group flag
(set by growth, the scrubber's repairs, a compaction or cache
invalidation) or a dirty fraction past DELTA_MAX_FRACTION falls back to
the full upload.

Memory governance (kubernetes_tpu/state/snapshot.py:148-212, :318-396):
every resident group's byte size is kept (`hbm_bytes`), the footprint of
the next full upload is computed from the host arrays
(`projected_hbm_bytes`), and with `hbm_budget_bytes` set a `_grow` that
pushes the projection past the budget demands a compaction
(`compaction_requested`). `_compact` adopts a scratch snapshot rebuilt
from host truth (state/scrubber.py) in place and drops every device
tensor the old arrays backed. The budget and headroom are the JAX
package's byte counts of the host arrays, not an allocator query, so
both packages decide alike.

The cached device tensors are updated IN PLACE by the delta path (the
JAX mirror rebuilds them functionally): a tuple returned by an earlier
`to_device` call sees later row updates. Consumers that mutate usage
(ops/kernel.py) clone first.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api import types as api
from ..ops import encoding as enc
from ..utils import faultpoints
from .node_info import NodeInfo
from .vocab import VocabSet, bucket_size


def _parse_label_num(v: str) -> float:
    try:
        return float(int(v))
    except (ValueError, TypeError):
        return math.nan


# Delta-upload tuning: the dirty-row count buckets to a power of two
# (>= DELTA_MIN_ROWS, padded with duplicate writes of the first row) so
# the per-group scatter program compiles O(log N) variants, not one per
# distinct churn size; a bucketed fraction past DELTA_MAX_FRACTION
# falls back to the whole-group upload (at that point the row
# bookkeeping buys nothing).
DELTA_MAX_FRACTION = 0.5
DELTA_MIN_ROWS = 16

# Caps dims the snapshot itself grows — and a compaction may shrink.
# Every other Caps dim (P, UI, the pod-batch dims...) belongs to the
# featurizer/wave plane and is never touched by _compact.
SNAPSHOT_DIMS = ("N", "Z", "K", "KP", "R", "T", "PP", "NI", "M", "E",
                 "TE", "TV", "TNS", "LV")

# every numpy plane _grow pads and _compact adopts, in _grow order
SNAPSHOT_ARRAYS = (
    "alloc", "requested", "nonzero", "pod_count", "allowed_pods",
    "labels", "label_nums", "taint_key", "taint_val", "taint_effect",
    "cond", "ports", "zone_id", "rack_id", "superpod_id", "accel_gen",
    "img_id", "img_size", "avoid", "valid",
    "ep_labels", "ep_ns", "ep_node", "ep_valid", "ep_alive", "ep_req",
    "ep_prio",
    "t_kind", "t_owner", "t_node", "t_tk", "t_weight", "t_ns", "t_key",
    "t_op", "t_vals", "t_valid")


def _row_update(devs, updates, idx: np.ndarray, device) -> None:
    """Batched row scatter: writes the gathered host rows into every
    tensor of a cached device group at the given indices. The host row
    slices + the index vector are the ONLY host->device transfer. Pad
    entries duplicate the first row's (index, content) pair, so the
    order in which duplicate-index writes land can't matter — every
    duplicate writes identical bytes."""
    idx_t = torch.from_numpy(idx).to(device=device, dtype=torch.int64)
    for d, u in zip(devs, updates):
        d.index_copy_(0, idx_t, torch.from_numpy(u).to(device))


class Snapshot:
    """Mutable numpy mirror + device cache."""

    def __init__(self, vocabs: Optional[VocabSet] = None, caps: Optional[enc.Caps] = None):
        self.vocabs = vocabs or VocabSet()
        self.caps = caps or enc.Caps()
        self.node_index: Dict[str, int] = {}
        self.node_names: List[str] = []
        self._free_nodes: List[int] = []
        self.extended = self.vocabs.resources  # extended resource -> column - RES_FIXED + 1
        self._alloc_nodes()
        # existing-pod matrix
        self.pod_slot: Dict[str, int] = {}
        self._free_slots: List[int] = []
        self._next_slot = 0
        self._alloc_pods()
        # inter-pod affinity term table
        self.term_rows: Dict[str, List[int]] = {}  # pod uid -> row indices
        # uid -> (node_idx, alive, labels) of the last written row; lets
        # add_pod skip the bind-confirmation echo (see add_pod)
        self._pod_sig: Dict[str, tuple] = {}
        self._free_terms: List[int] = []
        self._next_term = 0
        self._alloc_terms()
        # whole-group dirty flags: True forces a full re-upload of the
        # group (set by growth, the scrubber's repairs, and external
        # invalidation). Fine-grained churn goes through _mark_rows
        # instead, so a steady-state bind re-uploads only touched rows.
        self.dirty_resources = True
        self.dirty_topology = True
        self.dirty_pods = True
        # per-group dirty ROW indices ("res"/"topo" over N, "pods" over
        # M, "terms" over E) — the delta-upload input
        self._dirty_rows: Dict[str, set] = {
            "res": set(), "topo": set(), "pods": set(), "terms": set()}
        self._device_cache: Dict[str, object] = {}
        # device telemetry: cumulative host->device upload bytes and the
        # byte size of each resident group — the scheduler exports these
        # as snapshot_upload_bytes_total / snapshot_hbm_bytes
        self.upload_bytes_total = 0
        self._group_bytes: Dict[str, int] = {}
        # the device-memory budget governor: 0 = unlimited. A _grow that
        # pushes the projected footprint past the budget sets
        # compaction_requested (the growth itself proceeds — the rows
        # must land somewhere) and the scheduler's housekeeping compacts
        # before the next round commits the bigger footprint for good.
        self.hbm_budget_bytes = 0
        self.compaction_requested = False
        # node/pod row removals since the last compaction — the cadence
        # trigger's "is there anything to reclaim" signal
        self.removals_since_compact = 0
    def _mark_rows(self, group: str, *rows: int) -> None:
        self._dirty_rows[group].update(rows)

    def _account_upload(self, group: str, arrays) -> None:
        nbytes = sum(int(a.nbytes) for a in arrays)
        self.upload_bytes_total += nbytes
        self._group_bytes[group] = nbytes

    def hbm_bytes(self) -> int:
        """Byte footprint of the device-resident mirror: the cached
        groups' host sizes (the JAX package's unsharded count)."""
        return sum(self._group_bytes.values())

    def projected_hbm_bytes(self) -> int:
        """What the device mirror will occupy after the next full
        upload, computed from the HOST arrays — the governor's check
        input. hbm_bytes() lags until an upload actually lands; a budget
        check against it would admit one over-budget round first."""
        return sum(int(a.nbytes) for g in ("res", "topo", "pods", "terms")
                   for a in self._group_host(g))

    def hbm_headroom_bytes(self) -> Optional[int]:
        """Budget minus projected footprint (negative = over budget),
        None when no budget is configured."""
        if not self.hbm_budget_bytes:
            return None
        return self.hbm_budget_bytes - self.projected_hbm_bytes()

    # ---- allocation / growth ----------------------------------------------

    def _alloc_nodes(self):
        c = self.caps
        self.alloc = np.zeros((c.N, c.R), np.float32)
        self.requested = np.zeros((c.N, c.R), np.float32)
        self.nonzero = np.zeros((c.N, 2), np.float32)
        self.pod_count = np.zeros((c.N,), np.int32)
        self.allowed_pods = np.zeros((c.N,), np.int32)
        self.labels = np.zeros((c.N, c.K), np.int32)
        self.label_nums = np.full((c.N, c.K), np.nan, np.float32)
        self.taint_key = np.zeros((c.N, c.T), np.int32)
        self.taint_val = np.zeros((c.N, c.T), np.int32)
        self.taint_effect = np.zeros((c.N, c.T), np.int32)
        self.cond = np.zeros((c.N, enc.N_COND), bool)
        self.ports = np.zeros((c.N, c.PP), np.int32)
        self.zone_id = np.zeros((c.N,), np.int32)
        # topology + heterogeneity columns (ops/topology.py): rack and
        # superpod ids live in the shared zone vocabulary (hierarchical
        # keys, see api.get_rack_key), so they are bounded by caps.Z
        self.rack_id = np.zeros((c.N,), np.int32)
        self.superpod_id = np.zeros((c.N,), np.int32)
        self.accel_gen = np.zeros((c.N,), np.int32)
        self.img_id = np.zeros((c.N, c.NI), np.int32)
        self.img_size = np.zeros((c.N, c.NI), np.float32)
        self.avoid = np.zeros((c.N,), bool)
        self.valid = np.zeros((c.N,), bool)

    def _alloc_pods(self):
        c = self.caps
        self.ep_labels = np.zeros((c.M, c.KP), np.int32)
        self.ep_ns = np.zeros((c.M,), np.int32)
        self.ep_node = np.zeros((c.M,), np.int32)
        self.ep_valid = np.zeros((c.M,), bool)
        self.ep_alive = np.zeros((c.M,), bool)
        # per-pod resource requests + priority: the device-side
        # preemption what-if subtracts victim rows from node usage
        # (ops/preempt.py; reference selectVictimsOnNode removes pods
        # from the cloned NodeInfo, generic_scheduler.go:898)
        self.ep_req = np.zeros((c.M, c.R), np.float32)
        self.ep_prio = np.zeros((c.M,), np.int32)

    def _alloc_terms(self):
        c = self.caps
        self.t_kind = np.zeros((c.E,), np.int32)
        self.t_owner = np.zeros((c.E,), np.int32)
        self.t_node = np.zeros((c.E,), np.int32)
        self.t_tk = np.zeros((c.E,), np.int32)
        self.t_weight = np.zeros((c.E,), np.float32)
        self.t_ns = np.zeros((c.E, c.TNS), np.int32)
        self.t_key = np.zeros((c.E, c.TE), np.int32)
        self.t_op = np.full((c.E, c.TE), enc.OP_PAD, np.int32)
        self.t_vals = np.full((c.E, c.TE, c.TV), -1, np.int32)
        self.t_valid = np.zeros((c.E,), bool)

    def _grow(self, **dims):
        """Grow capacity dims, preserving data (new tensor shapes: the
        next upload is a full one)."""
        c = self.caps
        for k, v in dims.items():
            setattr(c, k, bucket_size(v, getattr(c, k)))

        def pad(a, shape, fill=0):
            out = np.full(shape, fill, a.dtype)
            sl = tuple(slice(0, s) for s in a.shape)
            out[sl] = a
            return out

        self.alloc = pad(self.alloc, (c.N, c.R))
        self.requested = pad(self.requested, (c.N, c.R))
        self.nonzero = pad(self.nonzero, (c.N, 2))
        self.pod_count = pad(self.pod_count, (c.N,))
        self.allowed_pods = pad(self.allowed_pods, (c.N,))
        self.labels = pad(self.labels, (c.N, c.K))
        self.label_nums = pad(self.label_nums, (c.N, c.K), np.nan)
        self.taint_key = pad(self.taint_key, (c.N, c.T))
        self.taint_val = pad(self.taint_val, (c.N, c.T))
        self.taint_effect = pad(self.taint_effect, (c.N, c.T))
        self.cond = pad(self.cond, (c.N, enc.N_COND))
        self.ports = pad(self.ports, (c.N, c.PP))
        self.zone_id = pad(self.zone_id, (c.N,))
        self.rack_id = pad(self.rack_id, (c.N,))
        self.superpod_id = pad(self.superpod_id, (c.N,))
        self.accel_gen = pad(self.accel_gen, (c.N,))
        self.img_id = pad(self.img_id, (c.N, c.NI))
        self.img_size = pad(self.img_size, (c.N, c.NI))
        self.avoid = pad(self.avoid, (c.N,))
        self.valid = pad(self.valid, (c.N,))
        self.ep_labels = pad(self.ep_labels, (c.M, c.KP))
        self.ep_ns = pad(self.ep_ns, (c.M,))
        self.ep_node = pad(self.ep_node, (c.M,))
        self.ep_valid = pad(self.ep_valid, (c.M,))
        self.ep_alive = pad(self.ep_alive, (c.M,))
        self.ep_req = pad(self.ep_req, (c.M, c.R))
        self.ep_prio = pad(self.ep_prio, (c.M,))
        self.t_kind = pad(self.t_kind, (c.E,))
        self.t_owner = pad(self.t_owner, (c.E,))
        self.t_node = pad(self.t_node, (c.E,))
        self.t_tk = pad(self.t_tk, (c.E,))
        self.t_weight = pad(self.t_weight, (c.E,))
        self.t_ns = pad(self.t_ns, (c.E, c.TNS))
        self.t_key = pad(self.t_key, (c.E, c.TE))
        self.t_op = pad(self.t_op, (c.E, c.TE), enc.OP_PAD)
        self.t_vals = pad(self.t_vals, (c.E, c.TE, c.TV), -1)
        self.t_valid = pad(self.t_valid, (c.E,))
        # realloc: every dirty row range is void (the cached device
        # arrays have the old shapes) — whole-group flags take over
        self.dirty_resources = self.dirty_topology = self.dirty_pods = True
        for rows in self._dirty_rows.values():
            rows.clear()
        # the budget governor: over-budget growth demands a compaction
        # instead of letting the next upload hit the card's allocator
        if self.hbm_budget_bytes and \
                self.projected_hbm_bytes() > self.hbm_budget_bytes:
            self.compaction_requested = True

    def has_staged_rows(self) -> bool:
        """True while any pipeline-staged pod row is outstanding. A
        compaction renumbers every row index, but a round holds staged
        pm_rows/term_rows by INDEX — compacting under them would scatter
        placements into the wrong rows, so callers must defer (or
        unstage first)."""
        return any(sig[0] == "staged" for sig in self._pod_sig.values())

    def _compact(self, scratch: "Snapshot", force: bool = False
                 ) -> Dict[str, Tuple[int, int]]:
        """Adopt a freshly-rebuilt scratch snapshot in place — the
        inverse of _grow (kubernetes_tpu/state/snapshot.py:336-396). The
        scratch (built by the scrubber from host truth against a FRESH
        VocabSet) holds the same live rows densely renumbered with
        freshly-assigned vocab ids; this step swaps its arrays,
        registries and vocabularies into the live snapshot.

        Shrink hysteresis: a dim only shrinks when its rebuilt bucket is
        at most HALF the current one, so a grow right after a cadence
        compaction cannot thrash the tensor shapes. force=True
        (governor/OOM demand) takes any smaller bucket. Dims that don't
        shrink are re-grown on the scratch to the live bucket first.

        Every device tensor the old arrays backed is dropped with the
        device cache (nothing else in the package holds one across a
        round), so the card's memory is freed once the caller lets go of
        the tensors of its last to_device. Returns {dim: (old, new)} for
        every dim that shrank. Vocab identity is preserved (adopt_all
        rewrites contents in place) and the generation bump invalidates
        every featurizer cache."""
        assert not self.has_staged_rows(), \
            "compaction with staged rows outstanding"
        regrow: Dict[str, int] = {}
        shrunk: Dict[str, Tuple[int, int]] = {}
        for d in SNAPSHOT_DIMS:
            cur = getattr(self.caps, d)
            tgt = getattr(scratch.caps, d)
            if tgt >= cur:
                continue
            if (tgt < cur) if force else (tgt * 2 <= cur):
                shrunk[d] = (cur, tgt)
            else:
                regrow[d] = cur
        if regrow:
            scratch._grow(**regrow)
        self.vocabs.adopt_all(scratch.vocabs)
        for d in SNAPSHOT_DIMS:
            setattr(self.caps, d, getattr(scratch.caps, d))
        for name in SNAPSHOT_ARRAYS:
            setattr(self, name, getattr(scratch, name))
        self.node_index = dict(scratch.node_index)
        self.node_names = list(scratch.node_names)
        self._free_nodes = list(scratch._free_nodes)
        self.pod_slot = dict(scratch.pod_slot)
        self._free_slots = list(scratch._free_slots)
        self._next_slot = scratch._next_slot
        self.term_rows = {uid: list(rows)
                          for uid, rows in scratch.term_rows.items()}
        self._free_terms = list(scratch._free_terms)
        self._next_term = scratch._next_term
        self._pod_sig = dict(scratch._pod_sig)
        # everything the device holds is now stale: full re-upload
        self.dirty_resources = self.dirty_topology = self.dirty_pods = True
        for rows in self._dirty_rows.values():
            rows.clear()
        self._device_cache.clear()
        self._group_bytes.clear()
        self.compaction_requested = False
        self.removals_since_compact = 0
        return shrunk

    # ---- resource columns ---------------------------------------------------

    def _res_col(self, name: str) -> int:
        col = enc.RES_FIXED - 1 + self.extended.intern(name)
        if col >= self.caps.R:
            self._grow(R=col + 1)
        return col

    def _res_vec(self, r) -> np.ndarray:
        """node_info.Resource -> f32 row of width caps.R."""
        cols = [(self._res_col(name), q) for name, q in r.scalars.items()]
        out = np.zeros((self.caps.R,), np.float32)  # after growth from _res_col
        out[enc.RES_CPU] = r.milli_cpu
        out[enc.RES_MEM] = r.memory
        out[enc.RES_EPH] = r.ephemeral_storage
        for col, q in cols:
            out[col] = q
        return out

    # ---- node events --------------------------------------------------------

    def ensure_node(self, name: str) -> int:
        idx = self.node_index.get(name)
        if idx is None:
            if self._free_nodes:
                idx = self._free_nodes.pop()
                self.node_names[idx] = name
            else:
                idx = len(self.node_names)
                if idx >= self.caps.N:
                    self._grow(N=idx + 1)
                self.node_names.append(name)
            self.node_index[name] = idx
        return idx

    def set_node(self, ni: NodeInfo):
        """Refresh a node's topology + allocatable row from its NodeInfo."""
        node = ni.node
        assert node is not None
        idx = self.ensure_node(node.name)
        v = self.vocabs
        # labels
        lbls = node.metadata.labels or {}
        for key in lbls:
            kid = v.label_keys.intern(key)
            if kid >= self.caps.K:
                self._grow(K=kid + 1)
        self.labels[idx, :] = 0
        self.label_nums[idx, :] = np.nan
        for key, val in lbls.items():
            kid = v.label_keys.intern(key)
            self.labels[idx, kid] = v.label_values.intern(val)
            self.label_nums[idx, kid] = _parse_label_num(val)
        # taints
        if len(ni.taints) > self.caps.T:
            self._grow(T=len(ni.taints))
        self.taint_key[idx, :] = 0
        self.taint_val[idx, :] = 0
        self.taint_effect[idx, :] = 0
        for i, t in enumerate(ni.taints):
            self.taint_key[idx, i] = v.taint_keys.intern(t.key)
            self.taint_val[idx, i] = v.taint_values.intern(t.value)
            self.taint_effect[idx, i] = enc.EFFECT_IDS[t.effect]
        # conditions
        # Reference iterates only *present* conditions (predicates.go:1591):
        # a node that hasn't reported Ready at all is NOT rejected.
        cond = NodeInfo._cond
        ready = cond(node, api.NODE_READY)
        self.cond[idx, enc.COND_NOT_READY] = ready not in ("", api.COND_TRUE)
        self.cond[idx, enc.COND_OUT_OF_DISK] = (
            cond(node, api.NODE_OUT_OF_DISK) not in ("", api.COND_FALSE)
        )
        self.cond[idx, enc.COND_NET_UNAVAIL] = (
            cond(node, api.NODE_NETWORK_UNAVAILABLE) not in ("", api.COND_FALSE)
        )
        self.cond[idx, enc.COND_UNSCHEDULABLE] = node.spec.unschedulable
        self.cond[idx, enc.COND_MEM_PRESSURE] = ni.memory_pressure
        self.cond[idx, enc.COND_DISK_PRESSURE] = ni.disk_pressure
        self.cond[idx, enc.COND_PID_PRESSURE] = ni.pid_pressure
        # allocatable
        self.alloc[idx, :] = self._res_vec(ni.allocatable)
        self.allowed_pods[idx] = ni.allocatable.allowed_pod_number
        # zone
        zk = api.get_zone_key(node)
        zid = v.zones.intern(zk) if zk else 0
        if zid >= self.caps.Z:
            self._grow(Z=zid + 1)
        self.zone_id[idx] = zid
        # rack / superpod: interned into the SAME zone vocabulary with
        # hierarchical keys ("sp:<v>", "sp:<v>/rk:<r>"), so both ids stay
        # under caps.Z and every topology segment-sum reuses num_zones as
        # its segment count — no new static kernel args
        spk = api.get_superpod_key(node)
        spid = v.zones.intern(spk) if spk else 0
        rk = api.get_rack_key(node)
        rid = v.zones.intern(rk) if rk else 0
        top = max(spid, rid)
        if top >= self.caps.Z:
            self._grow(Z=top + 1)
        self.superpod_id[idx] = spid
        self.rack_id[idx] = rid
        self.accel_gen[idx] = api.get_accel_gen(node)
        # images
        imgs = list(ni.image_sizes.items())
        if len(imgs) > self.caps.NI:
            imgs = imgs[: self.caps.NI]  # overflow images simply don't score
        self.img_id[idx, :] = 0
        self.img_size[idx, :] = 0.0
        for i, (name_, sz) in enumerate(imgs):
            self.img_id[idx, i] = v.images.intern(name_)
            self.img_size[idx, i] = sz
        # prefer-avoid annotation (simplified: presence only; see ops/scores.py)
        self.avoid[idx] = "scheduler.alpha.kubernetes.io/preferAvoidPods" in (
            node.metadata.annotations or {}
        )
        self.valid[idx] = True
        self.refresh_node_resources(ni)
        self._mark_rows("topo", idx)

    def remove_node(self, name: str):
        idx = self.node_index.pop(name, None)
        if idx is not None:
            # the row is freed but every label/zone/image string this
            # node interned stays in the vocabularies until a compaction
            # rebuilds them: count the garbage for the cadence trigger
            self.removals_since_compact += 1
            self.valid[idx] = False
            self._free_nodes.append(idx)
            # Drop this node's rows from the pod matrix so a future node
            # reusing the index doesn't inherit ghost pods in spreading.
            stale = (self.ep_node == idx) & self.ep_valid
            if stale.any():
                self.ep_valid[stale] = False
                self.ep_alive[stale] = False
                self._mark_rows("pods", *np.flatnonzero(stale).tolist())
                for uid, slot in list(self.pod_slot.items()):
                    if stale[slot]:
                        del self.pod_slot[uid]
                        # sig must die with the row: a node flap that
                        # reuses this node index would otherwise make
                        # add_pod's echo-skip treat the re-delivered pod
                        # as already written and drop it forever
                        self._pod_sig.pop(uid, None)
                        self._free_slots.append(slot)
                        self._clear_pod_terms(uid)
            self._mark_rows("topo", idx)

    def refresh_node_resources(self, ni: NodeInfo):
        """Fast path run on every (un)bind: just the resource aggregates."""
        if ni.node is None:
            return
        idx = self.node_index.get(ni.node.name)
        if idx is None:
            return
        self.requested[idx, :] = self._res_vec(ni.requested)
        self.nonzero[idx, 0] = ni.nonzero_milli_cpu
        self.nonzero[idx, 1] = ni.nonzero_memory
        self.pod_count[idx] = len(ni.pods)
        # used host ports
        up = list(ni.used_ports)
        if len(up) > self.caps.PP:
            self._grow(PP=len(up))
        self.ports[idx, :] = 0
        for i, (proto, _ip, port) in enumerate(up):
            self.ports[idx, i] = self.vocabs.port_id(proto, port)
        self._mark_rows("res", idx)
        # chaos seam: fires AFTER the row write so a `corrupt`-mode
        # fault leaves a silently-divergent row for the scrubber to
        # catch; one dict check when no faults are armed
        faultpoints.fire("snapshot.write", payload=(self, idx))

    # ---- existing-pod matrix ------------------------------------------------

    def _alloc_slot(self, uid: str) -> int:
        slot = self.pod_slot.get(uid)
        if slot is None:
            if self._free_slots:
                slot = self._free_slots.pop()
            else:
                slot = self._next_slot
                self._next_slot += 1
                if slot >= self.caps.M:
                    self._grow(M=slot + 1)
            self.pod_slot[uid] = slot
        return slot

    def _write_pod_row(self, pod: api.Pod, slot: int, node_idx: int,
                       active: bool):
        v = self.vocabs
        for key in pod.metadata.labels or {}:
            kid = v.pod_label_keys.intern(key)
            if kid >= self.caps.KP:
                self._grow(KP=kid + 1)
        self.ep_labels[slot, :] = 0
        for key, val in (pod.metadata.labels or {}).items():
            self.ep_labels[slot, v.pod_label_keys.intern(key)] = v.label_values.intern(val)
        self.ep_ns[slot] = v.namespaces.intern(pod.namespace)
        self.ep_node[slot] = node_idx
        self.ep_valid[slot] = active
        from .node_info import Resource

        self.ep_req[slot, :] = self._res_vec(
            Resource.from_map(api.get_resource_request(pod)))
        self.ep_prio[slot] = api.pod_priority(pod)
        self.ep_alive[slot] = (active
                               and pod.metadata.deletion_timestamp is None)

    def _row_sig(self, pod: api.Pod, node_idx):
        """Row-content signature for bind-echo/staged-row detection.
        node_idx is an int placement or the sentinel "staged"; both the
        staging and commit sites MUST build sigs through this helper or
        the staged fast path silently stops matching."""
        return (node_idx, pod.metadata.deletion_timestamp is None,
                tuple(sorted((pod.metadata.labels or {}).items())))

    def add_pod(self, pod: api.Pod):
        """Add/refresh a scheduled pod's row in the PodMatrix."""
        node_idx = self.node_index.get(pod.spec.node_name)
        if node_idx is None:
            return
        # bind-confirmation echo: the informer re-delivers the pod the
        # commit just wrote. Labels and placement unchanged -> the row
        # (and term rows — pod affinity is spec-immutable in the API) is
        # already exact; skipping avoids rewriting every row twice per
        # bind and re-marking the device mirror dirty
        sig = self._row_sig(pod, node_idx)
        prev = self._pod_sig.get(pod.uid)
        if prev == sig:
            return
        if prev == self._row_sig(pod, "staged"):
            # pipeline-staged row being activated at commit: labels and
            # term programs were already written at stage time (affinity
            # is spec-immutable), only placement/validity change — skip
            # re-interning labels and recompiling term selectors
            slot = self.pod_slot[pod.uid]
            self.ep_node[slot] = node_idx
            self.ep_valid[slot] = True
            self.ep_alive[slot] = sig[1]
            self._mark_rows("pods", slot)
            for row in self.term_rows.get(pod.uid, ()):
                self.t_node[row] = node_idx
                self.t_valid[row] = True
                self._mark_rows("terms", row)
            self._pod_sig[pod.uid] = sig
            return
        slot = self._alloc_slot(pod.uid)
        self._write_pod_row(pod, slot, node_idx, active=True)
        self._set_pod_terms(pod, slot, node_idx)
        self._pod_sig[pod.uid] = sig
        self._mark_rows("pods", slot)

    def stage_pending(self, pods) -> Tuple[np.ndarray, np.ndarray]:
        """Pre-stage pending pods into the PodMatrix/TermTable with
        valid=False rows: labels, namespaces, and term programs are
        written now so the device-resident pipeline
        (ops/kernel.py schedule_round) can flip validity and set
        node indices on device as placements happen — no host roundtrip
        between waves. Returns (pm_rows i32 [n], term_rows i32 [n, TPP],
        -1 pads). Slots stay registered to the pod uid: the post-fetch
        host commit's add_pod() reuses them; unstage() frees rows of
        pods that didn't place."""
        n = len(pods)
        pm_rows = np.full(max(n, 1), -1, np.int32)
        per_pod_terms: List[List[int]] = []
        for i, pod in enumerate(pods):
            slot = self._alloc_slot(pod.uid)
            # staged alive=True: anti-affinity of later waves must see it
            # once placed (the device only flips valid/node)
            self._write_pod_row(pod, slot, node_idx=0, active=False)
            self.ep_alive[slot] = pod.metadata.deletion_timestamp is None
            self._mark_rows("pods", slot)
            pm_rows[i] = slot
            self._set_pod_terms(pod, slot, node_idx=0, active=False)
            per_pod_terms.append(list(self.term_rows.get(pod.uid, ())))
            # mark the row as staged so the commit-time add_pod can take
            # the fast activate path instead of rewriting it
            self._pod_sig[pod.uid] = self._row_sig(pod, "staged")
        tpp = max([len(t) for t in per_pod_terms] + [1])
        term_rows = np.full((max(n, 1), tpp), -1, np.int32)
        for i, rows in enumerate(per_pod_terms):
            term_rows[i, :len(rows)] = rows
        return pm_rows, term_rows

    def unstage(self, pod: api.Pod):
        """Free the staged rows of a pod the pipeline did not place."""
        self.remove_pod(pod)

    def remove_pod(self, pod: api.Pod):
        self.remove_pod_by_uid(pod.uid)

    def remove_pod_by_uid(self, uid: str):
        """Row removal keyed by uid alone — the scrubber drops ghost
        rows whose pod object the host cache no longer holds."""
        slot = self.pod_slot.pop(uid, None)
        self._pod_sig.pop(uid, None)
        if slot is not None:
            self.removals_since_compact += 1
            self.ep_valid[slot] = False
            self.ep_alive[slot] = False
            self._free_slots.append(slot)
            self._clear_pod_terms(uid)
            self._mark_rows("pods", slot)

    # ---- inter-pod affinity term table --------------------------------------

    def label_key_col(self, key: str) -> int:
        """Intern a node-label key (e.g. an affinity topologyKey), growing
        the label matrix so the column is addressable."""
        kid = self.vocabs.label_keys.intern(key)
        if kid >= self.caps.K:
            self._grow(K=kid + 1)
        return kid

    def compile_term_selector(self, selector) -> Optional[List[Tuple[int, int, List[int]]]]:
        """LabelSelector -> [(key, op, vals)] over pod-label space, interning.
        None selector matches nothing (LabelSelectorAsSelector(nil) ->
        labels.Nothing(), apimachinery meta/v1/helpers.go)."""
        if selector is None:
            return None
        v = self.vocabs
        out: List[Tuple[int, int, List[int]]] = []
        for r in selector.to_selector().requirements:
            kid = v.pod_label_keys.intern(r.key)
            if kid >= self.caps.KP:
                self._grow(KP=kid + 1)
            vals = [v.label_values.intern(val) for val in r.values]
            out.append((kid, enc.op_id(r.op), vals))
        return out

    def _iter_pod_terms(self, pod: api.Pod):
        """(kind, weight, PodAffinityTerm) for every term the pod carries."""
        aff = pod.spec.affinity
        if aff is None:
            return
        if aff.pod_affinity is not None:
            for t in aff.pod_affinity.required:
                yield enc.TERM_REQ_AFF, 1.0, t
            for wt in aff.pod_affinity.preferred:
                yield enc.TERM_PREF_AFF, float(wt.weight), wt.pod_affinity_term
        if aff.pod_anti_affinity is not None:
            for t in aff.pod_anti_affinity.required:
                yield enc.TERM_REQ_ANTI, 1.0, t
            for wt in aff.pod_anti_affinity.preferred:
                yield enc.TERM_PREF_ANTI, float(wt.weight), wt.pod_affinity_term

    def _set_pod_terms(self, pod: api.Pod, slot: int, node_idx: int,
                       active: bool = True):
        self._clear_pod_terms(pod.uid)
        terms = list(self._iter_pod_terms(pod))
        if not terms:
            return
        v = self.vocabs
        rows: List[int] = []
        for kind, weight, term in terms:
            prog = self.compile_term_selector(term.label_selector)
            ns_ids = ([v.namespaces.intern(n) for n in term.namespaces]
                      if term.namespaces else [v.namespaces.intern(pod.namespace)])
            if len(ns_ids) > self.caps.TNS:
                self._grow(TNS=len(ns_ids))
            if prog is not None:
                if len(prog) > self.caps.TE:
                    self._grow(TE=len(prog))
                if any(len(vals) > self.caps.TV for _, _, vals in prog):
                    self._grow(TV=max(len(vals) for _, _, vals in prog))
            if self._free_terms:
                row = self._free_terms.pop()
            else:
                row = self._next_term
                self._next_term += 1
                if row >= self.caps.E:
                    self._grow(E=row + 1)
            c = self.caps
            self.t_kind[row] = kind
            self.t_owner[row] = slot
            self.t_node[row] = node_idx
            # empty topologyKey: only legal for preferred anti-affinity in the
            # reference (validation); a 0 id never matches any topology.
            self.t_tk[row] = self.label_key_col(term.topology_key) if term.topology_key else 0
            self.t_weight[row] = weight
            self.t_ns[row, :] = 0
            self.t_ns[row, : len(ns_ids)] = ns_ids
            self.t_key[row, :] = 0
            self.t_op[row, :] = enc.OP_PAD
            self.t_vals[row, :, :] = -1
            if prog is None:
                self.t_op[row, 0] = enc.OP_FALSE  # nil selector matches nothing
            else:
                for i, (kid, op, vals) in enumerate(prog):
                    self.t_key[row, i] = kid
                    self.t_op[row, i] = op
                    self.t_vals[row, i, : len(vals)] = vals
            self.t_valid[row] = active
            self._mark_rows("terms", row)
            rows.append(row)
        self.term_rows[pod.uid] = rows

    def _clear_pod_terms(self, uid: str):
        for row in self.term_rows.pop(uid, ()):
            self.t_valid[row] = False
            self.t_kind[row] = enc.TERM_PAD
            self.t_op[row, :] = enc.OP_PAD
            self._free_terms.append(row)
            self._mark_rows("terms", row)

    @property
    def has_affinity_terms(self) -> bool:
        return bool(self.term_rows)

    @property
    def num_label_values(self) -> int:
        """Bucketed label-value vocab size — the segment count for
        topology-domain anchoring in ops/affinity.py."""
        if self.vocabs.label_values.size > self.caps.LV:
            self.caps.LV = bucket_size(self.vocabs.label_values.size, self.caps.LV)
        return self.caps.LV

    # ---- device views -------------------------------------------------------

    def node_tensors(self) -> enc.NodeTensors:
        return enc.NodeTensors(
            alloc=self.alloc, requested=self.requested, nonzero=self.nonzero,
            pod_count=self.pod_count, allowed_pods=self.allowed_pods,
            labels=self.labels, label_nums=self.label_nums,
            taint_key=self.taint_key, taint_val=self.taint_val,
            taint_effect=self.taint_effect, cond=self.cond, ports=self.ports,
            zone_id=self.zone_id, rack_id=self.rack_id,
            superpod_id=self.superpod_id, accel_gen=self.accel_gen,
            img_id=self.img_id, img_size=self.img_size,
            avoid=self.avoid, valid=self.valid,
        )

    def pod_matrix(self) -> enc.PodMatrix:
        return enc.PodMatrix(
            labels=self.ep_labels, ns=self.ep_ns, node=self.ep_node,
            valid=self.ep_valid, alive=self.ep_alive, req=self.ep_req,
            prio=self.ep_prio,
        )

    def host_tensors(self) -> Tuple[enc.NodeTensors, enc.PodMatrix, enc.TermTable]:
        """Host-side views: the SAME numpy planes the device upload
        reads, zero-copy. Callers must treat them as read-only."""
        return self.node_tensors(), self.pod_matrix(), self.term_table()

    def term_table(self) -> enc.TermTable:
        return enc.TermTable(
            kind=self.t_kind, owner=self.t_owner, node=self.t_node,
            tk=self.t_tk, weight=self.t_weight, ns=self.t_ns,
            key=self.t_key, op=self.t_op, vals=self.t_vals, valid=self.t_valid,
        )

    def _group_host(self, key: str) -> tuple:
        """The host arrays of one device group, in cache-tuple order
        (every array's axis 0 is the group's row domain: N, M, or E)."""
        if key == "res":
            return (self.requested, self.nonzero, self.pod_count, self.ports)
        if key == "topo":
            return (self.alloc, self.allowed_pods, self.labels,
                    self.label_nums, self.taint_key, self.taint_val,
                    self.taint_effect, self.cond, self.zone_id, self.rack_id,
                    self.superpod_id, self.accel_gen, self.img_id,
                    self.img_size, self.avoid, self.valid)
        if key == "pods":
            return (self.ep_labels, self.ep_ns, self.ep_node, self.ep_valid,
                    self.ep_alive, self.ep_req, self.ep_prio)
        return (self.t_kind, self.t_owner, self.t_node, self.t_tk,
                self.t_weight, self.t_ns, self.t_key, self.t_op,
                self.t_vals, self.t_valid)

    @staticmethod
    def _delta_rows(rows: set, total: int):
        """Dirty row indices -> a power-of-two-bucketed i32 index vector
        (pads duplicate the first index), or None when the bucketed
        fraction makes a full upload cheaper. Index-based scatter —
        not contiguous ranges — because real churn is scattered: a
        trickle round's binds land on spread-scored nodes all over the
        cluster."""
        k = len(rows)
        kb = min(max(DELTA_MIN_ROWS, 1 << (k - 1).bit_length()), total)
        if kb > DELTA_MAX_FRACTION * total:
            return None
        srt = sorted(rows)
        idx = np.full((kb,), srt[0], np.int32)
        idx[:k] = srt
        return idx

    def _sync_group(self, key: str, device: torch.device,
                    full_dirty: bool) -> None:
        """Bring one cached device group up to date: nothing when clean,
        a gathered-row delta scatter when the churn is sparse, the whole
        group otherwise."""
        cache = self._device_cache
        host = self._group_host(key)
        rows = self._dirty_rows[key]
        if key in cache and not full_dirty:
            if not rows:
                return
            idx = self._delta_rows(rows, host[0].shape[0])
            if idx is not None:
                updates = tuple(np.ascontiguousarray(a[idx]) for a in host)
                _row_update(cache[key], updates, idx, device)
                self.upload_bytes_total += (
                    sum(int(u.nbytes) for u in updates) + int(idx.nbytes))
                rows.clear()
                return
        self._account_upload(key, host)
        # copy=True: on a CPU device the tensor must not alias the host
        # mirror, or later host writes would leak into it unsynced
        cache[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)
            for a in host)
        rows.clear()

    def invalidate_device(self) -> None:
        """Forget the device copy: the next to_device uploads every group
        whole (the scheduler's breaker recovery — nothing incremental is
        trusted across a device fault)."""
        self._device_cache.clear()

    def to_device(self, device=None
                  ) -> Tuple[enc.NodeTensors, enc.PodMatrix, enc.TermTable]:
        """Upload dirty groups (whole, or just the touched rows); reuse
        cached device tensors otherwise. device=None means the CUDA
        card, and raises where there is none (enc.resolve_device);
        switching devices invalidates the cache."""
        device = enc.resolve_device(device)
        cache = self._device_cache
        shapes_key = (self.caps.N, self.caps.K, self.caps.KP, self.caps.R,
                      self.caps.T, self.caps.PP, self.caps.NI, self.caps.M,
                      self.caps.E, self.caps.TE, self.caps.TV, self.caps.TNS)
        if cache.get("shapes") != shapes_key or cache.get("device") != device:
            cache.clear()
            self._group_bytes.clear()
            cache["shapes"] = shapes_key
            cache["device"] = device
            self.dirty_resources = self.dirty_topology = self.dirty_pods = True
            for rows in self._dirty_rows.values():
                rows.clear()
        self._sync_group("res", device, self.dirty_resources)
        self._sync_group("topo", device, self.dirty_topology)
        self._sync_group("pods", device, self.dirty_pods)
        self._sync_group("terms", device, self.dirty_pods)
        self.dirty_resources = self.dirty_topology = self.dirty_pods = False
        requested, nonzero, pod_count, ports = cache["res"]
        (alloc, allowed_pods, labels, label_nums, taint_key, taint_val,
         taint_effect, cond, zone_id, rack_id, superpod_id, accel_gen,
         img_id, img_size, avoid, valid) = cache["topo"]
        (ep_labels, ep_ns, ep_node, ep_valid, ep_alive, ep_req,
         ep_prio) = cache["pods"]
        (t_kind, t_owner, t_node, t_tk, t_weight, t_ns, t_key, t_op, t_vals,
         t_valid) = cache["terms"]
        nt = enc.NodeTensors(
            alloc=alloc, requested=requested, nonzero=nonzero,
            pod_count=pod_count, allowed_pods=allowed_pods, labels=labels,
            label_nums=label_nums, taint_key=taint_key, taint_val=taint_val,
            taint_effect=taint_effect, cond=cond, ports=ports, zone_id=zone_id,
            rack_id=rack_id, superpod_id=superpod_id, accel_gen=accel_gen,
            img_id=img_id, img_size=img_size, avoid=avoid, valid=valid,
        )
        pm = enc.PodMatrix(labels=ep_labels, ns=ep_ns, node=ep_node,
                           valid=ep_valid, alive=ep_alive, req=ep_req,
                           prio=ep_prio)
        tt = enc.TermTable(kind=t_kind, owner=t_owner, node=t_node, tk=t_tk,
                           weight=t_weight, ns=t_ns, key=t_key, op=t_op,
                           vals=t_vals, valid=t_valid)
        return nt, pm, tt
