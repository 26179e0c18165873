"""Self-healing snapshot scrubber: audit the device mirror against host
truth, and compact it.

A copy of kubernetes_tpu/state/scrubber.py for the port's Snapshot
(its device tensors are torch tensors, dropped with the device cache).

Analog of the 1.11 reference's cache comparer
(pkg/scheduler/factory/cache_comparer.go: SIGUSR2 dumps a diff between
the scheduler cache and apiserver truth). Here the stakes are higher
than a log line: the batched feasibility pass computes over the dense
`Snapshot` tensors, so ONE silently-divergent node row — a missed
incremental update, a bit of f32 state corrupted by a faulting device
path — poisons every subsequent wave for every pod. The scrubber
therefore goes beyond the reference's compare-and-log:

  1. GOLDEN ROWS — every host-cache NodeInfo is re-featurized through
     the same `Snapshot.set_node` / `refresh_node_resources` encoding
     into a scratch snapshot that shares the live vocabularies (so
     interned ids line up), giving byte-comparable golden rows.
  2. COMPARE — resources (requested/nonzero/pod_count/ports), topology
     (allocatable, labels, taints, conditions, zone, images, avoid),
     and the existing-pod matrix (placement, validity, per-pod request
     rows, priority, liveness) are diffed per node; ghost rows (nodes or
     pods the host cache no longer knows) are flagged too.
  3. REPAIR — divergent node rows are rewritten in place via
     `set_node` (which refreshes resources as well); divergent pod rows
     are re-added (their bind-echo signature is dropped first so
     `add_pod` cannot skip the rewrite); ghosts are removed. Repairs
     mark the dirty rows, so the next upload carries corrected rows.

Triggers match cache_comparer.go: a signal (SIGUSR2 by default, via
`install_signal`) and an optional periodic cadence, both drained by the
scheduler's housekeeping step under the scheduler lock. Emits the
`snapshot_scrub_*` metric series.

Compaction (vocab mark-and-sweep and bucket shrink): `compact` rebuilds
a scratch snapshot from host truth against a FRESH VocabSet and adopts
it in place (Snapshot._compact), on the `compact_period` cadence when
rows were removed since the last sweep, on the budget governor's demand,
or on the scheduler's capacity-fault ladder.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from ..api import types as api
from ..utils import faultpoints
from .node_info import NodeInfo, Resource
from .snapshot import SNAPSHOT_DIMS, Snapshot
from .vocab import VocabSet


@dataclass
class Divergence:
    """One divergent row: which node (or pod uid) and which field group."""

    node: str
    fields: List[str]
    repaired: bool = False


@dataclass
class ScrubReport:
    nodes_checked: int = 0
    pods_checked: int = 0
    divergences: List[Divergence] = field(default_factory=list)
    repaired: int = 0
    duration: float = 0.0

    @property
    def clean(self) -> bool:
        return not self.divergences

    def summary(self) -> str:
        if self.clean:
            return (f"scrub clean: {self.nodes_checked} nodes, "
                    f"{self.pods_checked} pods")
        what = "; ".join(f"{d.node}: {','.join(d.fields)}"
                         for d in self.divergences)
        return (f"scrub found {len(self.divergences)} divergent rows "
                f"({self.repaired} repaired): {what}")


# node-row field groups compared 1:1 between golden and live arrays
_RESOURCE_FIELDS = ("requested", "nonzero", "pod_count")
_TOPOLOGY_FIELDS = ("alloc", "allowed_pods", "labels", "label_nums",
                    "taint_key", "taint_val", "taint_effect", "cond",
                    "zone_id", "rack_id", "superpod_id", "accel_gen",
                    "avoid")


def _rows_equal(a, b, fill=0) -> bool:
    """Compare two rows, padding the shorter to the longer's shape with
    `fill` — the scratch snapshot may have grown a cap (a label key the
    live snapshot never interned is itself a divergence, surfaced by the
    padded compare) — NaN-tolerant for the label_nums plane."""
    a = np.atleast_1d(np.asarray(a))
    b = np.atleast_1d(np.asarray(b))
    if a.shape != b.shape:
        shape = tuple(max(x, y) for x, y in zip(a.shape, b.shape))

        def pad(arr):
            out = np.full(shape, fill, arr.dtype)
            out[tuple(slice(0, s) for s in arr.shape)] = arr
            return out

        a, b = pad(a), pad(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return bool(np.array_equal(a.astype(np.float64),
                                   b.astype(np.float64), equal_nan=True))
    return bool(np.array_equal(a, b))


class SnapshotScrubber:
    def __init__(self, cache, snapshot: Snapshot, metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 period: Optional[float] = None,
                 lock: Optional[threading.RLock] = None,
                 compact_period: Optional[float] = None):
        self.cache = cache
        self.snapshot = snapshot
        self.metrics = metrics
        self.clock = clock
        self.period = period  # None/0 disables the cadence trigger
        self.compact_period = compact_period  # None/0 disables cadence
        self._lock = lock or threading.RLock()
        self._requested = False
        self._last_run = clock()
        self._last_compact = clock()
        self.last_report: Optional[ScrubReport] = None
        self.last_compaction: Optional[dict] = None

    # -- triggers -------------------------------------------------------------

    def request(self) -> None:
        """Flag a scrub for the next housekeeping pass. Signal-safe: no
        locks, no allocation — the handler context allows nothing more."""
        self._requested = True

    def install_signal(self, signum=None) -> bool:
        """Install a SIGUSR2 handler that requests a scrub, mirroring
        cache_comparer.go's trigger. Returns False where handlers can't
        be installed (non-main thread, platforms without SIGUSR2)."""
        import signal as _signal

        if signum is None:
            signum = getattr(_signal, "SIGUSR2", None)
            if signum is None:
                return False
        try:
            _signal.signal(signum, lambda *_: self.request())
            return True
        except ValueError:
            return False

    def due(self) -> bool:
        if self._requested:
            return True
        return bool(self.period) and \
            self.clock() - self._last_run >= self.period

    def maybe_scrub(self) -> Optional[ScrubReport]:
        """Run a scrub if a signal requested one or the cadence elapsed.
        Called from the scheduler's housekeeping step; a no-op costs two
        comparisons."""
        if not self.due():
            return None
        return self.scrub()

    # -- the scrub cycle ------------------------------------------------------

    def scrub(self, repair: bool = True) -> ScrubReport:
        start = self.clock()
        # the scrubber is an OBSERVER: its golden-row build and repair
        # writes traverse the instrumented snapshot paths, so active
        # faults (e.g. an unbounded snapshot.write corrupt) must not
        # apply to them — they would corrupt the golden rows the same
        # way and re-corrupt every row the moment it is repaired
        with self._lock, faultpoints.suppressed():
            report = self._scrub_locked(repair)
        self._requested = False
        self._last_run = self.clock()
        report.duration = self.clock() - start
        self.last_report = report
        if self.metrics is not None:
            self.metrics.snapshot_scrub_runs.inc()
            self.metrics.snapshot_scrub_divergences.inc(
                len(report.divergences))
            self.metrics.snapshot_scrub_repairs.inc(report.repaired)
            self.metrics.snapshot_scrub_duration.observe(report.duration)
        return report

    def _golden(self) -> Snapshot:
        """Scratch snapshot re-featurized from the host cache. Shares
        the live vocabularies (interning is idempotent, so ids line up
        and already-known strings cause no growth) but copies the caps —
        scratch growth must never resize the live snapshot's notion of
        its own arrays."""
        live = self.snapshot
        scratch = Snapshot(vocabs=live.vocabs,
                           caps=dataclasses.replace(live.caps))
        for name, ni in self.cache.node_infos.items():
            if ni.node is not None:
                scratch.set_node(ni)
        return scratch

    def _batch_suspects(self, golden: Snapshot, live: Snapshot):
        """Vectorized prefilter over the node-row planes (the host-twin
        batched-diff discipline, ops/hostwave.py): every field group is
        compared golden-vs-live for ALL aligned rows in a handful of
        whole-array ops, and only rows flagged here pay the exact
        per-row, per-field Python compare — at 5000 nodes that compare
        was the scrub's wall clock. Ports compare as sorted rows and
        images as lexicographically sorted (id, size) pairs (complex
        sort), so multiset equality is preserved exactly. Returns the
        suspect-name set, or None when a cap mismatch makes whole-plane
        compares unsound (scratch growth — itself a divergence signal —
        falls back to exact row compares for every node)."""
        names: List[str] = []
        gi: List[int] = []
        li: List[int] = []
        for name, ni in self.cache.node_infos.items():
            if ni.node is None:
                continue
            lidx = live.node_index.get(name)
            if lidx is None or not live.valid[lidx]:
                continue  # missing rows take the repair path regardless
            names.append(name)
            gi.append(golden.node_index[name])
            li.append(lidx)
        if not names:
            return set()
        g = np.asarray(gi)
        l = np.asarray(li)
        suspect = np.zeros(len(names), bool)
        for f in _RESOURCE_FIELDS + _TOPOLOGY_FIELDS:
            a = getattr(golden, f)
            b = getattr(live, f)
            if a.shape[1:] != b.shape[1:]:
                return None
            ra = np.atleast_2d(a[g].reshape(len(names), -1))
            rb = np.atleast_2d(b[l].reshape(len(names), -1))
            if ra.dtype.kind == "f" or rb.dtype.kind == "f":
                ra64 = ra.astype(np.float64)
                rb64 = rb.astype(np.float64)
                eq = (ra64 == rb64) | (np.isnan(ra64) & np.isnan(rb64))
            else:
                eq = ra == rb
            suspect |= ~eq.all(axis=1)
        if (golden.ports.shape[1] != live.ports.shape[1]
                or golden.img_id.shape[1] != live.img_id.shape[1]):
            return None
        suspect |= ~(np.sort(golden.ports[g], axis=1)
                     == np.sort(live.ports[l], axis=1)).all(axis=1)
        genc = (golden.img_id[g].astype(np.float64)
                + 1j * golden.img_size[g].astype(np.float64))
        lenc = (live.img_id[l].astype(np.float64)
                + 1j * live.img_size[l].astype(np.float64))
        suspect |= ~(np.sort(genc, axis=1) == np.sort(lenc, axis=1)).all(axis=1)
        return {n for n, s in zip(names, suspect) if s}

    def _scrub_locked(self, repair: bool) -> ScrubReport:
        live = self.snapshot
        report = ScrubReport()
        golden = self._golden()
        suspects = self._batch_suspects(golden, live)
        host_uids = set()
        for name, ni in self.cache.node_infos.items():
            if ni.node is None:
                continue
            report.nodes_checked += 1
            gidx = golden.node_index[name]
            lidx = live.node_index.get(name)
            if lidx is None or not live.valid[lidx]:
                d = Divergence(name, ["missing-node"])
                report.divergences.append(d)
                if repair:
                    live.set_node(ni)
                    d.repaired = True
                    report.repaired += 1
                lidx = live.node_index.get(name)
                if lidx is None:
                    # audit-only run: still record the node's pods as
                    # host truth so the ghost pass can't misflag them
                    for pod in ni.pods:
                        host_uids.add(pod.uid)
                    continue
                # fall through: the freshly written row needs no compare
                report.pods_checked += self._check_pods(
                    ni, lidx, host_uids, report, repair)
                continue
            bad: List[str] = []
            if suspects is None or name in suspects:
                # flagged by the vectorized prefilter (or the prefilter
                # was unsound): exact per-field compare names the
                # divergent groups for the report
                for f in _RESOURCE_FIELDS + _TOPOLOGY_FIELDS:
                    fill = np.nan if f == "label_nums" else 0
                    if not _rows_equal(getattr(golden, f)[gidx],
                                       getattr(live, f)[lidx], fill=fill):
                        bad.append(f)
                # ports and images are written from set/dict iteration;
                # two equal sets can iterate differently, so compare as
                # multisets
                if sorted(golden.ports[gidx].tolist()) != \
                        sorted(live.ports[lidx].tolist()):
                    bad.append("ports")
                if sorted(zip(golden.img_id[gidx].tolist(),
                              golden.img_size[gidx].tolist())) != \
                        sorted(zip(live.img_id[lidx].tolist(),
                                   live.img_size[lidx].tolist())):
                    bad.append("images")
            if bad:
                d = Divergence(name, bad)
                report.divergences.append(d)
                if repair:
                    # set_node rewrites topology AND (via its internal
                    # refresh_node_resources) the resource aggregates
                    live.set_node(ni)
                    d.repaired = True
                    report.repaired += 1
            report.pods_checked += self._check_pods(
                ni, lidx, host_uids, report, repair)
        self._check_ghosts(host_uids, report, repair)
        return report

    def _check_pods(self, ni: NodeInfo, lidx: int, host_uids: set,
                    report: ScrubReport, repair: bool) -> int:
        """Audit the pod-matrix rows of one node's pods: placement index,
        validity/liveness, and the per-pod request row the device-side
        preemption what-if subtracts (a stale ep_req row silently skews
        victim accounting)."""
        live = self.snapshot
        checked = 0
        for pod in ni.pods:
            host_uids.add(pod.uid)
            checked += 1
            bad: List[str] = []
            slot = live.pod_slot.get(pod.uid)
            if slot is None or not live.ep_valid[slot]:
                bad.append("pod-row-missing")
            else:
                if int(live.ep_node[slot]) != lidx:
                    bad.append("pod-node")
                want_alive = pod.metadata.deletion_timestamp is None
                if bool(live.ep_alive[slot]) != want_alive:
                    bad.append("pod-alive")
                want_req = live._res_vec(
                    Resource.from_map(api.get_resource_request(pod)))
                if not _rows_equal(live.ep_req[slot], want_req):
                    bad.append("pod-req")
                if int(live.ep_prio[slot]) != api.pod_priority(pod):
                    bad.append("pod-prio")
            if bad:
                d = Divergence(f"{ni.node.name}/{pod.uid}", bad)
                report.divergences.append(d)
                if repair:
                    # drop the bind-echo signature first or add_pod's
                    # skip path would leave the corrupt row in place
                    live._pod_sig.pop(pod.uid, None)
                    live.add_pod(pod)
                    d.repaired = True
                    report.repaired += 1
        return checked

    def _check_ghosts(self, host_uids: set, report: ScrubReport,
                      repair: bool) -> None:
        live = self.snapshot
        # ghost pod rows: valid in the matrix, unknown to the host cache
        # (staged pending rows are ep_valid=False and never flagged)
        for uid, slot in list(live.pod_slot.items()):
            if live.ep_valid[slot] and uid not in host_uids:
                d = Divergence(uid, ["ghost-pod"])
                report.divergences.append(d)
                if repair:
                    live.remove_pod_by_uid(uid)
                    d.repaired = True
                    report.repaired += 1
        # ghost node rows: valid in the tensors, gone from the host cache
        for name in list(live.node_index):
            idx = live.node_index[name]
            if not live.valid[idx]:
                continue
            ni = self.cache.node_infos.get(name)
            if ni is None or ni.node is None:
                d = Divergence(name, ["ghost-node"])
                report.divergences.append(d)
                if repair:
                    live.remove_node(name)
                    d.repaired = True
                    report.repaired += 1

    # -- full rebuild ---------------------------------------------------------

    def rebuild(self) -> None:
        """Forced from-scratch rewrite of every live row from host truth
        — the device-path circuit breaker's recovery action: a faulting
        device path may have left the mirror (or its device-side cache)
        in an arbitrary state, so on re-admission nothing incremental is
        trusted. Staged (ep_valid=False) pending rows are preserved; the
        bind-echo signatures are dropped so every subsequent add_pod
        rewrites in full."""
        live = self.snapshot
        with self._lock, faultpoints.suppressed():
            live._pod_sig.clear()
            for name, ni in self.cache.node_infos.items():
                if ni.node is None:
                    continue
                live.set_node(ni)
                for pod in ni.pods:
                    live.add_pod(pod)
            report = ScrubReport()
            host_uids = {p.uid for ni in self.cache.node_infos.values()
                         for p in ni.pods}
            self._check_ghosts(host_uids, report, repair=True)
            live.dirty_resources = live.dirty_topology = True
            live.dirty_pods = True
            live.invalidate_device()

    # -- compaction (vocab mark-and-sweep + row/bucket shrink) ----------------

    def compact_due(self) -> bool:
        """Governor demand, or the cadence elapsed with something to
        reclaim (row removals since the last compaction — churn is the
        only way vocab garbage accrues)."""
        live = self.snapshot
        if live.compaction_requested:
            return True
        return bool(self.compact_period) and \
            live.removals_since_compact > 0 and \
            self.clock() - self._last_compact >= self.compact_period

    def maybe_compact(self) -> Optional[dict]:
        """Run a compaction if the governor demanded one or the cadence
        elapsed. Called from the scheduler's housekeeping step."""
        if not self.compact_due():
            return None
        if self.snapshot.compaction_requested:
            # governor demand: reclaiming device memory outranks shape
            # stability, so any smaller bucket is taken
            return self.compact(trigger="governor", force=True)
        return self.compact(trigger="cadence")

    def compact(self, trigger: str = "cadence",
                force: bool = False) -> Optional[dict]:
        """Vocab mark-and-sweep + row compaction: rebuild a scratch
        snapshot from host truth against a FRESH VocabSet (only strings
        live objects still reference survive), then adopt it into the
        live snapshot in place (Snapshot._compact — array swap, vocab
        adopt, generation bump, the device tensors dropped, full
        re-upload). Returns a summary dict, or None when deferred
        (staged rows outstanding: a round holds staged row indices, so
        the request is parked for the next housekeeping pass)."""
        live = self.snapshot
        with self._lock:
            # the chaos seam fires BEFORE entering suppressed() — a
            # raise/latency-mode fault must be able to hit the
            # housekeeping path like any other subsystem
            faultpoints.fire("snapshot.compact", payload=(live, trigger))
            if live.has_staged_rows():
                live.compaction_requested = True
                return None
            start = self.clock()
            with faultpoints.suppressed():
                before = live.vocabs.sizes()
                before_hbm = live.projected_hbm_bytes()
                scratch = self._compact_scratch()
                shrunk = live._compact(scratch, force=force)
            summary = {
                "trigger": trigger,
                "shrunk": shrunk,
                "vocabs_before": before,
                "vocabs_after": live.vocabs.sizes(),
                "hbm_before": before_hbm,
                "hbm_after": live.projected_hbm_bytes(),
                "duration": self.clock() - start,
            }
        self._last_compact = self.clock()
        self.last_compaction = summary
        if self.metrics is not None:
            self.metrics.snapshot_compactions_total.labels(
                trigger=trigger).inc()
        return summary

    def _compact_scratch(self) -> Snapshot:
        """Scratch snapshot re-featurized from the host cache against a
        fresh VocabSet, with every snapshot-owned Caps dim reset to its
        floor so the rebuild discovers the minimal buckets. Node rows
        keep the live snapshot's relative index order and pod rows the
        live slot order: row order feeds every argmax tie-break, so
        preserving it is what makes placements bit-equal across the
        compaction."""
        live = self.snapshot
        caps = dataclasses.replace(live.caps)
        floors = type(live.caps)()
        for d in SNAPSHOT_DIMS:
            setattr(caps, d, getattr(floors, d))
        scratch = Snapshot(vocabs=VocabSet(), caps=caps)
        placed = set()
        for idx, name in enumerate(live.node_names):
            if live.node_index.get(name) != idx:
                continue  # freed row whose name was never overwritten
            ni = self.cache.node_infos.get(name)
            if ni is not None and ni.node is not None:
                scratch.set_node(ni)
                placed.add(name)
        for name, ni in self.cache.node_infos.items():
            # host truth the live snapshot never saw (possible only
            # between an event and its apply; harmless to include)
            if name not in placed and ni.node is not None:
                scratch.set_node(ni)
        pods_by_uid = {}
        for _name, ni in self.cache.node_infos.items():
            for pod in ni.pods:
                pods_by_uid[pod.uid] = pod
        added = set()
        for uid, _slot in sorted(live.pod_slot.items(),
                                 key=lambda kv: kv[1]):
            pod = pods_by_uid.get(uid)
            if pod is not None:
                scratch.add_pod(pod)
                added.add(uid)
        for uid, pod in pods_by_uid.items():
            if uid not in added:
                scratch.add_pod(pod)
        return scratch
