"""Flight recorder: per-pod span tracing + a bounded round ledger.

A copy of kubernetes_tpu/utils/tracing.py; the recorder is this
package's own, so enabling it leaves the JAX package's off and the
other way round. The port's kube-scheduler serves it from its
HealthServer (cli/kube_scheduler.py): `/debug/trace` reads
`chrome_trace()`, `text_timeline()` and `ledger_rows()`, `/debug/score`
reads `decision()` and `recent_decisions()`.

The benches say *what* regressed (pods/s, p99) but never *where*: the
host-path preemption cliff and the mixed5k p99 are aggregate numbers
with no per-pod or per-stage attribution. This module is the analog of
the reference's tracing surface (EnableProfiling's pprof endpoints plus
the utiltrace logs) rebuilt around the wave model:

  * every scheduling **round** (pipeline / wave / gang / degraded)
    records named stage spans — featurize, upload, device_wave or
    host_wave, fetch, commit, preempt — so a round's wall time is
    attributable to >=95% by named spans;
  * every **pod** gets async spans keyed by UID (queue_wait, bind) plus
    instant events (bind retries, ambiguity resolutions, breaker trips,
    preemption what-ifs), so one slow pod can be traced end to end;
  * the last `max_rounds` rounds live in a ring buffer, exported from
    the kube-scheduler HealthServer at `/debug/trace` as Chrome
    trace-event JSON (Perfetto-loadable) or a plain-text timeline;
  * each finished round appends one structured ledger record (pending
    count, snapshot shape, device-vs-host path, outcome counts, span
    seconds) to an optional JSONL file — the offline substrate the
    learned scoring head trains on.

Opt-in exactly like utils/profiling.py: a process-global recorder
behind `enable()`/`disable()`, with `active()` returning None when off
so every instrumentation site costs one attribute read.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# Round-ledger JSONL schema version, stamped on every record as "v".
# Bump when a field changes meaning or disappears; ADDING fields is not
# a version bump (downstream training jobs must ignore unknown keys).
# The schema is documented in README "Round-ledger JSONL schema".
#
# v2 (shadow-scoring observatory): every round record carries
# `weights_version` (the live WeightProfile the round dispatched under,
# or "static"), and traced rounds may carry `shadow` (per-candidate
# counterfactual divergence) and `golden` (decomposition coverage
# gaps). v1 readers that honor the ignore-unknown-keys contract parse
# v2 records unchanged — the bump marks that `scores`/decision weights
# now describe the LIVE vector, not necessarily the static defaults.
#
# v2 additions (autopilot, no bump — additive): standalone
# `kind: "autopilot"` records (round 0, no spans) ledger every
# candidate-lifecycle transition of the promotion pipeline; the file
# itself is size-capped and rotates to "<path>.1" (LEDGER_MAX_BYTES).
LEDGER_VERSION = 2

# bounded per-pod decision map (the /debug/score backing store): the
# most recent placement decision per pod UID, evicted oldest-first
MAX_DECISIONS = 4096

# ledger rotation: the JSONL file is size-capped — when an append would
# push it past the cap, the file is renamed to "<path>.1" (replacing any
# previous rotation) and a fresh file starts. One rotation generation
# keeps at most 2x the cap on disk, so a long autopilot run can never
# fill the volume; readers (autopilot/dataset.py) stream "<path>.1"
# first, then "<path>", so rotation loses at most one generation of
# history, never recent records. 0 disables the cap (unbounded append,
# the pre-rotation behavior).
LEDGER_MAX_BYTES = 64 * 1024 * 1024

# standalone (round-less) ledger records retained in memory for
# ledger_rows() / /debug endpoints — autopilot transitions and the like
MAX_EXTRA_RECORDS = 256


class Span:
    __slots__ = ("name", "cat", "t0", "t1", "tid", "args")

    def __init__(self, name: str, cat: str, t0: float, t1: float,
                 tid: int, args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.args = args or {}


class Event:
    __slots__ = ("name", "t", "tid", "args")

    def __init__(self, name: str, t: float, tid: int,
                 args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t = t
        self.tid = tid
        self.args = args or {}


class PodSpan:
    """Per-pod async span (Chrome 'b'/'e' pair keyed by the pod UID)."""

    __slots__ = ("uid", "name", "t0", "t1", "args")

    def __init__(self, uid: str, name: str, t0: float, t1: float,
                 args: Optional[Dict[str, Any]] = None):
        self.uid = uid
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.args = args or {}


# per-round caps so one 30k-pod mixed round cannot balloon the ring
# buffer; drops are counted in the ledger, never silent
MAX_POD_SPANS_PER_ROUND = 8192
MAX_EVENTS_PER_ROUND = 4096


class RoundTrace:
    """One scheduling round's spans/events. Stage spans are laid down by
    `mark()` (contiguous segments from the previous mark, exactly like
    utils.trace.Trace.step) so coverage of the round wall is structural,
    not best-effort."""

    def __init__(self, rec: "FlightRecorder", rid: int, kind: str,
                 meta: Optional[Dict[str, Any]] = None):
        self._rec = rec
        self.rid = rid
        self.kind = kind
        self.t0 = rec.now()
        self.t1: Optional[float] = None
        self._last_mark = self.t0
        self.meta = dict(meta or {})
        self.spans: List[Span] = []
        self.events: deque = deque(maxlen=MAX_EVENTS_PER_ROUND)
        self.pod_spans: deque = deque(maxlen=MAX_POD_SPANS_PER_ROUND)
        self.pod_span_drops = 0
        self.event_drops = 0
        self.ledger: Dict[str, Any] = {}

    # -- recording -----------------------------------------------------------

    def mark(self, name: str, cat: str = "stage", **args):
        """Close a stage span from the previous mark (or round start) to
        now. Consecutive marks therefore tile the round wall."""
        now = self._rec.now()
        with self._rec._lock:
            self.spans.append(Span(name, cat, self._last_mark, now,
                                   self._rec._tid(), args or None))
            self._last_mark = now

    def add_span(self, name: str, t0: float, t1: float, cat: str = "stage",
                 **args):
        """Explicit-interval span (gang_wait, autoscaler what-ifs)."""
        with self._rec._lock:
            self.spans.append(Span(name, cat, t0, t1, self._rec._tid(),
                                   args or None))

    def event(self, name: str, **args):
        with self._rec._lock:
            if len(self.events) == self.events.maxlen:
                self.event_drops += 1
            self.events.append(Event(name, self._rec.now(),
                                     self._rec._tid(), args or None))

    def pod_span(self, uid: str, name: str, duration: float, **args):
        """Per-pod span ENDING now, `duration` seconds long. Durations
        come from the scheduler's (possibly virtual) clock; anchoring the
        end at recorder-now keeps the timeline monotonic either way."""
        now = self._rec.now()
        with self._rec._lock:
            if len(self.pod_spans) == self.pod_spans.maxlen:
                self.pod_span_drops += 1
            self.pod_spans.append(
                PodSpan(uid, name, now - max(duration, 0.0), now,
                        args or None))

    # -- summaries -----------------------------------------------------------

    def wall(self) -> float:
        end = self.t1 if self.t1 is not None else self._rec.now()
        return end - self.t0

    def span_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + (s.t1 - s.t0)
        return out


class FlightRecorder:
    """Bounded ring buffer of the last N rounds' traces + the optional
    per-round JSONL ledger. Thread-safe: stage marks run under the
    scheduler lock, but bind spans land from binder threads and
    autoscaler what-ifs from the controller thread."""

    def __init__(self, max_rounds: int = 64,
                 ledger_path: Optional[str] = None,
                 clock=time.monotonic,
                 ledger_max_bytes: int = LEDGER_MAX_BYTES):
        self.clock = clock
        self.ledger_path = ledger_path
        self.ledger_max_bytes = int(ledger_max_bytes)
        self.ledger_rotations = 0
        # file appends serialize on their own lock, never _lock: a slow
        # or rotating disk write must not block span recording
        self._ledger_io = threading.Lock()
        self._ledger_bytes: Optional[int] = None
        self._lock = threading.Lock()
        self.epoch = clock()
        self.epoch_wall = time.time()
        self.rounds: deque = deque(maxlen=max_rounds)
        self._next_rid = 1
        self._current: Optional[RoundTrace] = None
        # spans/events recorded outside any round (breaker trips while
        # idle, autoscaler simulations between rounds)
        self.background = RoundTrace(self, 0, "background")
        self._tids: Dict[int, int] = {}
        self._tid_names: Dict[int, str] = {}
        self.ledger_records = 0
        # decision observatory: pod UID -> the score decomposition of
        # its most recent placement (scheduler._record_decisions feeds
        # it; /debug/score?uid= serves it)
        self.decisions: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        # standalone records appended outside any round (autopilot
        # promotion transitions), served alongside round records
        self.extra_records: deque = deque(maxlen=MAX_EXTRA_RECORDS)
        # round observers: called with each finished round's ledger
        # record, OUTSIDE the recorder lock (the autopilot regression
        # watch subscribes here). An observer must never fail a round.
        self.observers: List[Callable[[Dict[str, Any]], None]] = []

    def now(self) -> float:
        return self.clock()

    def _tid(self) -> int:
        """Stable small int per thread (Chrome trace tid); caller may
        hold _lock — plain dict ops only."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
            self._tid_names[tid] = threading.current_thread().name
        return tid

    # -- round lifecycle -----------------------------------------------------

    def begin_round(self, kind: str, **meta) -> RoundTrace:
        with self._lock:
            rt = RoundTrace(self, self._next_rid, kind, meta)
            self._next_rid += 1
            self.rounds.append(rt)
            self._current = rt
        return rt

    def end_round(self, rt: RoundTrace, **ledger_fields):
        rt.t1 = self.now()
        with self._lock:
            # conditional fields are absent, never null-padded (the
            # documented schema contract): a round that placed nothing
            # has no `scores` key, not "scores": null
            rt.ledger.update({k: v for k, v in ledger_fields.items()
                              if v is not None})
            if self._current is rt:
                self._current = None
            # record built under the lock (span/event containers are
            # append-racy from binder threads); the file write is not
            rec = self._ledger_record(rt)
        self._write_ledger_line(rec)
        for fn in list(self.observers):
            try:
                fn(rec)
            except Exception:
                pass  # an observer must never fail a scheduling round

    def _write_ledger_line(self, rec: Dict[str, Any]) -> None:
        """Append one record to the JSONL ledger, rotating the file to
        `<path>.1` when the append would push it past ledger_max_bytes.
        Serialized on _ledger_io (never _lock): end_round and
        append_record can land from different threads and the
        size-check + rename + write must be atomic against each other."""
        if not self.ledger_path:
            return
        line = json.dumps(rec) + "\n"
        with self._ledger_io:
            try:
                if self._ledger_bytes is None:
                    # adopt whatever an earlier run left behind so the
                    # cap holds across process restarts
                    try:
                        self._ledger_bytes = os.path.getsize(
                            self.ledger_path)
                    except OSError:
                        self._ledger_bytes = 0
                if (self.ledger_max_bytes > 0 and self._ledger_bytes > 0
                        and self._ledger_bytes + len(line)
                        > self.ledger_max_bytes):
                    os.replace(self.ledger_path, self.ledger_path + ".1")
                    self.ledger_rotations += 1
                    self._ledger_bytes = 0
                with open(self.ledger_path, "a") as f:
                    f.write(line)
                self._ledger_bytes += len(line)
                self.ledger_records += 1
            except OSError:
                pass  # a full disk must never fail a scheduling round

    def append_record(self, kind: str, **fields) -> Dict[str, Any]:
        """Standalone ledger record outside any round — the autopilot
        controller ledgers every candidate-lifecycle transition through
        here (kind "autopilot"). Carries the schema version and a
        round of 0 (no round envelope); conditional fields follow the
        absent-not-null contract like round records."""
        rec: Dict[str, Any] = {
            "v": LEDGER_VERSION, "round": 0, "kind": kind,
            "ts": round(self.epoch_wall + (self.now() - self.epoch), 6)}
        rec.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self.extra_records.append(rec)
        self._write_ledger_line(rec)
        return rec

    def current(self) -> RoundTrace:
        """The in-flight round, or the background pseudo-round."""
        with self._lock:
            return self._current if self._current is not None \
                else self.background

    def event(self, name: str, **args):
        self.current().event(name, **args)

    def add_span(self, name: str, t0: float, t1: float, cat: str = "stage",
                 **args):
        self.current().add_span(name, t0, t1, cat=cat, **args)

    def pod_span(self, uid: str, name: str, duration: float, **args):
        self.current().pod_span(uid, name, duration, **args)

    # -- decision observatory ------------------------------------------------

    def record_decision(self, uid: str, entry: Dict[str, Any]) -> None:
        """Store one pod's placement decomposition (bounded; newest
        decision per UID wins — a requeued pod's final placement is the
        one that matters)."""
        with self._lock:
            self.decisions[uid] = entry
            self.decisions.move_to_end(uid)
            while len(self.decisions) > MAX_DECISIONS:
                self.decisions.popitem(last=False)

    def decision(self, uid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self.decisions.get(uid)

    def recent_decisions(self, n: int = 64) -> List[Tuple[str, Dict[str, Any]]]:
        """The most recent (uid, entry) pairs, newest last."""
        with self._lock:
            items = list(self.decisions.items())
        return items[-n:]

    # -- ledger --------------------------------------------------------------

    def _ledger_record(self, rt: RoundTrace) -> Dict[str, Any]:
        rec = {
            "v": LEDGER_VERSION,
            "round": rt.rid,
            "kind": rt.kind,
            "ts": round(self.epoch_wall + (rt.t0 - self.epoch), 6),
            "wall_s": round(rt.wall(), 6),
            "spans": {k: round(v, 6) for k, v in rt.span_seconds().items()},
        }
        if rt.meta:
            rec.update(rt.meta)
        if rt.ledger:
            rec.update(rt.ledger)
        if rt.pod_span_drops:
            rec["pod_span_drops"] = rt.pod_span_drops
        if rt.event_drops:
            rec["event_drops"] = rt.event_drops
        return rec

    def ledger_rows(self) -> List[Dict[str, Any]]:
        """The ring buffer's rounds as ledger records (finished rounds
        only) plus buffered standalone records — what the JSONL file
        would contain, served live."""
        with self._lock:
            return ([self._ledger_record(r) for r in self.rounds
                     if r.t1 is not None] + list(self.extra_records))

    # -- exports -------------------------------------------------------------

    def _us(self, t: float) -> float:
        return round((t - self.epoch) * 1e6, 1)

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable): rounds and stage
        spans as complete ('X') events, per-pod spans as async 'b'/'e'
        pairs keyed by UID, instant events as 'i'."""
        with self._lock:
            # snapshot every container under the lock: the scheduler /
            # binder threads append to the in-flight round (and the
            # background pseudo-round) while the HTTP thread exports
            rounds = [(rt, list(rt.spans), list(rt.events),
                       list(rt.pod_spans))
                      for rt in list(self.rounds) + [self.background]]
            tid_names = dict(self._tid_names)
        ev: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "kube-scheduler"}}]
        for tid, name in tid_names.items():
            ev.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "args": {"name": name}})
        for rt, spans, events, pod_spans in rounds:
            if rt.rid:  # background has no round envelope
                end = rt.t1 if rt.t1 is not None else self.now()
                ev.append({"name": f"round {rt.rid} [{rt.kind}]",
                           "cat": "round", "ph": "X",
                           "ts": self._us(rt.t0),
                           "dur": round((end - rt.t0) * 1e6, 1),
                           "pid": 1, "tid": 0,
                           "args": {**rt.meta, **rt.ledger}})
            for s in spans:
                ev.append({"name": s.name, "cat": s.cat, "ph": "X",
                           "ts": self._us(s.t0),
                           "dur": round((s.t1 - s.t0) * 1e6, 1),
                           "pid": 1, "tid": s.tid, "args": s.args})
            for e in events:
                ev.append({"name": e.name, "cat": "event", "ph": "i",
                           "s": "t", "ts": self._us(e.t), "pid": 1,
                           "tid": e.tid, "args": e.args})
            for p in pod_spans:
                base = {"cat": "pod", "id": p.uid, "name": p.name,
                        "pid": 1, "tid": 0}
                ev.append({**base, "ph": "b", "ts": self._us(p.t0),
                           "args": {"uid": p.uid, **p.args}})
                ev.append({**base, "ph": "e", "ts": self._us(p.t1)})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def text_timeline(self) -> str:
        """Plain-text per-round timeline — the log-greppable export."""
        with self._lock:
            rounds = [(rt, list(rt.spans), list(rt.events),
                       len(rt.pod_spans)) for rt in self.rounds]
            bg_spans = len(self.background.spans)
            bg_events = len(self.background.events)
        lines = [f"# flight recorder: {len(rounds)} rounds buffered, "
                 f"{self.ledger_records} ledger records written"]
        for rt, spans, events, n_pod_spans in rounds:
            wall = rt.wall()
            head = (f"round {rt.rid} [{rt.kind}] "
                    f"+{(rt.t0 - self.epoch):.3f}s wall={wall*1e3:.1f}ms")
            if rt.meta:
                head += " " + " ".join(f"{k}={v}" for k, v in rt.meta.items())
            if rt.ledger:
                head += " " + " ".join(
                    f"{k}={v}" for k, v in rt.ledger.items()
                    if not isinstance(v, dict))
            lines.append(head)
            for s in spans:
                lines.append(f"  +{(s.t0 - rt.t0)*1e3:8.1f}ms "
                             f"{s.name:<16} {(s.t1 - s.t0)*1e3:8.1f}ms"
                             + (f"  {s.args}" if s.args else ""))
            for e in events:
                lines.append(f"  +{(e.t - rt.t0)*1e3:8.1f}ms "
                             f"! {e.name} {e.args}")
            if n_pod_spans:
                lines.append(f"  ({n_pod_spans} pod spans"
                             + (f", {rt.pod_span_drops} dropped"
                                if rt.pod_span_drops else "") + ")")
        if bg_spans or bg_events:
            lines.append(f"background: {bg_spans} spans, "
                         f"{bg_events} events")
        return "\n".join(lines) + "\n"


def _fmt_score(v) -> str:
    if v is None:
        return "-"
    f = float(v)
    return f"{int(f)}" if f == int(f) else f"{f:.2f}"


def format_decision(uid: str, e: Dict[str, Any]) -> str:
    """One-line human rendering of a decision entry — the V(10)
    "Host %s => Score %d" log line, upgraded to an explanation:
    "p1 -> node-42 won by 3 over node-7: LeastRequested 8 vs 6, ..."."""
    head = f"{e.get('pod', uid)} -> {e['node']}"
    margin = e.get("margin")
    if margin is not None and e.get("runner_up"):
        head += f" won by {_fmt_score(margin)} over {e['runner_up']}"
    parts = []
    for name, p in e.get("parts", {}).items():
        if not p.get("weight"):
            continue
        parts.append(f"{name} {_fmt_score(p.get('chosen'))}"
                     f" vs {_fmt_score(p.get('runner_up'))}")
    tail = f" (total {_fmt_score(e.get('total'))}, round {e.get('round')}"
    # which weight vector decided this placement — "static", or the
    # live WeightProfile's name@version (the hot-swap observability)
    wver = e.get("weights_version")
    if wver:
        tail += f", weights {wver}"
    tail += ")"
    return head + ": " + ", ".join(parts) + tail


# the active recorder; None = tracing disabled (zero overhead beyond one
# attribute read per instrumentation site)
_ACTIVE: Optional[FlightRecorder] = None


def enable(max_rounds: int = 64, ledger_path: Optional[str] = None,
           clock=time.monotonic,
           ledger_max_bytes: Optional[int] = None) -> FlightRecorder:
    """Install the process-global recorder. An already-active recorder
    is returned as-is EXCEPT that a newly-requested ledger path (and
    its rotation cap) is adopted (the caller asked for a ledger; losing
    it silently cost a run's records) — ring size and clock stay with
    the original."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = FlightRecorder(
            max_rounds=max_rounds, ledger_path=ledger_path, clock=clock,
            ledger_max_bytes=(LEDGER_MAX_BYTES if ledger_max_bytes is None
                              else ledger_max_bytes))
    elif ledger_path and not _ACTIVE.ledger_path:
        _ACTIVE.ledger_path = ledger_path
        if ledger_max_bytes is not None:
            _ACTIVE.ledger_max_bytes = int(ledger_max_bytes)
    return _ACTIVE


def disable():
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def event(name: str, **args):
    """Convenience instant event: no-op when tracing is off."""
    rec = _ACTIVE
    if rec is not None:
        rec.event(name, **args)


class _SpanCtx:
    __slots__ = ("rec", "name", "cat", "args", "t0")

    def __init__(self, rec, name, cat, args):
        self.rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0 = self.rec.now()
        return self

    def __exit__(self, *exc):
        self.rec.add_span(self.name, self.t0, self.rec.now(),
                          cat=self.cat, **self.args)
        return False


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


def span(name: str, cat: str = "stage", **args):
    """Context-manager span attached to the current round (or the
    background pseudo-round); the shared no-op when tracing is off."""
    rec = _ACTIVE
    if rec is None:
        return _NULL
    return _SpanCtx(rec, name, cat, args)
