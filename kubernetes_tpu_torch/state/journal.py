"""Durable bind-intent journal: the disconnected-mode write-ahead log.

A copy of kubernetes_tpu/state/journal.py: BindJournal, its JSONL format
byte for byte (a journal either package writes replays in the other),
the fsync a record, the rotation to `<path>.1`, the torn-tail repair and
`unresolved()` in seq order, with the `journal.append` fault point at the
same place, through the port's utils/faultpoints.py.

While the store path is DISCONNECTED (sched/storehealth.py), the
scheduler keeps assuming pods against its cache but cannot POST binds.
Each spooled bind is first appended here — an fsync'd JSONL record per
intent — so a process crash mid-outage loses no placement decisions:
startup and recover_leadership() replay the unresolved intents and
re-verify each against API truth before the first wave.

The file format borrows deliberately from two proven neighbors:

  * size-cap + rotation from the round ledger (utils/tracing.py
    _write_ledger_line): when the current segment would exceed
    max_bytes, it is os.replace'd to `<path>.1` and a fresh segment
    begins. Replay streams `<path>.1` then `<path>`, so one rotation
    never loses unresolved intents; the cap must simply dwarf the
    spool watermark (it does, by orders of magnitude).
  * torn-line tolerance from the autopilot dataset reader
    (autopilot/dataset.py load_records): a crash can tear the final
    line mid-write; replay counts and skips undecodable lines instead
    of poisoning recovery, and opening for append first terminates a
    torn tail with a newline so new records stay parseable.

Two record kinds, one line each:

  {"v":1,"k":"intent","seq":N,"uid":...,"ns":...,"name":...,
   "node":...,"ts":...}
  {"v":1,"k":"resolved","seq":N,"outcome":"confirmed"|"orphaned"|
   "gone"}

An intent with no matching resolved record is unresolved — exactly the
set replay() returns, in seq (arrival) order. `journal.append` is a
registered fault point: raise models a full disk / IO error at the
worst moment, drop models a write the OS acknowledged but never
persisted (the record is silently not written).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils import faultpoints

JOURNAL_MAX_BYTES = 16 << 20  # default segment cap; -1 in config means this

CONFIRMED = "confirmed"  # truth shows the bind landed (or the drain POST won)
ORPHANED = "orphaned"    # truth shows no binding -> the pod was requeued
GONE = "gone"            # pod deleted from truth -> nothing to recover


class BindJournal:
    def __init__(self, path: str, max_bytes: int = JOURNAL_MAX_BYTES,
                 clock: Callable[[], float] = time.time):
        self.path = path
        self.max_bytes = JOURNAL_MAX_BYTES if max_bytes < 0 else max_bytes
        self.clock = clock
        self.appends = 0
        self.rotations = 0
        self.skipped_lines = 0  # torn/undecodable lines seen by last scan
        self._lock = threading.Lock()
        self._bytes: Optional[int] = None  # lazy, like the round ledger
        self._seq = self._next_seq()

    # -- appending -------------------------------------------------------------

    def append_intent(self, pod, node_name: str) -> int:
        """Durably record one bind intent; returns its seq. Raises on IO
        failure (the caller decides whether an unjournaled bind may
        still spool in memory)."""
        with self._lock:
            seq = self._seq
            self._seq += 1
            rec = {"v": 1, "k": "intent", "seq": seq, "uid": pod.uid,
                   "ns": pod.namespace, "name": pod.name,
                   "node": node_name, "ts": round(self.clock(), 3)}
            self._append_locked(rec)
            return seq

    def resolve(self, seq: int, outcome: str) -> None:
        """Mark an intent resolved (confirmed/orphaned/gone). Best-effort
        by design: a lost resolved record only means the next replay
        re-verifies an already-settled intent against truth, which is
        idempotent."""
        with self._lock:
            try:
                self._append_locked(
                    {"v": 1, "k": "resolved", "seq": seq, "outcome": outcome})
            except Exception:
                pass

    def _append_locked(self, rec: dict) -> None:
        if faultpoints.fire("journal.append", payload=rec):
            return  # drop mode: the write the OS lied about
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        data = line.encode()
        if self._bytes is None:
            try:
                self._bytes = os.path.getsize(self.path)
            except OSError:
                self._bytes = 0
        if (self.max_bytes > 0 and self._bytes > 0
                and self._bytes + len(data) > self.max_bytes):
            os.replace(self.path, self.path + ".1")
            self.rotations += 1
            self._bytes = 0
        self._repair_torn_tail()
        with open(self.path, "ab") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        self._bytes += len(data)
        self.appends += 1

    def _repair_torn_tail(self) -> None:
        """If a crash tore the final line mid-write, terminate it so the
        next append starts a fresh line (the torn line itself is then a
        single skippable record, not a corruption of two)."""
        try:
            with open(self.path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
                    if self._bytes is not None:
                        self._bytes += 1
        except FileNotFoundError:
            pass

    # -- replay ----------------------------------------------------------------

    def _segments(self) -> List[str]:
        return [p for p in (self.path + ".1", self.path)
                if os.path.exists(p)]

    def unresolved(self) -> List[dict]:
        """The intents with no resolved record, in seq (arrival) order —
        the spool a crashed process left behind."""
        intents, resolved = self._scan()
        return [intents[s] for s in sorted(intents) if s not in resolved]

    def _scan(self):
        intents: Dict[int, dict] = {}
        resolved = set()
        skipped = 0
        for seg in self._segments():
            with open(seg, "rb") as f:
                for raw in f:
                    try:
                        rec = json.loads(raw)
                        kind, seq = rec["k"], int(rec["seq"])
                    except Exception:
                        skipped += 1  # torn or corrupt line: never fatal
                        continue
                    if kind == "intent":
                        intents[seq] = rec
                    elif kind == "resolved":
                        resolved.add(seq)
        self.skipped_lines = skipped
        return intents, resolved

    def _next_seq(self) -> int:
        intents, resolved = self._scan()
        top = max(list(intents) + list(resolved) + [-1]) if (
            intents or resolved) else -1
        return top + 1

    def stats(self) -> dict:
        return {"path": self.path, "appends": self.appends,
                "rotations": self.rotations,
                "skipped_lines": self.skipped_lines,
                "unresolved": len(self.unresolved())}
