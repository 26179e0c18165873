"""Step + lock-contention profiling: the pprof analog.

A copy of kubernetes_tpu/utils/profiling.py.

Reference: the scheduler exposes pprof and contention profiling behind
EnableProfiling/EnableContentionProfiling
(cmd/kube-scheduler/app/server.go:229-233; contention via
goruntime.SetBlockProfileRate(1)). The question those answer —
"where did this round's 8 seconds go?" — is answered here by:

  * a step profiler fed by every utils.trace.Trace the scheduler
    already emits (pipeline rounds, waves, preemption chunks): each
    named step accumulates count / total / max, and report() prints
    the cumulative breakdown (pprof's debug=1 text form).
  * a contention profiler: instrument_lock() swaps a component's lock
    for a wait-time-recording proxy (SetBlockProfileRate(1) analog),
    so time spent BLOCKED on the scheduler mutex or store lock shows
    up by name.

Both are opt-in (enable()/instrument_lock) and served by the
kube-scheduler health server at /debug/profile, like the reference's
--profiling / --contention-profiling flags.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple


class StepStats:
    __slots__ = ("count", "total", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        if dt > self.max:
            self.max = dt


class Profiler:
    def __init__(self):
        self._lock = threading.Lock()
        # (trace name prefix, step) -> stats
        self._steps: Dict[Tuple[str, str], StepStats] = {}
        self._contention: Dict[str, StepStats] = {}

    # -- step profile (fed by utils.trace.Trace) ---------------------------

    def record_step(self, trace_name: str, step: str, dt: float):
        # normalize per-invocation names ("pipeline of 173" -> "pipeline")
        prefix = trace_name.split(" of ")[0]
        with self._lock:
            key = (prefix, step)
            st = self._steps.get(key)
            if st is None:
                st = self._steps[key] = StepStats()
            st.add(dt)

    def record_wait(self, lock_name: str, dt: float):
        with self._lock:
            st = self._contention.get(lock_name)
            if st is None:
                st = self._contention[lock_name] = StepStats()
            st.add(dt)

    def step_totals(self, top: Optional[int] = None) -> Dict[str, float]:
        """Cumulative seconds per 'phase/step', descending — the
        structured form of report()'s step table (bench embeds it in
        the BENCH json as the per-stage breakdown)."""
        with self._lock:
            items = sorted(self._steps.items(), key=lambda kv: -kv[1].total)
        if top is not None:
            items = items[:top]
        return {f"{phase}/{step}": st.total for (phase, step), st in items}

    def report(self) -> str:
        """pprof debug=1 style text: cumulative step time, descending —
        'where the seconds went'."""
        with self._lock:
            steps = sorted(self._steps.items(),
                           key=lambda kv: -kv[1].total)
            cont = sorted(self._contention.items(),
                          key=lambda kv: -kv[1].total)
        lines = ["# step profile (cumulative seconds, descending)",
                 f"{'phase':<18}{'step':<22}{'count':>7}{'total_s':>10}"
                 f"{'max_s':>9}"]
        for (phase, step), st in steps:
            lines.append(f"{phase:<18}{step:<22}{st.count:>7}"
                         f"{st.total:>10.3f}{st.max:>9.3f}")
        lines.append("")
        lines.append("# lock contention (seconds blocked acquiring)")
        lines.append(f"{'lock':<30}{'count':>7}{'total_s':>10}{'max_s':>9}")
        for name, st in cont:
            lines.append(f"{name:<30}{st.count:>7}{st.total:>10.3f}"
                         f"{st.max:>9.3f}")
        return "\n".join(lines) + "\n"


# the active profiler; None = profiling disabled (zero overhead beyond
# one attribute read per trace step)
_ACTIVE: Optional[Profiler] = None


def enable() -> Profiler:
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = Profiler()
    return _ACTIVE


def disable():
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Profiler]:
    return _ACTIVE


class _ProfiledLock:
    """Lock proxy recording time blocked in acquire (block-profile
    analog). Wraps RLock/Lock alike; context-manager compatible."""

    def __init__(self, inner, name: str):
        self._inner = inner
        self._name = name

    def acquire(self, *a, **kw):
        prof = _ACTIVE
        if prof is None:
            return self._inner.acquire(*a, **kw)
        # fast path: uncontended acquire costs one extra monotonic read
        if self._inner.acquire(blocking=False):
            return True
        t0 = time.monotonic()
        got = self._inner.acquire(*a, **kw)
        prof.record_wait(self._name, time.monotonic() - t0)
        return got

    def release(self):
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __getattr__(self, item):  # notify/wait for Condition-style users
        return getattr(self._inner, item)


def instrument_lock(obj, attr: str, name: str):
    """Swap obj.<attr> for a contention-recording proxy (the
    SetBlockProfileRate(1) analog, scoped to one lock)."""
    inner = getattr(obj, attr)
    if isinstance(inner, _ProfiledLock):
        return inner
    wrapped = _ProfiledLock(inner, name)
    setattr(obj, attr, wrapped)
    return wrapped
