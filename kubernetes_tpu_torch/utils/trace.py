"""Step tracing (analog of apiserver/pkg/util/trace/trace.go:33 utiltrace).

The scheduler wraps every cycle in a Trace and logs it when it exceeds a
threshold (reference: generic_scheduler.go:108-160, 100ms). A copy of
kubernetes_tpu/utils/trace.py."""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

log = logging.getLogger("kubernetes_tpu_torch")


class Trace:
    def __init__(self, name: str, clock=time.monotonic):
        self.name = name
        self.clock = clock
        self.start = clock()
        self.steps: List[Tuple[float, str]] = []

    def step(self, msg: str):
        now = self.clock()
        self.steps.append((now, msg))
        # feed the step profiler when enabled (utils/profiling.py): the
        # traces the scheduler already emits become the pprof-style
        # where-did-the-time-go breakdown with no extra instrumentation
        from . import profiling

        prof = profiling.active()
        if prof is not None:
            last = self.steps[-2][0] if len(self.steps) > 1 else self.start
            prof.record_step(self.name, msg, now - last)

    def total(self) -> float:
        return self.clock() - self.start

    def log_if_long(self, threshold: float = 0.1):
        total = self.total()
        if total >= threshold:
            last = self.start
            lines = [f"Trace {self.name!r} (total {total*1e3:.1f}ms):"]
            for t, msg in self.steps:
                lines.append(f"  +{(t-last)*1e3:.1f}ms {msg}")
                last = t
            log.info("\n".join(lines))
        return total
