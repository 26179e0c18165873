"""Device-dispatch watchdog: a deadline budget around device dispatches.

A copy of kubernetes_tpu/utils/watchdog.py for torch. The device-path
circuit breaker (sched/breaker.py) only trips on RAISED exceptions — a
dispatch that silently never returns would wedge the scheduling loop
forever with the breaker still CLOSED. The watchdog closes that gap:
each dispatch through the ops/kernel.py `record_dispatch` seam runs on
a worker thread with a deadline; a dispatch that exceeds it is
ABANDONED — the thread keeps running (a thread cannot be killed), but
the scheduling loop gets `DispatchTimeout` immediately, feeds the
breaker, and the round completes through the numpy hostwave twin.

What the budget covers differs from the JAX package's: a JAX dispatch is
an asynchronous enqueue of one compiled program, while the port's round
issues its whole per-pod loop from the host (several milliseconds a pod
on the card), so a healthy round of thousands of pods takes seconds.
Set the deadline from a measured healthy dispatch of the same shape,
never from a JAX value.

The worker runs with the caller's torch thread state: the current CUDA
device, the current stream and inference mode (grad mode, the device
and the stream are per thread in torch), so an abandoned worker keeps
issuing its work on the caller's stream. While any abandoned dispatch is
outstanding the scheduler dispatches nothing at all, the breaker's
half-open probe included (Scheduler._device_admitted).

Cold shapes are not hangs: the first dispatch at a new shape bucket
builds the CUDA kernels with nvcc (tens of seconds) unless they were
built before, so unwarmed dispatches get the deadline scaled by
`compile_scale`; the scheduler builds both kernels when it is made on a
CUDA device.

Results of an abandoned dispatch are discarded when the thread finally
returns — dispatches are pure functions of their input tensors; all
scheduler state changes on the host after a successful fetch.
"""

from __future__ import annotations

import atexit
import threading
import time
import weakref
from typing import Callable, List, Optional

import torch

# Live watchdogs, weakly held: ONE module-level atexit hook drains
# whatever is still alive at interpreter exit.
_LIVE: List["weakref.ref"] = []


def _drain_all() -> None:
    for ref in list(_LIVE):
        wd = ref()
        if wd is not None:
            wd.drain()


atexit.register(_drain_all)


class DispatchTimeout(RuntimeError):
    """A device dispatch exceeded its watchdog deadline and was
    abandoned. The dispatch may still complete eventually; its result
    is discarded either way."""

    def __init__(self, program: str, deadline_s: float):
        super().__init__(
            f"device dispatch {program!r} exceeded its "
            f"{deadline_s:.3f}s deadline and was abandoned")
        self.program = program
        self.deadline_s = deadline_s


def _thread_state():
    """The caller's torch thread state a worker must take over: (device
    index, stream) on CUDA, None elsewhere, and inference mode."""
    cuda = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        cuda = (torch.cuda.current_device(), torch.cuda.current_stream())
    return cuda, torch.is_inference_mode_enabled()


def _run_with_state(fn: Callable, state):
    cuda, inference = state
    with torch.inference_mode(inference):
        if cuda is None:
            return fn()
        device, stream = cuda
        torch.cuda.set_device(device)
        with torch.cuda.stream(stream):
            return fn()


class DispatchWatchdog:
    """Deadline harness for device dispatches. `deadline_s` <= 0
    disarms it entirely (run() degenerates to fn()). One worker thread
    per guarded dispatch."""

    def __init__(self, deadline_s: float, compile_scale: float = 20.0,
                 on_abandon: Optional[Callable[[str, float], None]] = None):
        self.deadline_s = float(deadline_s)
        # unwarmed shape buckets: scale the budget rather than charging
        # a first build as a hang
        self.compile_scale = float(compile_scale)
        # fired (program, deadline_s) on every abandonment — feeds
        # scheduler_wave_deadline_overruns_total{stage=dispatch}
        self.on_abandon = on_abandon
        self.abandoned_total = 0
        # completion events of abandoned dispatches still in flight;
        # pruned on read (list, not set: determinism rule)
        self._inflight: List[threading.Event] = []
        self._lock = threading.Lock()
        _LIVE[:] = [r for r in _LIVE if r() is not None]
        _LIVE.append(weakref.ref(self))

    def armed(self) -> bool:
        return self.deadline_s > 0

    def outstanding(self) -> int:
        """Abandoned dispatches whose worker threads are STILL running.
        While this is non-zero the device is presumed wedged and no new
        dispatch should be issued."""
        with self._lock:
            self._inflight = [e for e in self._inflight if not e.is_set()]
            return len(self._inflight)

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait (bounded) for every abandoned dispatch to return. True
        when none is left."""
        deadline = time.monotonic() + timeout
        with self._lock:
            pending = list(self._inflight)
        for e in pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not e.wait(remaining):
                return False
        return True

    def run(self, fn: Callable, program: str = "wave",
            warm: bool = True):
        """Run one dispatch under the deadline. Raises DispatchTimeout
        on abandonment; re-raises fn's own exception otherwise."""
        if not self.armed():
            return fn()
        deadline = self.deadline_s * (1.0 if warm else self.compile_scale)
        done = threading.Event()
        box: dict = {}
        state = _thread_state()

        def _worker():
            try:
                box["out"] = _run_with_state(fn, state)
            except BaseException as e:  # re-raised on the caller below
                box["exc"] = e
            finally:
                done.set()

        t = threading.Thread(target=_worker, daemon=True,
                             name=f"dispatch-{program}")
        t.start()
        if not done.wait(deadline):
            with self._lock:
                self.abandoned_total += 1
                self._inflight.append(done)
            if self.on_abandon is not None:
                self.on_abandon(program, deadline)
            raise DispatchTimeout(program, deadline)
        if "exc" in box:
            raise box["exc"]
        return box["out"]
