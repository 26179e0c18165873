"""Device-path circuit breaker.

A copy of kubernetes_tpu/sched/breaker.py's DevicePathBreaker, its
states and STATE_CODES, DeviceLost with lost_device_fault (the
`device.lost` fault point's per-device action), ResourceExhausted with
oom_fault (the `device.oom` point's action) and is_capacity_error. MeshFaultManager is left out: the port has no mesh
yet. The port's Scheduler carries one (sched/scheduler.py: its ladder of
device faults drains the backlog through the numpy twin while the
breaker is open), and the node-lifecycle controller's zone tally takes
one (ops/zonehealth.py).

What the breaker cannot heal: a sticky CUDA error (an illegal memory
address, a device-side assert, a launch that corrupts the context)
poisons the process's CUDA context, so every later launch fails and no
half-open probe can succeed. The scheduler then keeps draining on the
host twin, with the breaker cycling OPEN -> HALF_OPEN -> OPEN at each
cooldown, until the process restarts; nothing here tries to recover the
context. The fault points model recoverable faults only.

The device step can fail persistently, not just transiently: a wedged
CUDA runtime, a card that dropped off the bus. The round's own fallback (a
failed round hands its backlog to the per-wave loop) handles one
failure; a PERSISTENT fault would otherwise pay a doomed device attempt
— the dispatch and the exception unwind — on every single wave,
forever. The breaker is the standard remedy:

  closed     normal operation; consecutive-failure count resets on any
             device success.
  open       `threshold` consecutive device failures trip it (a
             watchdog abandonment trips it at once, record_hang); every
             wave drains through the numpy twin (ops/hostwave.py) —
             scheduling NEVER stops, it degrades — until `cooldown`
             elapses.
  half-open  after the cooldown one probe wave is re-admitted to the
             device path. Success closes the breaker (firing
             `on_recover`, which the scheduler uses to re-upload its
             whole device mirror — nothing incremental is trusted
             across a device fault); failure re-opens with a fresh
             cooldown.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

# gauge encoding for device_path_breaker_state (utils/metrics.py):
# operators alert on >0 (scheduling currently degraded)
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class DevicePathBreaker:
    def __init__(self, threshold: int = 3, cooldown: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_recover: Optional[Callable[[], None]] = None,
                 on_trip: Optional[Callable[[], None]] = None,
                 on_state: Optional[Callable[[str], None]] = None):
        self.threshold = max(int(threshold), 1)
        self.cooldown = cooldown
        self.clock = clock
        self.on_recover = on_recover
        self.on_trip = on_trip
        # fired on EVERY transition (trip, half-open probe admission,
        # recovery) with the new state — feeds the breaker-state gauge
        # and the flight recorder's span events
        self.on_state = on_state
        self.state = CLOSED
        self.failures = 0  # consecutive, since the last success
        self.trips = 0
        self.opened_at = 0.0

    def _transition(self, state: str) -> None:
        self.state = state
        if self.on_state is not None:
            self.on_state(state)

    def allow(self) -> bool:
        """May this wave take the device path? Open + cooldown elapsed
        transitions to half-open and admits the probe."""
        if self.state == OPEN:
            if self.clock() - self.opened_at >= self.cooldown:
                self._transition(HALF_OPEN)
                return True
            return False
        return True  # closed, or half-open (the probe itself)

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == HALF_OPEN or (
                self.state == CLOSED and self.failures >= self.threshold):
            self._trip()

    def record_hang(self) -> None:
        """A dispatch the watchdog ABANDONED (utils/watchdog.py): trip
        immediately, ignoring the consecutive-failure threshold. The
        threshold exists to tolerate transient exceptions that cost
        milliseconds each; a hang costs a full wave_deadline_s per
        retry and signals a wedged runtime that won't heal by retrying
        — the cooldown probe is the right (and only) way back."""
        self.failures += 1
        if self.state != OPEN:
            self._trip()

    def record_success(self) -> None:
        self.failures = 0
        if self.state != CLOSED:
            self._transition(CLOSED)
            if self.on_recover is not None:
                self.on_recover()

    def _trip(self) -> None:
        self._transition(OPEN)
        self.opened_at = self.clock()
        self.trips += 1
        if self.on_trip is not None:
            self.on_trip()


class DeviceLost(RuntimeError):
    """A specific device failed: the `device.lost` fault point raises it
    through lost_device_fault (utils/faultpoints.py)."""

    def __init__(self, device: str):
        super().__init__(f"device {device!r} lost")
        self.device = device


def lost_device_fault(device: str):
    """corrupt-mode fn for the `device.lost` fault point, arming chaos
    for ONE device: raises DeviceLost(device) when the dispatch seam's
    payload (the registered device-name tuple, ops/kernel.py
    set_devices) names it; a None payload (no device registered) is a
    no-op:

        faultpoints.activate("device.lost", "corrupt",
                             fn=lost_device_fault("cuda:0"))
    """

    def fn(payload):
        if payload is None:
            return
        if isinstance(payload, str):
            if payload == device:
                raise DeviceLost(device)
            return
        if device in payload:
            raise DeviceLost(device)

    return fn


class ResourceExhausted(RuntimeError):
    """Device allocation failure — the capacity-fault class, and the
    shape a real allocation failure (an XLA RESOURCE_EXHAUSTED, a CUDA
    out-of-memory error, an allocation-site MemoryError) is classified
    into by is_capacity_error. NOT a device fault: no device is sick,
    the working set is too big — the remedy is compaction, a smaller
    wave, or the host twin, never quarantine or a mesh reform."""


def oom_fault(message: str = "RESOURCE_EXHAUSTED: out of memory "
                             "while trying to allocate"):
    """corrupt-mode fn for the `device.oom` fault point: raises
    ResourceExhausted at the dispatch seam (ops/kernel.py record_dispatch
    passes the registered device-name tuple as payload); a None payload
    (no device registered) is a no-op, as with lost_device_fault:

        faultpoints.activate("device.oom", "corrupt", fn=oom_fault())
    """

    def fn(payload):
        if payload is None:
            return
        raise ResourceExhausted(message)

    return fn


# markers an allocation failure embeds in its message: the gRPC status
# name XLA runtimes surface, and "out of memory", which also covers
# torch.cuda.OutOfMemoryError ("CUDA out of memory. Tried to allocate
# ..."). "device.oom" is the reference's injected capacity fault; the
# list is the reference's, so both packages classify alike.
_CAPACITY_MARKERS = ("RESOURCE_EXHAUSTED", "resource exhausted",
                     "out of memory", "OOM when allocating",
                     "device.oom")


def is_capacity_error(exc: BaseException) -> bool:
    """True when the exception chain is a capacity miss — an
    allocation-site MemoryError, a ResourceExhausted, or an error whose
    text carries an allocation-failure marker. Walks __cause__/
    __context__: a runtime wraps backend errors, and the classification
    must see through the wrapping."""
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, (MemoryError, ResourceExhausted)):
            return True
        text = str(e)
        if any(m in text for m in _CAPACITY_MARKERS):
            return True
        e = e.__cause__ or e.__context__
    return False
