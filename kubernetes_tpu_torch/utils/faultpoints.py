"""Named fault points for deterministic chaos testing.

A copy of kubernetes_tpu/utils/faultpoints.py with a registry of its
own: the port's fault points are armed here, and arming the JAX
package's registry changes nothing in the port (and the other way
round). The same grammar, modes, `times` budgets and hit counts; a seam
fires as many times a dispatch as its JAX counterpart, so a
times-bounded fault trips both packages alike.

Internal surfaces that can fail independently of any process — a device
dispatch (an error, a hang, an out-of-memory), a pod spec that poisons
the batched pass, the quarantine admission, the incremental snapshot
writes that keep the device mirror honest, the compaction sweep, the
queue's shed decision, the bind POST and truth GET of the store path,
the bind journal's append, the autopilot's fit and promotion, a
store event's fan-out to its watchers and a kubelet's heartbeat — are
wired with a named fault point (the etcd `gofail` pattern): a test
activates a point by name and the code path fails exactly there,
deterministically.

Wired points (grep for `faultpoints.fire`):

  kernel.wave      ops/kernel.py schedule_wave entry (per-wave dispatch)
  kernel.round     ops/kernel.py schedule_round entry (the round)
  kernel.gang      ops/gang.py schedule_gang entry (joint assignment)
  kernel.hang      ops/kernel.py record_dispatch, INSIDE the guarded
                   dispatch (on the watchdog's worker thread when one
                   is armed) — `latency` models a wedged dispatch that
                   never returns: with wave_deadline_s set the watchdog
                   abandons it, the breaker trips via record_hang, and
                   the round salvages through the hostwave twin
  device.lost      ops/kernel.py record_dispatch, inside the guarded
                   dispatch (next to kernel.hang). Payload: the active
                   device-name tuple (ops/kernel.py set_devices). Arm
                   per-device with `corrupt` mode and
                   sched.breaker.lost_device_fault(name) — raises
                   DeviceLost(name) while that device is in the payload;
                   a plain `raise` models an unattributed loss
  device.oom       ops/kernel.py record_dispatch, inside the guarded
                   dispatch (next to device.lost; payload: the active
                   device-name tuple). The capacity-fault seam: a
                   `raise` (or `corrupt` with sched.breaker.oom_fault()
                   raising ResourceExhausted) models the card running
                   out of memory — the scheduler classifies it as a
                   capacity fault (compact, halve the wave, host twin),
                   NEVER a device fault or a conviction
  snapshot.compact state/scrubber.py compact entry, BEFORE the
                   fault-suppressed rebuild (payload: (snapshot,
                   trigger)) — a `raise` fails the compaction; `latency`
                   models a slow sweep holding the scheduler lock
  snapshot.write   state/snapshot.py refresh_node_resources, AFTER the
                   row write (payload: (snapshot, node_idx) — the
                   `corrupt` mode's target)
  queue.shed       sched/queue.py _should_shed_locked — `drop` forces
                   the shed decision for every sheddable
                   (sub-threshold-priority, non-gang) pod regardless of
                   the watermark
  featurize.poison state/featurize.py _featurize_pod_guarded, AFTER the
                   per-pod finite validation (payload: (pod, row-dict)).
                   Arm `corrupt` with state.featurize.poison_pod_fault
                   (uid, kind): kind="crash" raises PodFeaturizeError
                   for exactly that pod; kind="nan" silently NaNs the
                   victim's req row — post-validation corruption only
                   the kernel's numeric-integrity sentinel catches
  wave.poison      sched/scheduler.py, before EVERY batched pass over a
                   pod list — the device round/wave/gang dispatches,
                   the degraded host-twin waves, AND the input-fault
                   attribution replay (payload: (pods, PodBatch)). With
                   poison_pod_fault(uid, "crash") the fault follows the
                   DATA across backends and classifies as an input
                   fault (breaker untouched); "nan" corrupts the
                   victim's batch row pre-upload (sentinel path)
  queue.quarantine sched/queue.py quarantine entry (payload: pod) —
                   `drop` refuses the quarantine (a lost conviction:
                   the scheduler falls back to a plain backoff park)
  autoscaler.simulate  ops/simulate.py simulate_placements /
                   simulate_refit entry — the autoscaler's what-if
                   passes (a `raise` models a faulting what-if: the
                   pass is skipped, no resize happens)
  cloud.resize     cloud/provider.py FakeCloud increase_size /
                   delete_nodes, BEFORE any mutation (payload: (op,
                   group, arg)) — a `raise` models a rejected cloud API
                   call; the autoscaler backs the group off
  heartbeat.deliver  kubelet/kubelet.py heartbeat entry (payload: node
                   name) — `drop` models the node status update never
                   reaching the apiserver (a partitioned node); the
                   nodelifecycle controller then sees a stale heartbeat
  nodelifecycle.evict  controllers/nodelifecycle.py, AFTER the zone
                   rate limiter admitted an eviction but BEFORE the pod
                   delete (payload: (pod key, node)) — `drop` models a
                   lost eviction call: the entry stays queued and
                   retries next pass; `raise` fails the monitor pass
  nodelifecycle.tally  ops/zonehealth.py device-path entry — a `raise`
                   forces the per-zone health reduction onto the exact
                   host fallback (and feeds the circuit breaker when
                   one is wired)
  autopilot.train  autopilot/trainer.py Trainer.fit entry (payload: the
                   LedgerDataset) — a `raise` fails a training job
                   cleanly before any candidate is emitted; `latency`
                   models a slow fit on a big ledger
  autopilot.promote  autopilot/controller.py _promote, BEFORE the
                   role=live write (payload: candidate name) — a
                   `raise` aborts the pipeline at the most dangerous
                   instant; the chaos assert is that nothing was
                   promoted, the gating flag is dropped, and the
                   outcome ledgered as `aborted`
  bind.post        sched/scheduler.py _bind_attempt, before each bind
                   POST attempt (the bind reconciler retries through
                   it; payload: the pod)
  watch.deliver    runtime/store.py _notify, before fan-out
  store.outage     the store-path outage seam, fired once per
                   control-plane round trip the scheduler depends on:
                   sched/scheduler.py _bind_attempt (before each bind
                   POST; payload ("bind", uid)) and _pod_truth (before
                   each truth GET; payload ("get", uid)),
                   client/reflector.py Reflector._list (before each
                   LIST; payload ("list", plural)) and RemoteStore._guard
                   (before each create / delete; payload the op). A
                   duration-armed `raise` severs the store path: the
                   store breaker (sched/storehealth.py) trips to
                   DISCONNECTED, binds spool into the intent journal,
                   and the post-heal drain leaves placements equal to
                   an outage-free run's
  rest.request     client/rest.py request_bytes + watch entry — every
                   control-plane round trip (payload: (method, path);
                   `drop` models the request never reaching the wire)
  reflector.relist client/reflector.py run, before each list+watch
                   cycle (exercises the jittered relist backoff)
  lease.renew      client/leaderelection.py _try_acquire_or_renew entry
                   (a `raise` fails renewals -> leadership loss after
                   renew_deadline; `latency` eats the renew budget)
  journal.append   state/journal.py _append_locked, BEFORE the write
                   (payload: the record dict) — `raise` models a full
                   disk / IO error at the worst moment (the intent
                   then spools in memory only), `drop` models a write
                   the OS acknowledged but never persisted (the
                   crash-restart replay must tolerate the hole)

Modes:

  raise    raise FaultInjected (or a caller-supplied exception factory)
  latency  time.sleep(arg seconds), then continue
  drop     fire() returns True — the call site skips the guarded action
  corrupt  invoke the fault's fn(payload) — or the default snapshot-row
           corruption (alloc[idx, CPU] += 4 cores, a silently wrong
           capacity the scrubber must catch) — then continue

Inactive cost: `fire()` is one module-global dict check. Activation is
programmatic (activate / injected context manager) or via the
environment, in the JAX package's grammar under a name of its own:

  KTPU_TORCH_FAULTPOINTS="kernel.wave=raise,kernel.hang=latency:0.5:1"
                    name=mode[:arg[:times]]  (comma-separated)

parse() validates a spec against registered_points(), the registry
above, which tests/test_torch_faults.py holds equal to the fire() call
sites of the package: an unknown point, an unknown mode or a malformed
field raises ValueError naming the token, and arms nothing.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional


class FaultInjected(RuntimeError):
    """The error raised by a `raise`-mode fault point."""

    def __init__(self, point: str):
        super().__init__(f"fault injected at {point!r}")
        self.point = point


class _Fault:
    __slots__ = ("name", "mode", "arg", "times", "fn", "exc", "hits")

    def __init__(self, name: str, mode: str, arg: float = 0.0,
                 times: Optional[int] = None,
                 fn: Optional[Callable] = None,
                 exc: Optional[Callable[[], BaseException]] = None):
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}")
        self.name = name
        self.mode = mode
        self.arg = arg
        self.times = times  # None = unlimited
        self.fn = fn
        self.exc = exc
        self.hits = 0


_MODES = ("raise", "latency", "drop", "corrupt")
_active: Dict[str, _Fault] = {}
_hits: Dict[str, int] = {}  # survives deactivate, for post-hoc asserts
_lock = threading.Lock()
_suppress = threading.local()  # per-thread: observers opt out of chaos


def _default_corrupt(payload) -> None:
    """The default silent-divergence corruption: inflate a snapshot
    node row's allocatable CPU by 4 cores. Allocatable is a topology
    field that no bind-path refresh overwrites, so the corruption
    persists until a node event or a scrub."""
    try:
        snap, idx = payload
        snap.alloc[idx, 0] += 4000.0  # RES_CPU column, milli-cpu
    except (TypeError, ValueError, AttributeError, IndexError):
        pass  # payload isn't a (snapshot, idx) pair: nothing to corrupt


def fire(name: str, payload=None) -> bool:
    """Hot-path hook. Returns True when a `drop`-mode fault is active
    (the caller must skip the guarded action); False otherwise. With no
    active faults this is a single dict check."""
    if not _active:
        return False
    if getattr(_suppress, "on", False):
        return False
    f = _active.get(name)
    if f is None:
        return False
    with _lock:
        if f.times is not None:
            if f.times <= 0:
                return False
            f.times -= 1
        f.hits += 1
        _hits[name] = _hits.get(name, 0) + 1
    if f.mode == "latency":
        time.sleep(f.arg)
        return False
    if f.mode == "drop":
        return True
    if f.mode == "corrupt":
        (f.fn or _default_corrupt)(payload)
        return False
    raise (f.exc() if f.exc is not None else FaultInjected(name))


def is_armed(name: str, mode: Optional[str] = None) -> bool:
    """Non-consuming probe: is the point armed (optionally in `mode`)
    with budget remaining? Unlike fire(), this neither counts a hit nor
    spends `times` (the queue's watermark release asks it without eating
    a times-bounded shed fault's per-pod budget)."""
    if not _active:
        return False
    if getattr(_suppress, "on", False):
        return False
    f = _active.get(name)
    if f is None or (mode is not None and f.mode != mode):
        return False
    return f.times is None or f.times > 0


def activate(name: str, mode: str = "raise", arg: float = 0.0,
             times: Optional[int] = None, fn: Optional[Callable] = None,
             exc: Optional[Callable[[], BaseException]] = None) -> None:
    """Arm a fault point. `times` bounds how many fires apply (None =
    every call); `fn` is the corrupt action; `exc` overrides the raised
    exception factory."""
    with _lock:
        _active[name] = _Fault(name, mode, arg=arg, times=times, fn=fn,
                               exc=exc)


def deactivate(name: str) -> None:
    with _lock:
        _active.pop(name, None)


def reset() -> None:
    """Disarm everything and forget hit counts (test teardown)."""
    with _lock:
        _active.clear()
        _hits.clear()


def active() -> bool:
    return bool(_active)


def hits(name: str) -> int:
    """Times the point actually applied (cumulative until reset())."""
    with _lock:
        return _hits.get(name, 0)


@contextmanager
def injected(name: str, mode: str = "raise", **kw):
    """Scope a fault to a `with` block."""
    activate(name, mode, **kw)
    try:
        yield
    finally:
        deactivate(name)


@contextmanager
def suppressed():
    """Disarm every fault point for the current thread inside the block,
    for observers of faulty state: the snapshot scrubber's golden-row
    build and repair writes go through the paths `snapshot.write`
    instruments, and an unbounded corrupt fault would otherwise corrupt
    the golden rows alike and re-corrupt each row as it is repaired."""
    prev = getattr(_suppress, "on", False)
    _suppress.on = True
    try:
        yield
    finally:
        _suppress.on = prev


def registered_points() -> frozenset:
    """The point names of the 'Wired points' registry in this module's
    docstring: what parse() validates against."""
    names = []
    in_registry = False
    for ln in (__doc__ or "").splitlines():
        if ln.startswith("Wired points"):
            in_registry = True
            continue
        if in_registry:
            if ln.startswith("Modes:"):
                break
            # entries are indented exactly two spaces; continuation
            # lines are indented further
            if ln.startswith("  ") and len(ln) > 2 and ln[2] != " ":
                names.append(ln.split()[0])
    return frozenset(names)


def parse(spec: str):
    """Parse "name=mode[:arg[:times]],..." into a list of
    (name, mode, arg, times) tuples. Raises ValueError naming the
    offending token for an unknown point, an unknown mode, a
    non-float or negative arg, a negative or non-int times, or extra
    fields."""
    out = []
    points = registered_points()
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"KTPU_TORCH_FAULTPOINTS: malformed token {item!r} "
                f"(expected name=mode[:arg[:times]])")
        name, rest = item.split("=", 1)
        name = name.strip()
        if name not in points:
            raise ValueError(
                f"KTPU_TORCH_FAULTPOINTS: unknown fault point {name!r} in "
                f"token {item!r} (see the utils/faultpoints.py registry)")
        parts = rest.split(":")
        if len(parts) > 3:
            raise ValueError(
                f"KTPU_TORCH_FAULTPOINTS: too many fields in token "
                f"{item!r} (expected name=mode[:arg[:times]])")
        mode = parts[0].strip() or "raise"
        if mode not in _MODES:
            raise ValueError(
                f"KTPU_TORCH_FAULTPOINTS: unknown mode {mode!r} in token "
                f"{item!r} (modes: {', '.join(_MODES)})")
        arg = 0.0
        if len(parts) > 1 and parts[1]:
            try:
                arg = float(parts[1])
            except ValueError:
                raise ValueError(
                    f"KTPU_TORCH_FAULTPOINTS: non-numeric arg "
                    f"{parts[1]!r} in token {item!r}") from None
            if arg < 0:
                raise ValueError(
                    f"KTPU_TORCH_FAULTPOINTS: negative arg {parts[1]!r} "
                    f"in token {item!r}")
        times = None
        if len(parts) > 2 and parts[2]:
            try:
                times = int(parts[2])
            except ValueError:
                raise ValueError(
                    f"KTPU_TORCH_FAULTPOINTS: non-integer times "
                    f"{parts[2]!r} in token {item!r}") from None
            if times < 0:
                raise ValueError(
                    f"KTPU_TORCH_FAULTPOINTS: negative times "
                    f"{parts[2]!r} in token {item!r}")
        out.append((name, mode, arg, times))
    return out


def activate_spec(spec: str) -> None:
    """Validate and arm a full spec string. All-or-nothing: a ValueError
    from parse() arms no point."""
    for name, mode, arg, times in parse(spec):
        activate(name, mode, arg=arg, times=times)


_env = os.environ.get("KTPU_TORCH_FAULTPOINTS", "")
if _env:
    activate_spec(_env)
