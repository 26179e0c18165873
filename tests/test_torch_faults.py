"""The port's fault points (kubernetes_tpu_torch/utils/faultpoints.py),
its device-path breaker in the scheduler, the dispatch watchdog and the
device attribution of failed dispatches, against the JAX package's
(tests/test_faults.py:29-206 and tests/test_chaos.py:291-384).

Scenarios that schedule run through both packages in lockstep (`Both`):
the same store writes, the same virtual clocks, each package's own
faults armed alike; after every step the bindings, the breaker (state,
consecutive failures, trips), the fault-point hit counts, the
round-robin mirror and the metrics must be equal. A kernel that cannot
be built raises out of the drain with the breaker CLOSED.
"""

import re
import time
from pathlib import Path

import pytest

from kubernetes_tpu.ops import kernel as jk
from kubernetes_tpu.utils import faultpoints as jfp
from kubernetes_tpu_torch.ops import cuda_build
from kubernetes_tpu_torch.ops import kernel as tk
from kubernetes_tpu_torch.runtime.store import ObjectStore
from kubernetes_tpu_torch.sched import scheduler as tsched
from kubernetes_tpu_torch.sched.breaker import (CLOSED, HALF_OPEN, OPEN,
                                                DeviceLost,
                                                DevicePathBreaker,
                                                lost_device_fault)
from kubernetes_tpu_torch.utils import faultpoints
from kubernetes_tpu_torch.utils.faultpoints import FaultInjected
from kubernetes_tpu_torch.utils.watchdog import (DispatchTimeout,
                                                 DispatchWatchdog)

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both, arm, check_faults, disarm
from torch_worlds import FakeClock, bindings, plain_node, plain_pod

TORCH = "kubernetes_tpu_torch"
PKG_DIR = Path(tsched.__file__).resolve().parent.parent
POINTS = ("kernel.round", "kernel.wave", "kernel.gang", "kernel.hang",
          "device.lost", "device.oom")


# -- fault points ----------------------------------------------------------


class TestFaultPoints:
    def test_inactive_is_noop(self):
        assert not faultpoints.active()
        assert faultpoints.fire("anything") is False
        assert faultpoints.hits("anything") == 0

    def test_raise_mode_and_times(self):
        faultpoints.activate("pt", "raise", times=2)
        with pytest.raises(FaultInjected):
            faultpoints.fire("pt")
        with pytest.raises(FaultInjected):
            faultpoints.fire("pt")
        assert faultpoints.fire("pt") is False  # exhausted
        assert faultpoints.hits("pt") == 2

    def test_custom_exception_factory(self):
        faultpoints.activate("pt", "raise", exc=lambda: ConnectionError("x"))
        with pytest.raises(ConnectionError):
            faultpoints.fire("pt")

    def test_latency_mode(self):
        faultpoints.activate("pt", "latency", arg=0.02)
        t0 = time.monotonic()
        assert faultpoints.fire("pt") is False
        assert time.monotonic() - t0 >= 0.015

    def test_drop_mode_returns_true(self):
        faultpoints.activate("pt", "drop", times=1)
        assert faultpoints.fire("pt") is True
        assert faultpoints.fire("pt") is False

    def test_context_manager_disarms(self):
        with faultpoints.injected("pt", "drop"):
            assert faultpoints.fire("pt") is True
        assert faultpoints.fire("pt") is False
        assert faultpoints.hits("pt") == 1  # hit history survives

    def test_corrupt_mode_and_suppression(self):
        seen = []
        faultpoints.activate("pt", "corrupt", fn=seen.append)
        assert faultpoints.fire("pt", payload=7) is False
        with faultpoints.suppressed():
            assert faultpoints.fire("pt", payload=8) is False
        assert seen == [7] and faultpoints.hits("pt") == 1

    def test_registries_are_separate(self):
        """Arming one package's point leaves the other's unarmed."""
        faultpoints.activate("kernel.wave", "raise")
        assert not jfp.active()
        assert jfp.fire("kernel.wave") is False
        jfp.activate("kernel.round", "raise")
        assert faultpoints.fire("kernel.round") is False

    def test_env_spec_parsing(self):
        faultpoints.activate_spec(
            "kernel.wave=raise, kernel.hang=latency:0.5, "
            "queue.quarantine=drop::3,")
        assert faultpoints._active["kernel.wave"].mode == "raise"
        assert faultpoints._active["kernel.hang"].mode == "latency"
        assert faultpoints._active["kernel.hang"].arg == 0.5
        assert faultpoints._active["queue.quarantine"].times == 3
        faultpoints.reset()
        for bad in ("=bad", "mesh.reform=raise", "kernel.wave=explode",
                    "kernel.wave=raise:x", "kernel.wave=raise:1:-2",
                    "kernel.wave=raise:1:2:3"):
            with pytest.raises(ValueError):
                faultpoints.activate_spec(bad)
        # all or nothing: a bad token arms nothing
        with pytest.raises(ValueError):
            faultpoints.activate_spec("kernel.wave=raise,nope=drop")
        assert not faultpoints.active()

    def test_registry_equals_the_fire_call_sites(self):
        """The docstring registry parse() validates against is exactly
        the set of points the package fires, both ways; and each is a
        point of the JAX registry too (the same seams)."""
        sites = set()
        for path in PKG_DIR.rglob("*.py"):
            sites |= set(re.findall(r'faultpoints\.fire\(\s*"([^"]+)"',
                                    path.read_text()))
        assert sites == set(faultpoints.registered_points())
        assert sites <= set(jfp.registered_points())


# -- the breaker ---------------------------------------------------------------


class TestBreakerStateMachine:
    def test_trip_cooldown_probe_recover(self):
        now = [0.0]
        recovered = []
        b = DevicePathBreaker(threshold=2, cooldown=10.0,
                              clock=lambda: now[0],
                              on_recover=lambda: recovered.append(1))
        assert b.allow() and b.state == CLOSED
        b.record_failure()
        assert b.state == CLOSED  # below threshold
        b.record_failure()
        assert b.state == OPEN and b.trips == 1
        assert not b.allow()
        now[0] += 9.9
        assert not b.allow()  # cooldown not elapsed
        now[0] += 0.2
        assert b.allow() and b.state == HALF_OPEN  # the probe
        b.record_success()
        assert b.state == CLOSED and recovered == [1]

    def test_half_open_failure_reopens_and_hang_trips_at_once(self):
        now = [0.0]
        b = DevicePathBreaker(threshold=1, cooldown=5.0,
                              clock=lambda: now[0])
        b.record_failure()
        assert b.state == OPEN
        now[0] += 6.0
        assert b.allow() and b.state == HALF_OPEN
        b.record_failure()
        assert b.state == OPEN and b.trips == 2
        assert not b.allow()  # fresh cooldown
        h = DevicePathBreaker(threshold=3, clock=lambda: 0.0)
        h.record_hang()
        assert h.state == OPEN and h.trips == 1

    def test_success_resets_consecutive_count(self):
        b = DevicePathBreaker(threshold=2, clock=lambda: 0.0)
        b.record_failure()
        b.record_success()
        b.record_failure()
        assert b.state == CLOSED  # never two CONSECUTIVE failures


def _faulted(n_nodes=3, threshold=2, **kw):
    return Both(n_nodes, wave=16,
                sched_kw=dict(breaker_threshold=threshold,
                              breaker_cooldown=30.0, **kw), cpu="4")


class TestDevicePathBreakerEndToEnd:
    def test_persistent_kernel_faults_never_stop_placement(self):
        b = _faulted()
        arm("kernel.round")
        arm("kernel.wave")
        for i in range(6):
            b.pod(f"p{i}", cpu="1")
        assert b.run() == 6  # every feasible pod landed via the twin
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.breaker.state == OPEN and t.breaker.trips == 1
        assert t.metrics.device_path_trips.value == 1
        assert t.metrics.scheduling_errors.value(stage="wave") >= 2
        assert t.metrics.scheduling_errors.value(
            stage="dispatch", device="unknown") == 0
        # while open: no device attempt is even made, the twin carries
        hits0 = (faultpoints.hits("kernel.round")
                 + faultpoints.hits("kernel.wave"))
        for i in range(3):
            b.pod(f"q{i}", cpu="1")
        assert b.run() == 3
        check_faults(b, POINTS)
        assert t.breaker.state == OPEN
        assert (faultpoints.hits("kernel.round")
                + faultpoints.hits("kernel.wave")) == hits0
        assert t.wave_path() == "host"

    def test_half_open_probe_recovers_device_path(self):
        b = _faulted()
        arm("kernel.round")
        arm("kernel.wave")
        for i in range(4):
            b.pod(f"p{i}", cpu="1")
        assert b.run() == 4
        assert b.sched["torch"].breaker.state == OPEN
        transitions = []
        t = b.sched["torch"]
        hook = t.breaker.on_state
        t.breaker.on_state = lambda s: (transitions.append(s), hook(s))
        # faults clear; the cooldown elapses; the probe re-admits the
        # device path and recovery re-uploads the whole device mirror
        disarm("kernel.round")
        disarm("kernel.wave")
        b.advance(31.0)
        for i in range(4):
            b.pod(f"q{i}", cpu="1")
        assert b.run() == 4
        check_faults(b, POINTS)
        assert t.breaker.state == CLOSED
        assert transitions == [HALF_OPEN, CLOSED]
        assert t.wave_path() == "torch-cpu"  # the device path executed
        assert t.metrics.breaker_state.value == 0

    def test_probe_failure_reopens_with_fresh_cooldown(self):
        b = _faulted(threshold=1)
        arm("kernel.round")
        arm("kernel.wave")
        b.pod("p0", cpu="1")
        assert b.run() == 1
        assert b.sched["torch"].breaker.state == OPEN
        b.advance(31.0)  # cooldown over, but the fault persists
        b.pod("p1", cpu="1")
        assert b.run() == 1  # the probe fails, the twin lands it
        check_faults(b, POINTS)
        assert b.sched["torch"].breaker.state == OPEN
        assert b.sched["torch"].breaker.trips == 2

    def test_times_bounded_faults_trip_both_packages_alike(self):
        """Three times-bounded faults (kernel.round once, kernel.wave
        twice: chip_smoke.py phase 17's ladder) at threshold 3: the hits,
        the trip and the twin-drained placements are equal; with the
        budget spent, the probe past the cooldown closes the breaker and
        the round-robin mirror keeps tie-breaks equal to the JAX
        scheduler's. A budget left over fails the probe alike."""
        b = _faulted(n_nodes=6, threshold=3)
        arm("kernel.round", times=1)
        arm("kernel.wave", times=2)
        for i in range(40):
            b.pod(f"p{i}", cpu="100m")
        b.run()
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.breaker.state == OPEN and t.breaker.trips == 1
        assert faultpoints.hits("kernel.round") == 1
        assert faultpoints.hits("kernel.wave") == 2
        assert t.metrics.waves_total.value(path="host") >= 1
        b.advance(31.0)
        for i in range(20):
            b.pod(f"after-{i}", cpu="100m")
        assert b.run() == 20
        check_faults(b, POINTS)
        assert t.breaker.state == CLOSED and t.wave_path() == "torch-cpu"
        assert all(v for v in bindings(b.stores["torch"]).values())
        arm("kernel.round", times=2)
        t.breaker.record_failure()
        b.sched["jax"].breaker.record_failure()
        t.breaker.record_failure()
        b.sched["jax"].breaker.record_failure()
        for i in range(5):
            b.pod(f"late-{i}", cpu="100m")
        assert b.run() == 5  # the third failure trips; the twin places
        check_faults(b, POINTS)
        assert t.breaker.trips == 2


# -- the watchdog -------------------------------------------------------------


def _watched(deadline=1.0, **kw):
    """A warmed pair of schedulers with the watchdog armed: both
    packages' dispatch programs of this shape are warm (a deadline-free
    pair drained the same shapes first), so their budget is the warm
    one. The deadline is some 20 times a healthy dispatch of this world
    on one CPU thread (25-45 ms for the port), so a loaded test host
    does not read as a hang."""
    warm = Both(4, wave=16, cpu="8", memory="16Gi")
    for i in range(4):
        warm.pod(f"warm-{i}", cpu="100m", memory="64Mi")
    assert warm.run() == 4
    return Both(4, wave=16, cpu="8", memory="16Gi",
                sched_kw=dict(wave_deadline_s=deadline,
                              breaker_cooldown=0.05, **kw))


def _wait_unwedged(b, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(
            s.watchdog.outstanding() for s in b.sched.values()):
        time.sleep(0.02)
    assert not any(s.watchdog.outstanding() for s in b.sched.values())


class TestWatchdogWedgedDispatch:
    def test_probe_deferred_until_wedged_dispatch_returns(self):
        """One wedged dispatch (a kernel.hang latency far past the
        deadline): the round is salvaged through the twin, the breaker
        opens at once; past the cooldown (virtual clock) the probe is
        NOT spent while the wedge runs; once it returns the next wave is
        the probe and closes the breaker. Equal in both packages."""
        b = _watched()
        arm("kernel.hang", "latency", arg=3.0, times=1)
        for i in range(4):
            b.pod(f"p-{i}", cpu="100m", memory="64Mi")
        assert b.run() == 4  # salvaged via the twin
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert t.breaker.state == OPEN
        assert t.watchdog.outstanding() == 1
        assert t.watchdog.abandoned_total == 1
        assert t.metrics.wave_deadline_overruns.value(stage="dispatch") == 1
        assert t.metrics.scheduling_errors.value(
            stage="dispatch", device="unknown") == 1
        b.advance(0.06)  # cooldown elapsed, the wedge still running
        b.pod("while-wedged", cpu="100m", memory="64Mi")
        assert b.run() == 1
        check_faults(b, POINTS)
        assert t.breaker.state == OPEN, "probe spent on a wedged device"
        assert t.wave_path() == "host"
        _wait_unwedged(b)
        b.pod("after-heal", cpu="100m", memory="64Mi")
        assert b.run() == 1
        check_faults(b, POINTS)
        assert t.breaker.state == CLOSED
        assert t.wave_path() == "torch-cpu"

    def test_half_open_probe_failure_reopens_while_hang_mode_persists(self):
        """EVERY dispatch hangs: the first trip opens, each probe past a
        cooldown hangs too, is abandoned and re-opens; placement never
        stops."""
        b = _watched()
        arm("kernel.hang", "latency", arg=1.5)
        total = 0
        for i in range(3):
            b.pod(f"w-{i}", cpu="100m", memory="64Mi")
            total += b.run()
            _wait_unwedged(b)
            b.advance(0.06)
        check_faults(b, POINTS)
        t = b.sched["torch"]
        assert total == 3
        assert t.breaker.state == OPEN
        assert t.breaker.trips >= 2  # the first trip + a probe's re-trip
        assert t.watchdog.drain(5.0)

    def test_watchdog_runs_the_dispatch_with_the_callers_state(self):
        """The worker thread takes the caller's inference mode (and, on a
        card, its device and stream): what the dispatch sees equals what
        the caller would have seen."""
        import torch

        wd = DispatchWatchdog(5.0)
        with torch.inference_mode():
            assert wd.run(torch.is_inference_mode_enabled) is True
        assert wd.run(torch.is_inference_mode_enabled) is False
        with pytest.raises(ZeroDivisionError):
            wd.run(lambda: 1 / 0)
        slow = DispatchWatchdog(0.05)
        with pytest.raises(DispatchTimeout):
            slow.run(lambda: time.sleep(0.3), program="round")
        assert slow.abandoned_total == 1 and slow.outstanding() == 1
        assert slow.drain(2.0) and slow.outstanding() == 0

    def test_host_overrun_halves_then_restores_the_wave_cap(self):
        """Host stages over wave_deadline_s halve the adaptive wave cap
        (floor MIN_ADAPTIVE_WAVE), fast ones double it back."""
        s = tsched.Scheduler(ObjectStore(), wave_size=64, device="cpu",
                             clock=FakeClock(), wave_deadline_s=1.0)
        s._account_host_overrun(2.0)
        assert s._wave_cap == 32
        s._account_host_overrun(2.0)
        s._account_host_overrun(2.0)
        assert s._wave_cap == 16  # the floor
        assert s.metrics.wave_deadline_overruns.value(stage="host") == 3
        s._account_host_overrun(0.1)
        s._account_host_overrun(0.1)
        assert s._wave_cap == 64
        assert s.metrics.effective_wave_size.value == 64


# -- attribution and kernels that cannot be built ------------------------------


def test_failed_dispatches_are_attributed_like_the_reference():
    """_attribute_device of both packages over the same registered
    devices and exception texts; the port registers its active device,
    and a device.lost fault naming it is counted on that device."""
    devices = ("cuda:0", "cuda:1")
    saved = jk._DEVICES, tk._DEVICES
    try:
        jk.set_devices(devices)
        tk.set_devices(devices)
        for exc in (RuntimeError("CUDA error on cuda:1: launch failed"),
                    RuntimeError("cuda:10 is not cuda:1"),
                    RuntimeError("cuda:0 and cuda:1 both"),
                    RuntimeError("no device named"), DeviceLost("cuda:0")):
            assert tk._attribute_device(exc) == jk._attribute_device(exc)
        assert tk._attribute_device(DeviceLost("cuda:0")) == "cuda:0"
    finally:
        jk._DEVICES, tk._DEVICES = saved
    store = ObjectStore()
    sched = tsched.Scheduler(store, wave_size=8, device="cpu",
                             clock=FakeClock(), breaker_threshold=1)
    assert tk._DEVICES == ("cpu",)
    for i in range(3):
        store.create("nodes", plain_node(TORCH, f"n{i}"))
    faultpoints.activate("device.lost", "corrupt",
                         fn=lost_device_fault("cpu"))
    for i in range(4):
        store.create("pods", plain_pod(TORCH, f"p{i}", cpu="1"))
    assert sched.schedule_pending() == 4  # salvaged through the twin
    assert sched.metrics.scheduling_errors.value(
        stage="dispatch", device="cpu") >= 1
    assert sched.breaker.state == OPEN
    faultpoints.activate("device.lost", "corrupt",
                         fn=lost_device_fault("cuda:3"))
    sched.breaker.record_success()
    store.create("pods", plain_pod(TORCH, "q", cpu="1"))
    assert sched.schedule_pending() == 1
    assert sched.wave_path() == "torch-cpu"  # another device's loss


def test_kernel_build_and_load_errors_raise_with_the_breaker_closed(
        monkeypatch, tmp_path):
    """A kernel that cannot be built or loaded raises KernelBuildError,
    which the scheduler re-raises with the popped pods back in the
    queue: never a device failure, never the twin."""
    with pytest.raises(cuda_build.KernelBuildError, match="cannot load"):
        cuda_build.load_library(tmp_path / "libmissing.so")
    src = tmp_path / "k.cu"
    src.write_text("int main(void) { return 0; }\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "false")
    with pytest.raises(cuda_build.KernelBuildError, match="nvcc failed"):
        cuda_build.compile_shared(src, "k")

    def unbuilt(*a, **kw):
        raise cuda_build.KernelBuildError("nvcc failed to build "
                                          "taint_ports.cu")

    store = ObjectStore()
    sched = tsched.Scheduler(store, wave_size=8, device="cpu",
                             clock=FakeClock(), breaker_threshold=1)
    for i in range(3):
        store.create("nodes", plain_node(TORCH, f"n{i}"))
    for i in range(4):
        store.create("pods", plain_pod(TORCH, f"p{i}", cpu="1"))
    monkeypatch.setattr(tsched, "schedule_round", unbuilt)
    monkeypatch.setattr(tsched, "schedule_wave", unbuilt)
    with pytest.raises(cuda_build.KernelBuildError):
        sched.schedule_pending()
    assert sched.breaker.state == CLOSED and sched.breaker.failures == 0
    assert sched.metrics.scheduling_errors.value(stage="wave") == 0
    assert sched.pending_count() == 4
    assert not any(bindings(store).values())
    with pytest.raises(cuda_build.KernelBuildError):
        sched._device_failure(cuda_build.KernelBuildError("x"))
    assert sched.breaker.failures == 0


@pytest.mark.parametrize("path", ["round", "wave", "gang", "whatif"])
def test_wrapper_refusals_raise_with_the_breaker_closed(monkeypatch, path):
    """A kernel wrapper that refuses its inputs (KernelInputError: a slot
    count, shared memory or shape the built kernel cannot take) raises
    out of the drain on every dispatch path, as a build failure does:
    the breaker stays CLOSED, no wave goes to the twin and the pods are
    back in the queue."""
    def refused(*a, **kw):
        raise cuda_build.KernelInputError(
            "taint_ports kernel is built for at most 16 taint slots")

    store = ObjectStore()
    sched = tsched.Scheduler(store, wave_size=8, device="cpu",
                             clock=FakeClock(), breaker_threshold=1)
    for i in range(2):
        store.create("nodes", plain_node(TORCH, f"n{i}"))
    if path == "whatif":
        sched.device_preemption = True
        for i in range(2):
            store.create("pods", plain_pod(TORCH, f"hog{i}", cpu="4",
                                           priority=1))
        assert sched.schedule_pending() == 2
        store.create("pods", plain_pod(TORCH, "vip", cpu="4",
                                       priority=100))
        monkeypatch.setattr(tsched, "preemption_stats", refused)
    elif path == "gang":
        for i in range(2):
            store.create("pods", plain_pod(TORCH, f"g{i}", cpu="1",
                                           gang="g", min_avail=2))
        monkeypatch.setattr(tsched, "schedule_gang", refused)
    else:
        for i in range(4):
            store.create("pods", plain_pod(TORCH, f"p{i}", cpu="1"))
        monkeypatch.setattr(tsched, "schedule_round", refused)
        monkeypatch.setattr(tsched, "schedule_wave", refused)
    drain = sched.run_once if path == "wave" else sched.schedule_pending
    with pytest.raises(cuda_build.KernelInputError, match="16 taint"):
        drain()
    assert sched.breaker.state == CLOSED and sched.breaker.failures == 0
    assert sched.breaker.trips == 0
    assert sched.metrics.scheduling_errors.value(stage="wave") == 0
    assert sched.metrics.waves_total.value(path="host") == 0
    assert sched.pending_count() == (1 if path == "whatif" else
                                     2 if path == "gang" else 4)


def test_wrapper_refusals_are_kernel_input_errors():
    """The wrappers' own checks raise KernelInputError, a KernelBuildError
    the scheduler re-raises, and still a ValueError or TypeError to
    callers that catch those."""
    import torch

    from kubernetes_tpu_torch.ops import preempt, taint_ports

    i32 = torch.zeros((2, 2), dtype=torch.int32)
    cpu = torch.device("cpu")
    with pytest.raises(cuda_build.KernelInputError, match="must be int32"):
        taint_ports._check("x", i32.float(), cpu)
    with pytest.raises(TypeError):
        taint_ports._check("x", i32.float(), cpu)
    with pytest.raises(ValueError, match="2-D"):
        taint_ports._check("x", i32[0], cpu)
    with pytest.raises(cuda_build.KernelInputError, match="shape"):
        preempt._contig("x", i32, torch.int32, (3, 2), cpu)
    nt, pb = taint_ports.random_tables(4, 4, 0, device="meta")
    with pytest.raises(cuda_build.KernelInputError,
                       match="unsupported device"):
        taint_ports.taint_ports_masks(nt, pb)
    assert issubclass(cuda_build.KernelInputError,
                      cuda_build.KernelBuildError)
