"""Guards for the port's parity tests: the JAX dispatch watchdog
disarmed, one PyTorch intra-op thread, and both packages' fault
registries and the port's dispatch watchdog cleared after each test.

kubernetes_tpu's dispatch watchdog is process-global
(kubernetes_tpu/ops/kernel.py `set_watchdog`): a JAX Scheduler built
with `wave_deadline_s` arms it, and a test that never disarms it leaves
it armed for every later test on the same worker. A cold JAX program
(the first has_ipa / has_ts compile takes seconds on the CPU) then
overruns its deadline and raises DispatchTimeout. Import the fixture
into a test module that dispatches JAX programs:

    from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                             torch_one_thread)

It saves the watchdog, disarms it for the test and restores it after;
nothing in the JAX package changes.

The parity tests' tensors are small, and the suite runs in several
worker processes at once: PyTorch's default of one intra-op thread per
core then oversubscribes the cores many times over, and the per-pod
loops of small ops slow down several-fold, taking CPU time from the
timing-sensitive tests of other workers. `torch_one_thread` runs each
test on one thread and restores the count after. The thread count
cannot change a result: the port's reductions are over booleans,
integers and integer-valued floats.

`faults_off` resets the fault registries of both packages
(kubernetes_tpu/utils/faultpoints.py and kubernetes_tpu_torch/utils/
faultpoints.py, each process-global) and clears the port's dispatch
watchdog (kubernetes_tpu_torch/ops/kernel.py `set_watchdog`) after the
test, draining a watchdog a test armed, so that neither a fault nor a
watchdog outlives the test that armed it. Before the test it stops the
reflector threads (either package's client/reflector.py) that earlier
tests on the worker left running against servers they stopped: each
retry of theirs fires `store.outage`, `reflector.relist` and
`rest.request` in a registry the test may arm and count (the JAX-side
test_proxy.py leak of ROADMAP queue 3 met the port's store-plane tests
so). It stops the leader electors (either package's
client/leaderelection.py) that earlier tests left running the same
way: each acquire or renew attempt fires `lease.renew`, and the
elector of a failed tests/test_apiserver.py lease test, left retrying
against its stopped server, took `lease.renew` hits from the JAX side of
the campaign lockstep (ROADMAP.md queue 3).
"""

import threading

import pytest
import torch

from kubernetes_tpu.ops import kernel as jax_kernel
from kubernetes_tpu.utils import faultpoints as jax_faultpoints
from kubernetes_tpu_torch.ops import kernel as torch_kernel
from kubernetes_tpu_torch.utils import faultpoints as torch_faultpoints


@pytest.fixture(autouse=True)
def jax_watchdog_off():
    saved = jax_kernel._WATCHDOG
    jax_kernel.set_watchdog(None)
    yield
    jax_kernel.set_watchdog(saved)


@pytest.fixture(autouse=True)
def torch_one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _stop_leaked_reflectors():
    for t in threading.enumerate():
        refl = getattr(getattr(t, "_target", None), "__self__", None)
        if t.name.startswith("reflector-") and hasattr(refl, "synced"):
            refl.stop()


def _stop_leaked_electors():
    for t in threading.enumerate():
        elector = getattr(getattr(t, "_target", None), "__self__", None)
        if t.name.startswith("leaderelection-") and \
                hasattr(elector, "renew_deadline"):
            elector.stop()
            t.join(timeout=5.0)


@pytest.fixture(autouse=True)
def faults_off():
    _stop_leaked_reflectors()
    _stop_leaked_electors()
    yield
    jax_faultpoints.reset()
    torch_faultpoints.reset()
    wd = torch_kernel._WATCHDOG
    torch_kernel.set_watchdog(None)
    if wd is not None:
        wd.drain(timeout=10.0)
