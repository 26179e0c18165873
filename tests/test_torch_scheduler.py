"""The lean Scheduler of kubernetes_tpu_torch end to end against the JAX
package's Scheduler: the same store contents give the same bindings.

These worlds run with preemption off in both packages (the placements of
the round and the per-wave fallback alone); tests/test_torch_preempt.py
and tests/test_torch_gang.py hold the two packages equal with
preemption on.
"""

import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from kubernetes_tpu.plugins.registry import default_profile
from kubernetes_tpu.sched.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.ops.encoding import Caps
from kubernetes_tpu_torch.sched.scheduler import Scheduler

from torch_guard import jax_watchdog_off, torch_one_thread  # noqa: F401
from torch_worlds import FakeClock, bindings, store_world

REPO = Path(__file__).resolve().parent.parent


def _jax_bindings(seed, n_nodes, n_pods):
    store, _ = store_world("kubernetes_tpu", seed, n_nodes, n_pods)
    profile = default_profile(store)
    profile.disable_preemption = True
    JaxScheduler(store, profile=profile).schedule_pending()
    return bindings(store)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bindings_match_the_jax_scheduler(seed):
    want = _jax_bindings(seed, 64, 600)
    store, names = store_world("kubernetes_tpu_torch", seed, 64, 600)
    sched = Scheduler(store, device="cpu", disable_preemption=True)
    placed = sched.schedule_pending()
    got = bindings(store)
    assert got == want
    assert placed == sum(1 for n in names if got[n])
    # the world leaves some pods unplaceable, and they are parked
    unplaced = [n for n in names if not got[n]]
    assert unplaced and placed > len(names) // 3
    assert {p.metadata.name for p in sched.unschedulable_pods()} == set(unplaced)
    assert sched.wave_path() == "torch-cpu"


def test_rounds_split_long_backlogs_identically(monkeypatch):
    """A backlog longer than one round: with the round capped at 4 waves
    of 16 pods, 300 pods take several rounds, the leftover of each going
    back to the queue before its round runs and the unplaced pods after
    it, in both packages. Pre-sized caps change nothing about the
    placements."""
    import kubernetes_tpu.sched.scheduler as jax_sched
    import kubernetes_tpu_torch.sched.scheduler as torch_sched

    monkeypatch.setattr(jax_sched, "PIPELINE_MAX_WAVES", 4)
    monkeypatch.setattr(torch_sched, "PIPELINE_MAX_WAVES", 4)
    store, _ = store_world("kubernetes_tpu", 3, 32, 300)
    profile = default_profile(store)
    profile.disable_preemption = True
    JaxScheduler(store, profile=profile, wave_size=16).schedule_pending()
    want = bindings(store)
    store_t, _ = store_world("kubernetes_tpu_torch", 3, 32, 300)
    sched = Scheduler(store_t, wave_size=16, device="cpu", caps=Caps(M=1024),
                      disable_preemption=True)
    rounds = []
    run = sched._run_pipeline
    monkeypatch.setattr(sched, "_run_pipeline",
                        lambda pods: (rounds.append(len(pods)), run(pods))[1])
    sched.schedule_pending()
    assert bindings(store_t) == want
    assert len(rounds) > 3 and rounds[0] == 300


def test_late_nodes_wake_parked_pods():
    """Pods that failed park with a backoff (unschedulable, or in the
    backoff area once an eviction moved them); a node that joins moves
    them without dropping any, and once the virtual clock passes their
    deadlines they place on it."""
    store, names = store_world("kubernetes_tpu_torch", 4, 8, 120)
    clock = FakeClock()
    sched = Scheduler(store, device="cpu", clock=clock)
    sched.schedule_pending()
    parked = len(sched.unschedulable_pods())
    assert parked > 0
    pending = sched.pending_count()
    store.create("nodes", tapi.Node(
        metadata=tapi.ObjectMeta(name="big", uid="node-big"),
        status=tapi.NodeStatus(
            allocatable=tapi.resource_list(cpu="64", memory="256Gi",
                                           pods=500),
            conditions=[tapi.NodeCondition(tapi.NODE_READY,
                                           tapi.COND_TRUE)])))
    assert not sched.unschedulable_pods()  # the node event moved them all
    assert sched.pending_count() == pending
    clock.advance(sched.backoff.maximum + 1)  # past every deadline
    assert sched.schedule_pending() > 0
    assert any(n == "big" for n in bindings(store).values())


def test_no_device_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from kubernetes_tpu_torch.runtime.store import ObjectStore

    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(ObjectStore())
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(ObjectStore(), device="cuda")


def _later_pods(pkg, kind):
    """The pods the port took in a later slice than the round: a pod with
    volumes, or with required pod anti-affinity over two topology keys (a
    gang member too), and a plain pod beside it."""
    api, lbl = (importlib.import_module(f"{pkg}.api.types"),
                importlib.import_module(f"{pkg}.api.labels"))
    spec, meta = {}, {}
    if kind in ("multi_topology_key", "gang_multi_topology_key"):
        sel = lbl.LabelSelector(match_labels={"app": "a"})
        spec["affinity"] = api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
            required=[api.PodAffinityTerm(
                label_selector=sel, topology_key="kubernetes.io/hostname"),
                api.PodAffinityTerm(
                label_selector=sel,
                topology_key="failure-domain.beta.kubernetes.io/zone")]))
    if kind == "volume":
        spec["volumes"] = [api.Volume(name="data")]
    if kind == "gang_multi_topology_key":
        meta["annotations"] = {api.POD_GROUP_NAME_ANNOTATION: "g"}
    return [api.Pod(metadata=api.ObjectMeta(name="later", uid="later", **meta),
                    spec=api.PodSpec(containers=[api.Container()], **spec)),
            api.Pod(metadata=api.ObjectMeta(name="plain", uid="plain"),
                    spec=api.PodSpec(containers=[api.Container()]))]


@pytest.mark.parametrize("kind,names", [("volume", "volume")])
def test_later_slice_backlogs_raise(kind, names):
    """Pods the port does not take yet raise for the whole backlog and
    are all left pending: pods with volumes."""
    store, _ = store_world("kubernetes_tpu_torch", 5, 8, 20)
    sched = Scheduler(store, device="cpu")
    sched.schedule_pending()
    for pod in _later_pods("kubernetes_tpu_torch", kind):
        store.create("pods", pod)
    pending = sched.pending_count()
    with pytest.raises(NotImplementedError, match=names):
        sched.schedule_pending()
    assert sched.pending_count() == pending  # nothing was dropped
    assert {"later", "plain"} <= {p.metadata.name
                                  for p in sched.queue.active_pods()}
    assert not bindings(store)["later"] and not bindings(store)["plain"]


@pytest.mark.parametrize("kind", ["gang_multi_topology_key",
                                  "multi_topology_key"])
def test_multi_topology_key_backlogs_place_as_jax(kind):
    """Pods with required pod anti-affinity over two topology keys, a gang
    member too, which the port once refused: they take the exact host
    path and place, with the plain pod beside them, where the JAX
    Scheduler places them, on the same virtual clock."""
    got = {}
    for pkg in ("kubernetes_tpu", "kubernetes_tpu_torch"):
        store, _ = store_world(pkg, 5, 8, 20)
        clock = FakeClock()
        sched = (JaxScheduler(store, clock=clock) if pkg == "kubernetes_tpu"
                 else Scheduler(store, device="cpu", clock=clock))
        sched.schedule_pending()
        for pod in _later_pods(pkg, kind):
            store.create("pods", pod)
        clock.advance(sched.backoff.maximum + 1)  # the parked pods return
        sched.schedule_pending()
        got[pkg] = bindings(store)
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    assert got["kubernetes_tpu_torch"]["later"]
    assert got["kubernetes_tpu_torch"]["plain"]


def test_port_imports_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import kubernetes_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.")
                     or n == "kubernetes_tpu" or n.startswith("kubernetes_tpu."))
        print(len([n for n in sys.modules if n.startswith(pkg.__name__)]))
        assert not bad, bad
        assert {"kubernetes_tpu_torch.ops.affinity",
                "kubernetes_tpu_torch.ops.topology"} <= set(sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was imported
