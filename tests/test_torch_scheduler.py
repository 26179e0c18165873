"""The lean Scheduler of kubernetes_tpu_torch end to end against the JAX
package's Scheduler: the same store contents give the same bindings.

The JAX scheduler runs with preemption off: preemption is a later slice
of the port, and with it on the reference evicts lower-priority pods
that the port leaves in place.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from kubernetes_tpu.plugins.registry import default_profile
from kubernetes_tpu.sched.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu_torch.api import labels as tlbl
from kubernetes_tpu_torch.api import types as tapi
from kubernetes_tpu_torch.ops.encoding import Caps
from kubernetes_tpu_torch.sched.scheduler import Scheduler

from torch_guard import jax_watchdog_off, torch_one_thread  # noqa: F401
from torch_worlds import bindings, store_world

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
    sched = Scheduler(store, device="cpu")
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
    sched = Scheduler(store_t, wave_size=16, device="cpu", caps=Caps(M=1024))
    rounds = []
    run = sched._run_pipeline
    monkeypatch.setattr(sched, "_run_pipeline",
                        lambda pods: (rounds.append(len(pods)), run(pods))[1])
    sched.schedule_pending()
    assert bindings(store_t) == want
    assert len(rounds) > 3 and rounds[0] == 300


def test_late_nodes_wake_parked_pods():
    store, names = store_world("kubernetes_tpu_torch", 4, 8, 120)
    sched = Scheduler(store, device="cpu")
    sched.schedule_pending()
    parked = len(sched.unschedulable_pods())
    assert parked > 0
    store.create("nodes", tapi.Node(
        metadata=tapi.ObjectMeta(name="big", uid="node-big"),
        status=tapi.NodeStatus(
            allocatable=tapi.resource_list(cpu="64", memory="256Gi",
                                           pods=500),
            conditions=[tapi.NodeCondition(tapi.NODE_READY,
                                           tapi.COND_TRUE)])))
    assert sched.pending_count() == parked
    assert sched.schedule_pending() > 0
    assert any(n == "big" for n in bindings(store).values())


def test_no_device_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from kubernetes_tpu_torch.runtime.store import ObjectStore

    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(ObjectStore())
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(ObjectStore(), device="cuda")


@pytest.mark.parametrize("kind,names", [
    ("gang", "ops/gang.py"), ("volume", "volume"),
    ("multi_topology_key", "plugins/golden.py")])
def test_later_slice_backlogs_raise(kind, names):
    """Pods the port does not take yet raise for the whole backlog and
    are all left pending: gangs, volumes, and required pod
    anti-affinity over two topology keys (the JAX package's exact host
    path)."""
    store, _ = store_world("kubernetes_tpu_torch", 5, 8, 20)
    sched = Scheduler(store, device="cpu")
    sched.schedule_pending()
    spec, meta = {}, {}
    if kind == "multi_topology_key":
        sel = tlbl.LabelSelector(match_labels={"app": "a"})
        spec["affinity"] = tapi.Affinity(pod_anti_affinity=tapi.PodAntiAffinity(
            required=[tapi.PodAffinityTerm(
                label_selector=sel, topology_key="kubernetes.io/hostname"),
                tapi.PodAffinityTerm(
                label_selector=sel,
                topology_key="failure-domain.beta.kubernetes.io/zone")]))
    elif kind == "volume":
        spec["volumes"] = [tapi.Volume(name="data")]
    else:
        meta["annotations"] = {tapi.POD_GROUP_NAME_ANNOTATION: "g"}
    store.create("pods", tapi.Pod(
        metadata=tapi.ObjectMeta(name="later", uid="later", **meta),
        spec=tapi.PodSpec(containers=[tapi.Container()], **spec)))
    store.create("pods", tapi.Pod(
        metadata=tapi.ObjectMeta(name="plain", uid="plain"),
        spec=tapi.PodSpec(containers=[tapi.Container()])))
    pending = sched.pending_count()
    with pytest.raises(NotImplementedError, match=names):
        sched.schedule_pending()
    assert sched.pending_count() == pending  # nothing was dropped
    assert {"later", "plain"} <= {p.metadata.name
                                  for p in sched._active.values()}
    assert not bindings(store)["later"] and not bindings(store)["plain"]


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
