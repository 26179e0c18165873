"""The lean Scheduler of kubernetes_tpu_torch end to end against the JAX
package's Scheduler: the same store contents give the same bindings.

These worlds run with preemption off in both packages (the placements of
the round and the per-wave fallback alone); tests/test_torch_preempt.py
and tests/test_torch_gang.py hold the two packages equal with
preemption on.
"""

import ast
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

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
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
    monkeypatch.setattr(
        sched, "_run_pipeline",
        lambda pods, **kw: (rounds.append(len(pods)), run(pods, **kw))[1])
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
        spec["volumes"] = [api.Volume(name="data",
                                      source_kind="GCEPersistentDisk",
                                      source_id="pd-data")]
    if kind == "gang_multi_topology_key":
        meta["annotations"] = {api.POD_GROUP_NAME_ANNOTATION: "g"}
    return [api.Pod(metadata=api.ObjectMeta(name="later", uid="later", **meta),
                    spec=api.PodSpec(containers=[api.Container()], **spec)),
            api.Pod(metadata=api.ObjectMeta(name="plain", uid="plain"),
                    spec=api.PodSpec(containers=[api.Container()]))]


@pytest.mark.parametrize("kind,names", [("volume", "volume")])
def test_later_slice_backlogs_raise(kind, names):
    """Pods with volumes (`names`), which the port once refused with
    NotImplementedError for the whole backlog, now raise nothing: the
    pod with an inline GCE PD, which the host filters read, and the plain
    pod beside it place where the JAX Scheduler places them, on the same
    virtual clock."""
    got = {}
    for pkg in ("kubernetes_tpu", "kubernetes_tpu_torch"):
        store, _ = store_world(pkg, 5, 8, 20)
        clock = FakeClock()
        sched = (JaxScheduler(store, clock=clock) if pkg == "kubernetes_tpu"
                 else Scheduler(store, device="cpu", clock=clock))
        sched.schedule_pending()
        for pod in _later_pods(pkg, kind):
            store.create("pods", pod)
        sched.schedule_pending()
        got[pkg] = bindings(store)
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    assert got["kubernetes_tpu_torch"]["later"]
    assert got["kubernetes_tpu_torch"]["plain"]


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
                "kubernetes_tpu_torch.ops.topology",
                "kubernetes_tpu_torch.utils.feature_gates",
                "kubernetes_tpu_torch.plugins.volumes",
                "kubernetes_tpu_torch.plugins.registry",
                "kubernetes_tpu_torch.sched.equivalence",
                "kubernetes_tpu_torch.sched.extender",
                "kubernetes_tpu_torch.sched.volume_binder",
                "kubernetes_tpu_torch.sched.weights",
                "kubernetes_tpu_torch.ops.telemetry",
                "kubernetes_tpu_torch.utils.tracing",
                "kubernetes_tpu_torch.utils.trace",
                "kubernetes_tpu_torch.utils.profiling",
                "kubernetes_tpu_torch.autopilot.dataset",
                "kubernetes_tpu_torch.autopilot.trainer",
                "kubernetes_tpu_torch.autopilot.replay",
                "kubernetes_tpu_torch.autopilot.controller",
                "kubernetes_tpu_torch.cli.autopilot",
                "kubernetes_tpu_torch.chaos.invariants",
                "kubernetes_tpu_torch.chaos.campaign",
                "kubernetes_tpu_torch.chaos.__main__",
                "kubernetes_tpu_torch.kubemark.hollow",
                "kubernetes_tpu_torch.kubelet.kubelet",
                "kubernetes_tpu_torch.kubelet.server",
                "kubernetes_tpu_torch.proxy.proxier",
                "kubernetes_tpu_torch.proxy.userspace",
                "kubernetes_tpu_torch.volume.csi",
                "kubernetes_tpu_torch.volume.manager",
                "kubernetes_tpu_torch.controllers.expand",
                "kubernetes_tpu_torch.controllers.manager",
                "kubernetes_tpu_torch.controllers.bootstrap",
                "kubernetes_tpu_torch.server.aggregator",
                "kubernetes_tpu_torch.server.reconciler",
                "kubernetes_tpu_torch.server.serviceaccount",
                "kubernetes_tpu_torch.cli.kubeadm",
                "kubernetes_tpu_torch.cli.kubeconfig"} <= set(sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was imported


def _module_file(root, name):
    """The file of a module under root by dotted name, or None."""
    path = root.joinpath(*name.split("."))
    for f in (path / "__init__.py", path.with_suffix(".py")):
        if f.is_file():
            return f
    return None


def _top_level_names(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return names


def port_import_faults(root):
    """Every import statement of the port's modules, those inside
    functions too, that names jax or the JAX package, or a module of the
    port that does not exist (a relative import, or one spelled
    kubernetes_tpu_torch...). A name imported from a package must be a
    module of it or defined at the top of its __init__.py."""
    pkg = "kubernetes_tpu_torch"
    faults = []
    for path in sorted((root / pkg).rglob("*.py")):
        here = list(path.relative_to(root).with_suffix("").parts[:-1])
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                targets = [(a.name, ()) for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = here[:len(here) - node.level + 1]
                    name = ".".join(base + ([node.module] if node.module
                                            else []))
                else:
                    name = node.module
                targets = [(name, [a.name for a in node.names])]
            else:
                continue
            for name, names in targets:
                top = name.split(".")[0]
                where = f"{path.relative_to(root)}:{node.lineno}"
                if top in ("jax", "kubernetes_tpu"):
                    faults.append(f"{where} imports {name}")
                    continue
                if top != pkg:
                    continue
                target = _module_file(root, name)
                if target is None:
                    faults.append(f"{where}: no module {name}")
                    continue
                if target.name != "__init__.py":
                    continue
                defined = _top_level_names(target)
                faults += [f"{where}: no {name}.{n}" for n in names
                           if n != "*" and n not in defined
                           and _module_file(root, f"{name}.{n}") is None]
    return faults


def test_every_port_import_resolves_to_a_port_module():
    """A static pass over the port, imports inside functions included:
    the import guard above imports module tops only, and so never saw
    the three lazy imports of server/apiserver.py and server/auth.py
    that named modules the port did not have."""
    assert port_import_faults(REPO) == []


def test_the_static_pass_finds_a_dangling_lazy_import(tmp_path):
    pkg = tmp_path / "kubernetes_tpu_torch"
    (pkg / "server").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "server" / "__init__.py").write_text("X = 1\n")
    (pkg / "server" / "auth.py").write_text(textwrap.dedent("""
        from . import X
        def f():
            from . import serviceaccount as sat
            from ..controllers.bootstrap import lookup_token
            import jax
            from kubernetes_tpu.api import types
            from . import Y
    """))
    assert port_import_faults(tmp_path) == [
        "kubernetes_tpu_torch/server/auth.py:4: no "
        "kubernetes_tpu_torch.server.serviceaccount",
        "kubernetes_tpu_torch/server/auth.py:5: no module "
        "kubernetes_tpu_torch.controllers.bootstrap",
        "kubernetes_tpu_torch/server/auth.py:6 imports jax",
        "kubernetes_tpu_torch/server/auth.py:7 imports kubernetes_tpu.api",
        "kubernetes_tpu_torch/server/auth.py:8: no "
        "kubernetes_tpu_torch.server.Y"]
