"""The port's controller roster (kubernetes_tpu_torch/controllers/, with
the manager, server/aggregator.py, server/reconciler.py,
server/serviceaccount.py and controllers/bootstrap.py) against the JAX
package's, on the CPU.

Each scenario runs once in each package (`W(pkg)` holds its modules and
a fresh store) and returns what it observed: the values the reference
test asserts on, and snapshots of the whole store, every object encoded
by the package's own api/scheme.py. The two runs must return the same.
Masked before the comparison: object uids (a process-wide counter in
each package) and the pod addresses of Endpoints (a hash of the uid),
wall-clock timestamps, and the data of Secrets (service
account tokens are signed with a random key, bootstrap tokens are
random); where a scenario needs them, it compares what they verify to
instead. The ReplicaSet and Job controllers name pods from a
process-wide counter: each run starts both counters at 1.

The scenarios are those of tests/test_controllers.py, the TTL,
endpoint-reconciler, certificates and roster cases of
tests/test_bootstrap.py, the token, signer, cleaner and aggregation cases
of tests/test_bootstrap_tokens.py, the service-account token cases of
tests/test_auth.py and the cloud roster of tests/test_cloud.py:239.
The node-lifecycle controller takes device="cpu" in the port, and so
does the port's ControllerManager.
"""

import copy
import importlib
import itertools
import re
import time

import pytest

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")
_UID = re.compile(r"uid-\d+")
# encoded keys whose values are wall-clock seconds in some scenarios
TIME_KEYS = {"startTime", "completionTime", "lastScheduleTime",
             "lastScaleTime", "firstTimestamp", "lastTimestamp",
             "deletionTimestamp", "acquireTime", "renewTime"}


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def strip(x):
    """x with uids and wall-clock timestamps masked, recursively."""
    if isinstance(x, str):
        return _UID.sub("uid-*", x)
    if isinstance(x, dict):
        return {k: ("t" if k in TIME_KEYS and v is not None else strip(v))
                for k, v in x.items() if k != "uid"}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


class W:
    """One package's side of a scenario: its modules and a fresh store."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.api = mod(pkg, "api.types")
        self.lbl = mod(pkg, "api.labels")
        self.c = mod(pkg, "controllers")
        self.nl = mod(pkg, "controllers.nodelifecycle")
        self.bt = mod(pkg, "controllers.bootstrap")
        self.store = mod(pkg, "runtime.store").ObjectStore()
        api = self.api
        self.SEL = self.lbl.LabelSelector(match_labels={"app": "w"})
        self.TMPL = api.PodTemplateSpec(
            metadata=api.ObjectMeta(labels={"app": "w"}),
            spec=api.PodSpec(containers=[api.Container(
                resources=api.ResourceRequirements(
                    requests=api.resource_list(cpu="100m",
                                               memory="64Mi")))]))

    def m(self, name):
        return mod(self.pkg, name)

    @property
    def dev(self):
        return {"device": "cpu"} if self.pkg == "kubernetes_tpu_torch" \
            else {}

    def manager(self, **kw):
        return self.c.ControllerManager(self.store, **self.dev, **kw)

    def nlc(self, **kw):
        return self.c.NodeLifecycleController(self.store, **self.dev, **kw)

    def snap(self):
        """Every object of the store, encoded, uids and times masked,
        Secret data masked."""
        enc = self.m("api.scheme").encode
        out = {}
        for kind in sorted(self.store._objects):
            objs = [strip(enc(o)) for o in self.store.list(kind)]
            if kind == "secrets":
                for o in objs:
                    if "data" in o:
                        o["data"] = sorted(o["data"])
            if kind == "endpoints":
                # a pod's address is a hash of its uid (kubelet/network.py
                # HashIPPlugin), masked like the uid; the addresses are
                # sorted by it, so they are compared by pod
                for o in objs:
                    for sub in o.get("subsets", []):
                        for key in ("addresses", "notReadyAddresses"):
                            addrs = sub.get(key, [])
                            for a in addrs:
                                if "targetPod" in a:
                                    a["ip"] = "pod-ip"
                            addrs.sort(key=lambda a: (a.get("targetPod", ""),
                                                      a["ip"]))
            out[kind] = objs
        return out

    def names(self, kind, ns=None):
        return [o.metadata.name for o in self.store.list(kind, ns)]

    def mark_running(self, pod, ready=True):
        pod.status.phase = "Running"
        pod.status.conditions = [c for c in pod.status.conditions
                                 if c[0] != "Ready"] + \
            [("Ready", "True" if ready else "False")]
        self.store.update("pods", pod)

    def mknode(self, name, ready=True, hb=None, taints=None):
        api = self.api
        ann = {self.nl.HEARTBEAT_ANNOTATION: str(hb)} if hb is not None \
            else {}
        node = api.Node(
            metadata=api.ObjectMeta(name=name, annotations=ann),
            status=api.NodeStatus(
                allocatable=api.resource_list(cpu="8", memory="16Gi",
                                              pods=110),
                conditions=[api.NodeCondition(
                    api.NODE_READY,
                    api.COND_TRUE if ready else api.COND_FALSE)]))
        if taints:
            node.spec.taints = taints
        return node


def both(scenario, monkeypatch):
    """scenario(W(pkg)) in each package, the ReplicaSet and Job name
    counters at 1 for each; the two results must be equal."""
    got = {}
    for pkg in PKGS:
        for name in ("replicaset", "job"):
            monkeypatch.setattr(mod(pkg, f"controllers.{name}"), "_suffix",
                                itertools.count(1))
        got[pkg] = scenario(W(pkg))
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    return got["kubernetes_tpu_torch"]


# -- tests/test_controllers.py ------------------------------------------------


def rs_scale(w):
    ctrl = w.c.ReplicaSetController(w.store)
    w.store.create("replicasets", w.api.ReplicaSet(
        metadata=w.api.ObjectMeta(name="rs1"),
        spec=w.api.ReplicaSetSpec(replicas=3, selector=w.SEL,
                                  template=w.TMPL)))
    ctrl.sync_all()
    seen = [w.snap()]
    for p in w.store.list("pods"):
        w.mark_running(p)
    ctrl.sync_all()
    seen.append(w.snap())
    rs = w.store.get("replicasets", "default", "rs1")
    rs.spec.replicas = 1
    w.store.update("replicasets", rs)
    ctrl.sync_all()
    return seen + [w.snap()]


def rs_victims(w):
    ctrl = w.c.ReplicaSetController(w.store)
    w.store.create("replicasets", w.api.ReplicaSet(
        metadata=w.api.ObjectMeta(name="rs1"),
        spec=w.api.ReplicaSetSpec(replicas=2, selector=w.SEL,
                                  template=w.TMPL)))
    ctrl.sync_all()
    pods = w.store.list("pods")
    w.mark_running(pods[0], ready=True)
    w.mark_running(pods[1], ready=False)
    rs = w.store.get("replicasets", "default", "rs1")
    rs.spec.replicas = 1
    w.store.update("replicasets", rs)
    ctrl.sync_all()
    return [w.names("pods"), pods[0].metadata.name, w.snap()]


def deployment_rollout(w):
    dep_ctrl = w.c.DeploymentController(w.store)
    rs_ctrl = w.c.ReplicaSetController(w.store)
    w.store.create("deployments", w.api.Deployment(
        metadata=w.api.ObjectMeta(name="d1"),
        spec=w.api.DeploymentSpec(replicas=3, selector=w.SEL,
                                  template=w.TMPL)))
    dep_ctrl.sync_all()
    seen = [w.snap()]
    rs_ctrl.sync_all()
    return seen + [w.snap()]


def deployment_rolling_update(w):
    dep_ctrl = w.c.DeploymentController(w.store)
    rs_ctrl = w.c.ReplicaSetController(w.store)
    w.store.create("deployments", w.api.Deployment(
        metadata=w.api.ObjectMeta(name="d1"),
        spec=w.api.DeploymentSpec(replicas=2, selector=w.SEL,
                                  template=w.TMPL)))

    def rounds(n):
        for _ in range(n):
            dep_ctrl.sync_all()
            rs_ctrl.sync_all()
            for p in w.store.list("pods"):
                if p.status.phase != "Running":
                    w.mark_running(p)
            rs_ctrl.sync_all()
    rounds(4)
    seen = [w.snap()]
    dep = w.store.get("deployments", "default", "d1")
    dep.spec.template = copy.deepcopy(w.TMPL)
    dep.spec.template.spec.containers[0].image = "v2"
    w.store.update("deployments", dep)
    rounds(10)
    return seen + [w.snap()]


def statefulset_ordered(w):
    ctrl = w.c.StatefulSetController(w.store)
    w.store.create("statefulsets", w.api.StatefulSet(
        metadata=w.api.ObjectMeta(name="web"),
        spec=w.api.StatefulSetSpec(replicas=3, selector=w.SEL,
                                   template=w.TMPL)))
    ctrl.sync_all()
    seen = [w.snap()]
    for name in ("web-0", "web-1"):
        w.mark_running(w.store.get("pods", "default", name))
        ctrl.sync_all()
        seen.append(w.snap())
    return seen


def statefulset_scale_down(w):
    ctrl = w.c.StatefulSetController(w.store)
    w.store.create("statefulsets", w.api.StatefulSet(
        metadata=w.api.ObjectMeta(name="web"),
        spec=w.api.StatefulSetSpec(replicas=2, selector=w.SEL,
                                   template=w.TMPL,
                                   pod_management_policy="Parallel")))
    ctrl.sync_all()
    seen = [w.snap()]
    ss = w.store.get("statefulsets", "default", "web")
    ss.spec.replicas = 1
    w.store.update("statefulsets", ss)
    ctrl.sync_all()
    return seen + [w.snap()]


def statefulset_claims(w):
    api = w.api
    w.store.create("statefulsets", api.StatefulSet(
        metadata=api.ObjectMeta(name="db"),
        spec=api.StatefulSetSpec(
            replicas=2, selector=w.SEL, template=w.TMPL,
            pod_management_policy="Parallel",
            volume_claim_templates=[api.PersistentVolumeClaim(
                metadata=api.ObjectMeta(name="data"),
                spec=api.PersistentVolumeClaimSpec(
                    requests={"storage": 1 << 30}))])))
    ctrl = w.c.StatefulSetController(w.store)
    ctrl.sync_all()
    seen = [w.snap()]
    for replicas in (1, 2):
        ss = w.store.get("statefulsets", "default", "db")
        ss.spec.replicas = replicas
        w.store.update("statefulsets", ss)
        ctrl.sync_all()
        seen.append(w.snap())
    return seen


def daemonset_nodes(w):
    ctrl = w.c.DaemonSetController(w.store)
    w.store.create("nodes", w.mknode("n1"))
    w.store.create("nodes", w.mknode("n2"))
    bad = w.mknode("n3")
    bad.spec.unschedulable = True
    w.store.create("nodes", bad)
    w.store.create("daemonsets", w.api.DaemonSet(
        metadata=w.api.ObjectMeta(name="agent"),
        spec=w.api.DaemonSetSpec(selector=w.SEL, template=w.TMPL)))
    ctrl.sync_all()
    seen = [w.snap()]
    w.store.create("nodes", w.mknode("n4"))
    ctrl.sync_all()
    return seen + [w.snap()]


def _ds_world(w, strategy, max_unavailable=1):
    for n in ("n1", "n2", "n3"):
        w.store.create("nodes", w.mknode(n))
    w.store.create("daemonsets", w.api.DaemonSet(
        metadata=w.api.ObjectMeta(name="agent"),
        spec=w.api.DaemonSetSpec(
            selector=w.SEL, template=copy.deepcopy(w.TMPL),
            update_strategy=w.api.DaemonSetUpdateStrategy(
                type=strategy, max_unavailable=max_unavailable))))
    ctrl = w.c.DaemonSetController(w.store)
    ctrl.sync_all()
    for p in w.store.list("pods"):
        w.mark_running(p)
    ctrl.sync_all()
    ds = w.store.get("daemonsets", "default", "agent")
    ds.spec.template.spec.containers[0].image = "agent:v2"
    w.store.update("daemonsets", ds)
    return ctrl


def daemonset_rolling_update(w):
    ctrl = _ds_world(w, "RollingUpdate")
    ctrl.sync_all()
    seen = [w.snap()]
    for _ in range(4):
        for p in w.store.list("pods"):
            w.mark_running(p)
        ctrl._all_dirty()
        ctrl.sync_all()
        seen.append(w.snap())
    return seen


def daemonset_on_delete(w):
    ctrl = _ds_world(w, "OnDelete")
    ctrl.sync_all()
    seen = [w.snap()]
    w.store.delete("pods", "default", w.names("pods")[0])
    ctrl.sync_all()
    return seen + [w.snap()]


def job_completion(w):
    ctrl = w.c.JobController(w.store)
    w.store.create("jobs", w.api.Job(
        metadata=w.api.ObjectMeta(name="j1"),
        spec=w.api.JobSpec(parallelism=2, completions=3, selector=w.SEL,
                           template=w.TMPL)))
    ctrl.sync_all()
    seen = [w.snap()]
    for _ in range(2):
        for p in w.store.list("pods"):
            if p.status.phase not in ("Succeeded", "Failed"):
                p.status.phase = "Succeeded"
                w.store.update("pods", p)
        ctrl.sync_all()
        seen.append(w.snap())
    return seen


def job_backoff_limit(w):
    ctrl = w.c.JobController(w.store)
    w.store.create("jobs", w.api.Job(
        metadata=w.api.ObjectMeta(name="j1"),
        spec=w.api.JobSpec(parallelism=1, completions=1, backoff_limit=0,
                           template=w.TMPL)))
    ctrl.sync_all()
    p = w.store.list("pods")[0]
    p.status.phase = "Failed"
    w.store.update("pods", p)
    ctrl.sync_all()
    return [w.snap()]


def job_active_deadline(w):
    now = [0.0]
    ctrl = w.c.JobController(w.store, clock=lambda: now[0])
    w.store.create("jobs", w.api.Job(
        metadata=w.api.ObjectMeta(name="slow"),
        spec=w.api.JobSpec(parallelism=2, completions=4,
                           active_deadline_seconds=60, template=w.TMPL)))
    ctrl.sync_all()
    seen = [w.snap()]
    now[0] = 61.0
    ctrl.enqueue(w.store.get("jobs", "default", "slow"))
    ctrl.sync_all()
    seen.append(w.snap())
    ctrl.sync_all()
    return seen + [w.snap()]


_CRON_T = time.mktime((2026, 7, 29, 10, 30, 0, 0, 0, 0))


def cron_matching(w):
    cron = w.m("controllers.cronjob").cron_matches
    t = _CRON_T - time.timezone
    return [cron(s, t) for s in ("* * * * *", "30 10 * * *",
                                 "*/15 * * * *", "31 10 * * *",
                                 "30 10 29 7 *", "* * * * 3", "* * * * 4")]


def cronjob_policy(policy):
    def run(w):
        now = [_CRON_T]
        ctrl = w.c.CronJobController(w.store, clock=lambda: now[0])
        w.store.create("cronjobs", w.api.CronJob(
            metadata=w.api.ObjectMeta(name="cj"),
            spec=w.api.CronJobSpec(schedule="* * * * *",
                                   concurrency_policy=policy,
                                   job_template=w.api.JobSpec(
                                       template=w.TMPL))))
        ticks = [ctrl.tick(), ctrl.tick()]
        now[0] += 60
        ticks.append(ctrl.tick())
        return [ticks, w.snap()]
    return run


def endpoints_ready_split(w):
    api = w.api
    ctrl = w.c.EndpointsController(w.store)
    w.store.create("services", api.Service(
        metadata=api.ObjectMeta(name="svc"),
        spec=api.ServiceSpec(selector={"app": "w"},
                             ports=[api.ServicePort(name="http", port=80,
                                                    target_port=8080)])))
    for name, node, ready in (("p1", "n1", True), ("p2", "n2", False)):
        w.store.create("pods", api.Pod(
            metadata=api.ObjectMeta(name=name, labels={"app": "w"}),
            spec=api.PodSpec(node_name=node)))
        w.mark_running(w.store.get("pods", "default", name), ready=ready)
    ctrl.sync_all()
    return [w.snap()]


def nl_unreachable_eviction(w):
    api, HB = w.api, w.nl.HEARTBEAT_ANNOTATION
    now = [1000.0]
    ctrl = w.nlc(clock=lambda: now[0], grace_period=40.0)

    def keep_alive(name):
        n = w.store.get("nodes", "default", name)
        n.metadata.annotations[HB] = str(now[0])
        w.store.update("nodes", n)

    w.store.create("nodes", w.mknode("n1", hb=now[0]))
    w.store.create("nodes", w.mknode("n2", hb=now[0]))
    w.store.create("pods", api.Pod(
        metadata=api.ObjectMeta(name="p1"),
        spec=api.PodSpec(node_name="n1", tolerations=[api.Toleration(
            key=w.nl.TAINT_UNREACHABLE, operator="Exists",
            effect=api.NO_EXECUTE, toleration_seconds=30)])))
    ctrl.monitor()
    seen = [w.snap()]
    for step in (100, 31):
        now[0] += step
        keep_alive("n2")
        ctrl.monitor()
        seen.append(w.snap())
    return seen


def nl_recovery(w):
    api, HB = w.api, w.nl.HEARTBEAT_ANNOTATION
    now = [1000.0]
    ctrl = w.nlc(clock=lambda: now[0])
    w.store.create("nodes", w.mknode("n1", hb=now[0]))
    now[0] += 100
    ctrl.monitor()
    seen = [w.snap()]
    n = w.store.get("nodes", "default", "n1")
    n.metadata.annotations[HB] = str(now[0])
    n.status.conditions = [api.NodeCondition(api.NODE_READY, api.COND_TRUE)]
    w.store.update("nodes", n)
    ctrl.monitor()
    return seen + [w.snap()]


def nl_not_ready(w):
    now = [1000.0]
    ctrl = w.nlc(clock=lambda: now[0])
    w.store.create("nodes", w.mknode("n1", ready=False, hb=now[0]))
    ctrl.monitor()
    return [w.snap()]


def nl_swap_taints(w):
    api, HB, nl = w.api, w.nl.HEARTBEAT_ANNOTATION, w.nl
    now = [1000.0]
    ctrl = w.nlc(clock=lambda: now[0])
    w.store.create("nodes", w.mknode("n1", ready=False, hb=now[0], taints=[
        api.Taint(key=nl.TAINT_NOT_READY, effect=api.NO_SCHEDULE),
        api.Taint(key="user/custom", effect=api.NO_EXECUTE)]))
    ctrl.monitor()
    seen = [w.snap()]
    n = w.store.get("nodes", "default", "n1")
    n.metadata.annotations[HB] = str(now[0])
    n.status.conditions = [api.NodeCondition(api.NODE_READY, api.COND_TRUE)]
    w.store.update("nodes", n)
    ctrl.monitor()
    return seen + [w.snap()]


def nl_swap_effect_only(w):
    api, nl = w.api, w.nl
    node = w.mknode("n1", taints=[api.Taint(key=nl.TAINT_NOT_READY,
                                            effect=api.NO_SCHEDULE)])
    swap = w.c.NodeLifecycleController._swap_taints
    first = swap(node, add=nl.TAINT_NOT_READY, drop=nl.TAINT_UNREACHABLE)
    taints = sorted((t.key, t.effect) for t in node.spec.taints)
    second = swap(node, add=nl.TAINT_NOT_READY, drop=nl.TAINT_UNREACHABLE)
    return [first, taints, second]


def disruption_pdb(w):
    api = w.api
    ctrl = w.c.DisruptionController(w.store)
    rs = api.ReplicaSet(
        metadata=api.ObjectMeta(name="rs1"),
        spec=api.ReplicaSetSpec(replicas=3, selector=w.SEL, template=w.TMPL))
    w.store.create("replicasets", rs)
    for i in range(3):
        w.store.create("pods", api.Pod(
            metadata=api.ObjectMeta(
                name=f"p{i}", labels={"app": "w"},
                owner_references=[api.OwnerReference(
                    kind="ReplicaSet", name="rs1", uid=rs.metadata.uid,
                    controller=True)]),
            spec=api.PodSpec()))
        w.mark_running(w.store.get("pods", "default", f"p{i}"),
                       ready=(i < 2))
    w.store.create("poddisruptionbudgets", api.PodDisruptionBudget(
        metadata=api.ObjectMeta(name="pdb"),
        spec=api.PodDisruptionBudgetSpec(selector=w.SEL, min_available=1)))
    ctrl.sync_all()
    return [w.snap()]


def namespace_teardown(w):
    api = w.api
    ctrl = w.c.NamespaceController(w.store)
    ns = api.Namespace(metadata=api.ObjectMeta(name="doomed"))
    w.store.create("namespaces", ns)
    w.store.create("pods", api.Pod(metadata=api.ObjectMeta(
        name="p1", namespace="doomed")))
    w.store.create("services", api.Service(metadata=api.ObjectMeta(
        name="s1", namespace="doomed")))
    ns.status.phase = "Terminating"
    w.store.update("namespaces", ns)
    ctrl.sync_all()
    return [w.snap()]


def podgc(w):
    api = w.api
    ctrl = w.c.PodGCController(w.store, terminated_threshold=1)
    w.store.create("nodes", w.mknode("n1"))
    for i, phase in enumerate(["Succeeded", "Failed", "Running"]):
        p = api.Pod(metadata=api.ObjectMeta(name=f"p{i}"),
                    spec=api.PodSpec(node_name="n1"))
        p.status.phase = phase
        w.store.create("pods", p)
    w.store.create("pods", api.Pod(metadata=api.ObjectMeta(name="orphan"),
                                   spec=api.PodSpec(node_name="gone-node")))
    return [ctrl.gc(), w.snap()]


def ownerref_gc(w):
    api = w.api
    gc = w.c.GarbageCollector(w.store)
    rs = api.ReplicaSet(metadata=api.ObjectMeta(name="rs1"),
                        spec=api.ReplicaSetSpec(selector=w.SEL))
    w.store.create("replicasets", rs)
    w.store.create("pods", api.Pod(metadata=api.ObjectMeta(
        name="p1", owner_references=[api.OwnerReference(
            kind="ReplicaSet", name="rs1", uid=rs.metadata.uid,
            controller=True)])))
    first = gc.sweep()
    w.store.delete("replicasets", "default", "rs1")
    return [first, gc.sweep(), w.snap()]


def pv_binding(w):
    api, qty = w.api, w.m("api.resources").value
    ctrl = w.c.PersistentVolumeController(w.store)
    for name, size in (("pv-big", "100Gi"), ("pv-small", "10Gi")):
        w.store.create("persistentvolumes", api.PersistentVolume(
            metadata=api.ObjectMeta(name=name),
            spec=api.PersistentVolumeSpec(capacity={"storage": qty(size)})))
    w.store.create("persistentvolumeclaims", api.PersistentVolumeClaim(
        metadata=api.ObjectMeta(name="claim"),
        spec=api.PersistentVolumeClaimSpec(requests={"storage": qty("5Gi")})))
    ctrl.sync_all()
    return [w.snap()]


def manager_cascade(w):
    api = w.api
    mgr = w.manager()
    for n in ("n0", "n1"):
        w.store.create("nodes", w.mknode(n))
    w.store.create("services", api.Service(
        metadata=api.ObjectMeta(name="svc"),
        spec=api.ServiceSpec(selector={"app": "w"},
                             ports=[api.ServicePort(port=80)])))
    w.store.create("deployments", api.Deployment(
        metadata=api.ObjectMeta(name="d1"),
        spec=api.DeploymentSpec(replicas=2, selector=w.SEL, template=w.TMPL)))
    mgr.sync_all()
    for i, p in enumerate(w.store.list("pods")):
        if p.status.phase != "Running":
            w.store.bind(p, f"n{i}")
            w.mark_running(w.store.get("pods", p.metadata.namespace,
                                       p.metadata.name))
    mgr.sync_all()
    seen = [w.snap()]
    w.store.delete("deployments", "default", "d1")
    mgr.sync_all(rounds=4)
    return seen + [w.snap()]


# -- tests/test_bootstrap.py, tests/test_auth.py, tests/test_cloud.py ---------


def ttl_scaling(w):
    ttl = w.m("controllers.ttl")
    sizes = [ttl.ttl_for_size(n) for n in (10, 400, 900, 4000, 9000)]
    ctrl = ttl.TTLController(w.store)
    for i in range(3):
        w.store.create("nodes", w.mknode(f"n{i}"))
    ctrl.sync_all()
    return [sizes, w.snap()]


def default_serviceaccount(w):
    ctrl = w.c.ServiceAccountController(w.store)
    w.store.create("namespaces", w.api.Namespace(
        metadata=w.api.ObjectMeta(name="team-a")))
    ctrl.sync_all()
    return [w.snap()]


def serviceaccount_tokens(w):
    """The controller mints a token per SA that the port's copy of
    server/serviceaccount.py verifies; a recreated SA gets a fresh one
    and the old one stops verifying (tests/test_auth.py)."""
    sat, pki = w.m("server.serviceaccount"), w.m("server.pki")
    ctrl = w.c.ServiceAccountController(w.store)
    w.store.create("serviceaccounts", w.api.ServiceAccount(
        metadata=w.api.ObjectMeta(name="app")))
    ctrl.sync_all()
    old = w.store.get("secrets", "default", "app-token").data["token"]
    key = pki.ensure_cluster_ca(w.store).sa_signing_key
    seen = [sat.verify(key, old, w.store)]
    w.store.delete("serviceaccounts", "default", "app")
    w.store.create("serviceaccounts", w.api.ServiceAccount(
        metadata=w.api.ObjectMeta(name="app")))
    ctrl.sync_all()
    new = w.store.get("secrets", "default", "app-token").data["token"]
    return seen + [new != old, sat.verify(key, new, w.store),
                   sat.verify(key, old, w.store), w.snap()]


def certificates(w):
    cert = w.m("controllers.certificates")
    approver = cert.CSRApprovingController(w.store)
    signer = cert.CSRSigningController(w.store)
    for name, user, groups in (("node-csr-n1", "system:node:n1",
                                ["system:nodes"]),
                               ("user-csr", "alice", [])):
        w.store.create("certificatesigningrequests",
                       w.api.CertificateSigningRequest(
                           metadata=w.api.ObjectMeta(name=name),
                           spec=w.api.CertificateSigningRequestSpec(
                               request="csr-bytes", username=user,
                               groups=groups,
                               usages=["digital signature",
                                       "key encipherment", "client auth"])))
    approver.sync_all()
    signer.sync_all()
    return [w.snap()]


def roster(w):
    """The manager's roster: DEFAULT_CONTROLLERS, default_controllers()
    and a ControllerManager's controllers by name and class."""
    mgr_mod = w.m("controllers.manager")
    mgr = w.manager()
    return [[c.__name__ for c in mgr_mod.DEFAULT_CONTROLLERS],
            [c.__name__ for c in mgr_mod.default_controllers()],
            [(k, type(c).__name__) for k, c in mgr.controllers.items()]]


def cloud_roster(w):
    """tests/test_cloud.py:239: the cloud- and CIDR-gated controllers join
    the roster and drive node -> CIDR -> route -> load balancer."""
    cloud = w.m("cloud.provider").FakeCloud()
    mgr = w.manager(cloud=cloud, cluster_cidr="10.244.0.0/16")
    names = sorted(mgr.controllers)
    cloud.add_instance("n1")
    w.store.create("nodes", w.mknode("n1"))
    w.store.create("services", w.api.Service(
        metadata=w.api.ObjectMeta(name="web"),
        spec=w.api.ServiceSpec(type="LoadBalancer",
                               ports=[w.api.ServicePort(port=80)])))
    mgr.sync_all(rounds=2)
    return [names, sorted(cloud.route_table), w.snap()]


def endpoint_reconciler(w):
    """tests/test_bootstrap.py:142: two API server replicas publish the
    kubernetes Endpoints; a replica that stops refreshing is pruned."""
    rec = w.m("server.reconciler")
    now = [1000.0]
    a, b = (rec.EndpointReconciler(w.store, f"10.0.0.{i}:6443", 6443,
                                   ttl=15, clock=lambda: now[0])
            for i in (1, 2))
    a.reconcile()
    b.reconcile()
    seen = [w.snap()]
    now[0] += 20
    b.reconcile()
    return seen + [w.snap()]


def apiserver_publishes_endpoints(w):
    """APIServer(reconcile_endpoints=True).start() reaches
    server/reconciler.py: its address is published, and removed by a
    clean stop."""
    srv_mod = w.m("server.apiserver")
    srv = srv_mod.APIServer(w.store,
                            admission=w.m("server.admission").AdmissionChain(),
                            reconcile_endpoints=True).start()
    try:
        ep = w.store.get("endpoints", "default", "kubernetes")
        up = [len(s.addresses) for s in ep.subsets]
    finally:
        srv.stop()
    ep = w.store.get("endpoints", "default", "kubernetes")
    return [up, [len(s.addresses) for s in ep.subsets]]


def sa_jwt_authenticates(w):
    """A service-account JWT (three parts) through the authenticator chain
    with a CA reaches server/serviceaccount.py."""
    pki, sat = w.m("server.pki"), w.m("server.serviceaccount")
    auth = w.m("server.auth")
    ca = pki.ensure_cluster_ca(w.store)
    chain = auth.AuthenticatorChain(store=w.store, ca=ca)
    sa = w.api.ServiceAccount(metadata=w.api.ObjectMeta(name="app"))
    w.store.create("serviceaccounts", sa)
    w.store.create("secrets", w.api.Secret(
        metadata=w.api.ObjectMeta(name="app-token")))
    tok = sat.mint(ca.sa_signing_key, "default", "app", sa.metadata.uid,
                   "app-token")
    user = chain.authenticate(f"Bearer {tok}")
    seen = [user.name, sorted(user.groups),
            sat.verify("other-key", tok, w.store)]
    w.store.delete("secrets", "default", "app-token")
    return seen + [chain.authenticate(f"Bearer {tok}"),
                   sat.verify(ca.sa_signing_key, tok, w.store)]


def bootstrap_token_authenticates(w):
    """An id.secret bearer token through the authenticator chain reaches
    controllers/bootstrap.py lookup_token: it resolves to its bootstrap
    identity, an expired one does not, and deleting the Secret revokes
    it (tests/test_bootstrap_tokens.py:22-53)."""
    bt, pki = w.bt, w.m("server.pki")
    auth = w.m("server.auth")
    chain = auth.AuthenticatorChain(store=w.store, ca=pki.ensure_cluster_ca(
        w.store))
    tid, tsec, wire = bt.new_bootstrap_token()
    w.store.create("secrets", bt.make_token_secret(tid, tsec,
                                                   ttl_seconds=3600))
    user = chain.authenticate(f"Bearer {wire}")
    seen = [user.name == f"system:bootstrap:{tid}", sorted(user.groups),
            bt.lookup_token(w.store, wire) is not None,
            bt.lookup_token(w.store, f"{tid}.WRONG"),
            bt.lookup_token(w.store, "garbage")]
    tid2, tsec2, wire2 = bt.new_bootstrap_token()
    sec2 = bt.make_token_secret(tid2, tsec2)
    sec2.data["expiration"] = str(time.time() - 1)
    w.store.create("secrets", sec2)
    seen += [bt.lookup_token(w.store, wire2),
             chain.authenticate(f"Bearer {wire2}")]
    w.store.delete("secrets", bt.TOKEN_NAMESPACE,
                   bt.TOKEN_SECRET_PREFIX + tid)
    return seen + [chain.authenticate(f"Bearer {wire}")]


def token_cleaner(w):
    bt = w.bt
    now = [1000.0]
    cleaner = bt.TokenCleanerController(w.store, clock=lambda: now[0])
    tid, tsec, _ = bt.new_bootstrap_token()
    sec = bt.make_token_secret(tid, tsec)
    sec.data["expiration"] = str(1500.0)
    w.store.create("secrets", sec)
    seen = []
    for t in (1000.0, 2000.0):
        now[0] = t
        cleaner.resync()
        cleaner.sync_all()
        seen.append(len(w.store.list("secrets", bt.TOKEN_NAMESPACE)))
    return seen


def bootstrap_signer(w):
    bt = w.bt
    w.store.create("configmaps", w.api.ConfigMap(
        metadata=w.api.ObjectMeta(name="cluster-info",
                                  namespace="kube-public"),
        data={"ca.crt": "PEM-BYTES"}))
    tid, tsec, wire = bt.new_bootstrap_token()
    w.store.create("secrets", bt.make_token_secret(tid, tsec))
    signer = bt.BootstrapSignerController(w.store)
    signer.resync()
    signer.sync_all()
    info = w.store.get("configmaps", "kube-public", "cluster-info")
    _, _, other = bt.new_bootstrap_token()
    seen = [bt.verify_cluster_info(info, wire),
            bt.verify_cluster_info(info, other), sorted(info.data) == sorted(
                ["ca.crt", f"jws-kubeconfig-{tid}"])]
    w.store.delete("secrets", bt.TOKEN_NAMESPACE,
                   bt.TOKEN_SECRET_PREFIX + tid)
    signer.resync()
    signer.sync_all()
    info = w.store.get("configmaps", "kube-public", "cluster-info")
    return seen + [bt.verify_cluster_info(info, wire), sorted(info.data)]


def role_aggregation(w):
    api = w.api
    agg = w.m("controllers.clusterroleaggregation")
    ctrl = agg.ClusterRoleAggregationController(w.store)
    w.store.create("clusterroles", api.ClusterRole(
        metadata=api.ObjectMeta(name="admin"),
        aggregation_selectors=[w.lbl.LabelSelector(match_labels={
            "rbac.example.com/aggregate-to-admin": "true"})]))
    w.store.create("clusterroles", api.ClusterRole(
        metadata=api.ObjectMeta(
            name="crd-frag",
            labels={"rbac.example.com/aggregate-to-admin": "true"}),
        rules=[api.RBACPolicyRule(verbs=["get"], api_groups=[""],
                                  resources=["widgets"])]))
    ctrl.sync_all()
    seen = [w.snap()]
    w.store.delete("clusterroles", "", "crd-frag")
    ctrl.sync_all()
    return seen + [w.snap()]


SCENARIOS = {
    "replicaset_scale_up_down_and_status": rs_scale,
    "replicaset_prefers_not_ready_victims": rs_victims,
    "deployment_rollout_creates_rs_and_scales": deployment_rollout,
    "deployment_rolling_update_replaces_rs": deployment_rolling_update,
    "statefulset_ordered_creation": statefulset_ordered,
    "statefulset_scale_down_from_top": statefulset_scale_down,
    "statefulset_claims_minted_and_retained": statefulset_claims,
    "daemonset_one_pod_per_eligible_node": daemonset_nodes,
    "daemonset_rolling_update_max_unavailable": daemonset_rolling_update,
    "daemonset_on_delete_waits": daemonset_on_delete,
    "job_run_to_completion": job_completion,
    "job_backoff_limit": job_backoff_limit,
    "job_active_deadline": job_active_deadline,
    "cronjob_matching": cron_matching,
    "cronjob_spawns_once_per_minute": cronjob_policy("Allow"),
    "cronjob_forbid_concurrency": cronjob_policy("Forbid"),
    "endpoints_ready_split_and_ports": endpoints_ready_split,
    "nodelifecycle_unreachable_taint_and_eviction": nl_unreachable_eviction,
    "nodelifecycle_recovery_removes_taint": nl_recovery,
    "nodelifecycle_not_ready_taint": nl_not_ready,
    "nodelifecycle_swap_taints_preserves_other_effects": nl_swap_taints,
    "nodelifecycle_swap_taints_effect_only_change": nl_swap_effect_only,
    "disruption_pdb_status": disruption_pdb,
    "namespace_teardown": namespace_teardown,
    "default_serviceaccount": default_serviceaccount,
    "podgc_orphans_and_terminated": podgc,
    "ownerref_gc": ownerref_gc,
    "pv_binds_smallest_sufficient": pv_binding,
    "manager_deployment_to_endpoints_cascade": manager_cascade,
    "ttl_scales_with_cluster_size": ttl_scaling,
    "serviceaccount_tokens_verify_and_rotate": serviceaccount_tokens,
    "certificates_node_csr_signed_user_csr_not": certificates,
    "roster": roster,
    "cloud_controllers_join_the_roster": cloud_roster,
    "endpoint_reconciler_two_replicas": endpoint_reconciler,
    "apiserver_reconcile_endpoints": apiserver_publishes_endpoints,
    "sa_jwt_authenticates": sa_jwt_authenticates,
    "bootstrap_token_authenticates": bootstrap_token_authenticates,
    "token_cleaner_removes_expired": token_cleaner,
    "bootstrap_signer_tracks_tokens": bootstrap_signer,
    "clusterrole_aggregation": role_aggregation,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_as_in_jax(name, monkeypatch):
    got = both(SCENARIOS[name], monkeypatch)
    assert got  # every scenario observes something


def test_the_roster_is_the_jax_roster(monkeypatch):
    """ControllerManager(store, device="cpu") builds every controller JAX's
    default_controllers() builds, under the same names, the node-lifecycle
    controller on the CPU."""
    names, defaults, built = both(roster, monkeypatch)
    assert names == defaults[:-1] and defaults[-1] == \
        "APIServiceAvailabilityController"
    assert len(built) == len(defaults)
    from kubernetes_tpu_torch.controllers import manager
    from kubernetes_tpu_torch.runtime.store import ObjectStore

    mgr = manager.ControllerManager(ObjectStore(), device="cpu")
    assert str(mgr["nodelifecycle"].device) == "cpu"


def test_the_package_exports_what_jax_exports():
    jax_ctl = mod("kubernetes_tpu", "controllers")
    port_ctl = mod("kubernetes_tpu_torch", "controllers")
    public = {n for n in vars(jax_ctl) if not n.startswith("_")}
    assert public - set(vars(port_ctl)) == set()


def test_the_manager_without_a_card_raises(monkeypatch):
    import torch

    from kubernetes_tpu_torch.controllers import ControllerManager
    from kubernetes_tpu_torch.runtime.store import ObjectStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ControllerManager(ObjectStore())
