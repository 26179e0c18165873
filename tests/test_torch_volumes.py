"""The profile and host-plugin layer of kubernetes_tpu_torch's Scheduler
against the JAX Scheduler: NoDiskConflict and the volume predicates
(MaxPDVolumeCount, NoVolumeZoneConflict, CheckVolumeBinding), a Policy
file's predicates and priorities with their arguments, host scores, the
equivalence cache and the VolumeBinder. Every scenario runs through both
packages in lockstep (torch_parity.Both: bindings, claim bindings,
nominations, PodScheduled messages, queue counts, equivalence-cache hits
and misses and the scheduler metrics after every step, on a virtual
clock). The scenarios are those of tests/test_plugins.py,
tests/test_volume_flow.py and tests/test_equivalence.py, most with the
equivalence cache off and on, plus seeded random volume worlds and the
Policy profiles' weights against the JAX Scheduler's dispatch view.
"""

import importlib

import numpy as np
import pytest

from kubernetes_tpu.plugins.registry import Registry as JaxRegistry
from kubernetes_tpu.plugins.registry import default_profile as jax_default
from kubernetes_tpu.runtime.store import ObjectStore as JaxStore
from kubernetes_tpu.sched.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu_torch.ops.scores import stack_weights
from kubernetes_tpu_torch.plugins.registry import Registry, default_profile
from kubernetes_tpu_torch.runtime.store import ObjectStore
from kubernetes_tpu_torch.sched.errors import REASONS
from kubernetes_tpu_torch.sched.scheduler import Scheduler
from kubernetes_tpu_torch.utils.feature_gates import FeatureGates

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both, claims
from torch_worlds import (GCE_PD, EBS, bindings, plain_node,
                          plain_pod, volume_pod, volume_pv, volume_pvc)

TORCH = "kubernetes_tpu_torch"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def gates(**on):
    """features(pkg) for Both: the default gates with `on` set."""
    return lambda pkg: _mod(pkg, "utils.feature_gates").FeatureGates(
        dict(on))


ECACHE = {"off": None, "on": gates(EnableEquivalenceClassCache=True)}
VOLUME_SCHEDULING = {
    "off": gates(VolumeScheduling=True),
    "on": gates(VolumeScheduling=True, EnableEquivalenceClassCache=True)}


def _zoned(n, zones=3, cpu="4", **kw):
    """Both with n nodes n{i} in zones z{i % zones}."""
    b = Both(**kw)
    for i in range(n):
        b.node(f"n{i}", cpu=cpu, zone=f"z{i % zones}")
    return b


def pv(b, name, **kw):
    b.create("persistentvolumes", lambda pkg: volume_pv(pkg, name, **kw))


def pvc(b, name, **kw):
    b.create("persistentvolumeclaims",
             lambda pkg: volume_pvc(pkg, name, **kw))


def vpod(b, name, **kw):
    b.create("pods", lambda pkg: volume_pod(pkg, name, **kw))


def message(b, name):
    """The PodScheduled message of a pod in the port's store (Both.check
    holds it equal to the JAX store's)."""
    pod = b.stores["torch"].get("pods", "default", name)
    return dict(pod.status.conditions).get("PodScheduled", "")


# --- the volume predicates (tests/test_plugins.py) -------------------------


@pytest.mark.parametrize("ecache", ECACHE)
def test_max_pd_volume_count(ecache):
    """16 GCE PDs attached to n0 through bound claims: a pod with a 17th
    goes elsewhere, a pod with one already attached may stay, and a pod
    with a claim that does not exist fits nowhere (MaxVolumeCount, the
    first relevant filter of the default profile, reports it)."""
    b = _zoned(2, zones=1, features=ECACHE[ecache])
    for i in range(17):
        pv(b, f"pv-{i}", kind=GCE_PD, vid=f"pd-{i}")
        pvc(b, f"c-{i}", volume_name=f"pv-{i}")
    for i in range(16):
        vpod(b, f"bound-{i}", claims=[f"c-{i}"], node_name="n0")
    vpod(b, "over", claims=["c-16"], cpu="100m")
    vpod(b, "again", claims=["c-3"], cpu="100m")
    vpod(b, "missing", claims=["nope"], cpu="100m")
    b.run()
    got = bindings(b.stores["torch"])
    assert got["over"] == "n1" and got["again"] and not got["missing"]
    assert REASONS["MaxVolumeCount"] in message(b, "missing")


@pytest.mark.parametrize("ecache", ECACHE)
def test_volume_zone(ecache):
    """A claim's PV zone label pins its pod: a zone, a '__'-joined zone
    set, and a zone no node is in; a node without a zone label never
    admits a zoned PV."""
    b = _zoned(3, features=ECACHE[ecache])
    b.node("bare", cpu="8")
    for name, zone in (("pv-z", "z1"), ("pv-set", "z0__z2"),
                       ("pv-far", "z9")):
        pv(b, name, kind=GCE_PD, vid=f"pd-{name}", zone=zone)
        pvc(b, f"c-{name}", volume_name=name)
    vpod(b, "p-z", claims=["c-pv-z"], cpu="100m")
    vpod(b, "p-set", claims=["c-pv-set"], cpu="100m")
    vpod(b, "p-far", claims=["c-pv-far"], cpu="100m")
    b.run()
    got = bindings(b.stores["torch"])
    assert got["p-z"] == "n1" and got["p-set"] in ("n0", "n2")
    assert not got["p-far"]


def test_host_filter_reasons_reach_the_fit_error():
    """The FitError of a pod that only the host stack rejects names the
    host filter that did (`_wave_host_fails`): 3 zoned nodes fail
    NoVolumeZoneConflict, the unlabeled one too, and nothing mentions
    NoDiskConflict, which the port once reported for every host-stack
    failure. Held equal to the JAX message by Both.check."""
    b = _zoned(3)
    b.node("bare", cpu="8")
    pv(b, "pv-far", kind=GCE_PD, vid="pd-far", zone="z9")
    pvc(b, "c-far", volume_name="pv-far")
    vpod(b, "p-far", claims=["c-far"], cpu="100m")
    b.run()
    msg = message(b, "p-far")
    assert msg == ("False:0/4 nodes are available: 4 "
                   f"{REASONS['NoVolumeZoneConflict']}.")
    assert REASONS["NoDiskConflict"] not in msg


@pytest.mark.parametrize("ecache", VOLUME_SCHEDULING)
def test_volume_binding(ecache):
    """A bound claim's PV node affinity admits only its zone; an unbound
    WaitForFirstConsumer claim needs a free PV of its class that admits
    the node, and the VolumeBinder binds it at commit; an unbound claim
    whose class has no PV fits nowhere (VolumeBindingNoMatch)."""
    b = _zoned(2, zones=2, features=VOLUME_SCHEDULING[ecache])
    pv(b, "pv-a", affinity="z0")
    pvc(b, "c-a", volume_name="pv-a")
    pv(b, "pv-free", affinity="z1", cls="fast")
    pvc(b, "c-u", cls="fast", wffc=True)
    pvc(b, "c-none", cls="none")
    vpod(b, "p-a", claims=["c-a"], cpu="100m")
    vpod(b, "p-u", claims=["c-u"], cpu="100m")
    vpod(b, "p-none", claims=["c-none"], cpu="100m")
    b.run()
    got = bindings(b.stores["torch"])
    assert got["p-a"] == "n0" and got["p-u"] == "n1" and not got["p-none"]
    assert claims(b.stores["torch"])["c-u"] == "pv-free"
    assert REASONS["VolumeBindingNoMatch"] in message(b, "p-none")


def test_stale_in_wave_pv_match_requeues():
    """The host mask is computed once at wave start, so two pods of one
    wave both see the zone's last free PV: the first commit binds it, the
    second's bind_pod_volumes finds none and the pod goes back to the
    queue, then fails on the next pass with VolumeBindingNoMatch — in
    both packages."""
    b = _zoned(2, zones=1, features=gates(VolumeScheduling=True))
    pv(b, "pv-last", affinity="z0", cls="zonal", gi=10)
    for i in range(2):
        pvc(b, f"c-{i}", cls="zonal", wffc=True, gi=5)
        vpod(b, f"p-{i}", claims=[f"c-{i}"], cpu="100m")
    assert b.run() == 1
    bound = claims(b.stores["torch"])
    assert sorted(bound.values()) == ["", "pv-last"]
    loser = next(f"p-{i}" for i in range(2) if not bound[f"c-{i}"])
    assert REASONS["VolumeBindingNoMatch"] in message(b, loser)


# --- Policy files and host scores (tests/test_plugins.py) -------------------

POLICY_ARGUMENTS = """
{"predicates": [
    {"name": "PodFitsResources"},
    {"name": "TestLabelPresence",
     "argument": {"labelsPresence": {"labels": ["gpu"], "presence": true}}},
    {"name": "TestServiceAffinity",
     "argument": {"serviceAffinity": {"labels": ["rack"]}}},
    {"name": "MaxEBSVolumeCount"}
 ],
 "priorities": [
    {"name": "LeastRequestedPriority", "weight": 2},
    {"name": "ResourceLimitsPriority", "weight": 1},
    {"name": "TestLabelPreference",
     "argument": {"labelPreference": {"label": "ssd", "presence": true}},
     "weight": 3},
    {"name": "TestServiceAntiAffinity",
     "argument": {"serviceAntiAffinity": {"label": "rack"}}, "weight": 1}
 ]}"""
# the shape of chip_smoke phase 5's policy world
POLICY_ZEROED = """
{"predicates": [
    {"name": "PodFitsResources"},
    {"name": "NoDiskConflict"},
    {"name": "GPUNodes",
     "argument": {"labelsPresence": {"labels": ["gpu"], "presence": true}}}
 ],
 "priorities": [
    {"name": "LeastRequestedPriority", "weight": 0},
    {"name": "BalancedResourceAllocation", "weight": 1},
    {"name": "ResourceLimitsPriority", "weight": 2},
    {"name": "SSDNodes",
     "argument": {"labelPreference": {"label": "ssd", "presence": true}},
     "weight": 5}
 ]}"""
POLICY_DEVICE = """
{"priorities": [
    {"name": "MostRequestedPriority", "weight": 3},
    {"name": "ImageLocalityPriority", "weight": 2},
    {"name": "InterPodAffinityPriority", "weight": 5},
    {"name": "SelectorSpreadPriority", "weight": 1}
 ]}"""
POLICIES = {"arguments": POLICY_ARGUMENTS, "zeroed": POLICY_ZEROED,
            "device": POLICY_DEVICE}


def policy(text):
    """profile(pkg, store) for Both: the Policy read by each package's
    own Registry."""
    return lambda pkg, store: _mod(pkg, "plugins.registry").Registry(
    ).profile_from_policy(text, store=store)


def _labelled_node(pkg, i):
    node = plain_node(pkg, f"n{i}", cpu="4", zone=f"z{i % 3}")
    node.metadata.labels.update({"rack": f"r{i % 2}"})
    if i % 3:
        node.metadata.labels["gpu"] = "yes"
    if i % 4 == 1:
        node.metadata.labels["ssd"] = "1"
    return node


def _limited_pod(pkg, name, j):
    api = _mod(pkg, "api.types")
    pod = plain_pod(pkg, name, cpu=f"{100 * (1 + j % 4)}m", memory="256Mi",
                    labels={"app": "a"} if j % 2 else {"app": "b"})
    if j % 3:
        pod.spec.containers[0].resources.limits = api.resource_list(
            cpu=str(1 + j % 3), memory="1Gi")
    return pod


@pytest.mark.parametrize("name", POLICIES)
def test_policy_drains_as_jax(name):
    """A Policy profile on 8 labelled nodes with a service: its host
    filters (labelsPresence, serviceAffinity, MaxEBSVolumeCount,
    NoDiskConflict), its host scores (labelPreference,
    serviceAntiAffinity, ResourceLimitsPriority) through extra_scores on
    the per-wave path, and its device weights; two drains."""
    b = Both(profile=policy(POLICIES[name]))
    for i in range(8):
        b.create("nodes", lambda pkg, i=i: _labelled_node(pkg, i))
    b.create("services", lambda pkg: _mod(pkg, "api.types").Service(
        metadata=_mod(pkg, "api.types").ObjectMeta(name="svc"),
        selector={"app": "a"}))
    for j in range(20):
        b.create("pods", lambda pkg, j=j: _limited_pod(pkg, f"p{j}", j))
    assert b.run() > 0
    b.advance(61)
    for j in range(20, 30):
        b.create("pods", lambda pkg, j=j: _limited_pod(pkg, f"p{j}", j))
    b.run()


@pytest.mark.parametrize("name", POLICIES)
def test_policy_weights_equal_jax(name):
    """The port's weight view for a Policy profile equals the JAX
    Scheduler's (`_weights_kw()`: the gating Weights, their stacked f32
    vector and the version), with no weightprofiles object."""
    jstore, tstore = JaxStore(), ObjectStore()
    jsched = JaxScheduler(jstore, profile=JaxRegistry().profile_from_policy(
        POLICIES[name], store=jstore))
    tsched = Scheduler(tstore, device="cpu",
                       profile=Registry().profile_from_policy(
                           POLICIES[name], store=tstore))
    gating, vec, version = jsched._weights_kw()
    t_gating, got, t_version = tsched._weights_kw()
    assert tuple(t_gating) == tuple(gating)
    assert t_version == version == "static"
    assert got.dtype == np.asarray(vec).dtype
    np.testing.assert_array_equal(got, np.asarray(vec))
    np.testing.assert_array_equal(stack_weights(t_gating), got)
    assert list(tsched.profile.host_filters) == list(
        jsched.profile.host_filters)
    assert list(tsched.profile.host_scores) == list(
        jsched.profile.host_scores)


def test_default_profile_matches_jax():
    """The default profile's host filters, in order (the first failure
    is the reason that counts), and its weights."""
    got, want = default_profile(ObjectStore()), jax_default(JaxStore())
    assert list(got.host_filters) == list(want.host_filters) == [
        "NoDiskConflict", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
        "MaxAzureDiskVolumeCount", "NoVolumeZoneConflict",
        "CheckVolumeBinding"]
    assert tuple(got.weights()) == tuple(want.weights())
    assert got.scheduler_name == want.scheduler_name


def test_host_score_steers_placement():
    """A host score with a large weight beats the device priorities'
    preference, through the kernel's extra_scores input."""

    def profile(pkg, store):
        prof = _mod(pkg, "plugins.registry").default_profile(store)
        prof.host_scores["NodeLabelPriority"] = (
            lambda pod, infos: {n: (10 if n == "n3" else 0) for n in infos},
            100)
        return prof

    b = Both(profile=profile)
    for i in range(1, 5):
        b.node(f"n{i}", cpu="8", memory="16Gi")
    b.pod("p1", cpu="100m")
    assert b.run() == 1
    assert bindings(b.stores["torch"])["p1"] == "n3"


def test_scheduler_name_selects_the_pods():
    """A profile's scheduler name: pods naming another scheduler stay
    out of its queue."""

    def profile(pkg, store):
        prof = _mod(pkg, "plugins.registry").default_profile(store)
        prof.scheduler_name = "batch-scheduler"
        return prof

    b = Both(profile=profile)
    b.node("n0")

    def named(pkg, name, scheduler):
        pod = plain_pod(pkg, name, cpu="100m")
        pod.spec.scheduler_name = scheduler
        return pod

    b.create("pods", lambda pkg: named(pkg, "mine", "batch-scheduler"))
    b.create("pods", lambda pkg: named(pkg, "other", "default-scheduler"))
    assert b.run() == 1
    assert bindings(b.stores["torch"]) == {"mine": "n0", "other": ""}


# --- host plugins and preemption (tests/test_plugins.py) ----------------------


@pytest.mark.parametrize("ecache", ECACHE)
def test_no_preemption_on_zone_conflicted_node(ecache):
    """A high-priority pod whose PV pins it to a zone no node is in
    evicts nobody: NoVolumeZoneConflict is unresolvable."""
    b = Both(features=ECACHE[ecache])
    b.node("n1", cpu="1", zone="z1")
    pv(b, "pv-z9", zone="z9")
    pvc(b, "c-z9", volume_name="pv-z9")
    b.pod("victim", cpu="900m", priority=0, node_name="n1")
    vpod(b, "hi", claims=["c-z9"], cpu="800m", priority=1000)
    assert b.run() == 0
    assert b.stores["torch"].get("pods", "default", "victim") is not None
    assert not b.stores["torch"].get(
        "pods", "default", "hi").status.nominated_node_name


@pytest.mark.parametrize("ecache", ECACHE)
def test_preemption_resolves_disk_conflict(ecache):
    """NoDiskConflict is resolvable: the holder of the disk is evicted,
    the high-priority pod nominated and then bound."""
    b = Both(features=ECACHE[ecache])
    b.node("n1")
    disk = [(GCE_PD, "disk-x", False)]
    vpod(b, "holder", disks=disk, cpu="100m", priority=0, node_name="n1")
    vpod(b, "hi", disks=disk, cpu="100m", priority=1000)
    b.run()
    assert b.stores["torch"].get("pods", "default", "holder") is None
    b.advance(61)
    b.run()
    assert bindings(b.stores["torch"])["hi"] == "n1"


@pytest.mark.parametrize("ecache", ECACHE)
def test_ebs_claims_count_per_node(ecache):
    """EBS volumes through bound claims count against the EBS limit of
    39 a node; a pod with three more places only where they fit."""
    b = _zoned(2, zones=1, features=ECACHE[ecache])
    for i in range(42):
        pv(b, f"ebs-{i}", kind=EBS, vid=f"vol-{i}")
        pvc(b, f"e-{i}", volume_name=f"ebs-{i}")
    for i in range(13):
        vpod(b, f"bound-{i}", claims=[f"e-{3 * i + k}" for k in range(3)],
             node_name="n0")
    vpod(b, "more", claims=["e-39", "e-40", "e-41"], cpu="100m")
    b.run()
    assert bindings(b.stores["torch"])["more"] == "n1"


# --- the VolumeBinder at commit (tests/test_volume_flow.py) --------------------


def _flow(ecache):
    b = Both(features=VOLUME_SCHEDULING[ecache])
    b.node("n-a", zone="z1")
    b.node("n-b", zone="z2")
    return b


@pytest.mark.parametrize("ecache", VOLUME_SCHEDULING)
def test_commit_binds_unbound_claims(ecache):
    b = _flow(ecache)
    pv(b, "pv-z1", affinity="z1")
    pv(b, "pv-z2", affinity="z2")
    pvc(b, "data", wffc=True)
    vpod(b, "p", claims=["data"], cpu="100m")
    assert b.run() == 1
    node = bindings(b.stores["torch"])["p"]
    assert claims(b.stores["torch"])["data"] == {
        "n-a": "pv-z1", "n-b": "pv-z2"}[node]


@pytest.mark.parametrize("ecache", VOLUME_SCHEDULING)
def test_no_feasible_pv_binds_nothing(ecache):
    b = _flow(ecache)
    pv(b, "pv-z1", affinity="z1")
    pvc(b, "a", wffc=True)
    pvc(b, "b", wffc=True)  # no second PV
    vpod(b, "p", claims=["a", "b"], cpu="100m")
    assert b.run() == 0
    assert claims(b.stores["torch"]) == {"a": "", "b": ""}


@pytest.mark.parametrize("ecache", VOLUME_SCHEDULING)
def test_bind_failure_rolls_back_claims(ecache):
    """The store refuses the bind while the pod stays unbound: the claim
    binding made at commit is rolled back and the pod parks with backoff
    (the JAX reconciler's ORPHANED outcome); once binds work again and
    the backoff passes, the claim binds and the pod lands."""
    b = _flow(ecache)
    pv(b, "pv-z1", affinity="z1")
    pv(b, "pv-z2", affinity="z2")
    pvc(b, "data", wffc=True)
    saved = {}
    for side, store in b.stores.items():
        conflict = _mod(b.pkg(side), "runtime.store").Conflict
        saved[side] = store.bind

        def refuse(pod, node_name, conflict=conflict):
            raise conflict("the bind is refused")

        store.bind = refuse
    vpod(b, "p", claims=["data"], cpu="100m")
    assert b.run() == 0
    assert claims(b.stores["torch"]) == {"data": ""}
    assert len(b.sched["torch"].unschedulable_pods()) == 1
    for side, store in b.stores.items():
        store.bind = saved[side]
    b.advance(61)
    b.node("n-c", zone="z3")  # a cluster event moves the parked pod
    assert b.run() == 1
    assert claims(b.stores["torch"])["data"]


# --- the equivalence cache (tests/test_equivalence.py) --------------------------


def _owned(pkg, name, disk):
    return volume_pod(pkg, name, disks=[disk], owner="rs1", cpu="100m",
                      memory="64Mi", labels={"app": "w"})


def test_siblings_hit_the_cache():
    """Pods of one controller with the same volumes share a class: the
    second sibling's host filters are cache hits, in both packages."""
    b = Both(features=ECACHE["on"])
    for i in range(4):
        b.node(f"n{i}", cpu="8", memory="16Gi")
    for i in range(6):
        b.create("pods", lambda pkg, i=i: _owned(
            pkg, f"p{i}", (GCE_PD, "pd-1", False)))
    assert b.run() >= 1
    t = b.sched["torch"].ecache
    assert t.hits > 0 and t.misses > 0


def test_gate_off_means_no_cache():
    assert Scheduler(ObjectStore(), device="cpu").ecache is None
    on = Scheduler(ObjectStore(), device="cpu", features=FeatureGates(
        {"EnableEquivalenceClassCache": True}))
    assert on.ecache is not None


def test_events_invalidate_the_cache():
    """A node event drops that node's entries; a PVC event drops the
    volume predicates everywhere; an assigned pod's event drops the
    pod-derived ones of its node."""
    store = ObjectStore()
    store.create("nodes", plain_node(TORCH, "n1"))
    sched = Scheduler(store, device="cpu", features=FeatureGates(
        {"EnableEquivalenceClassCache": True}))
    ec = sched.ecache
    ec.update(1, "n1", "NoDiskConflict", True, ())
    store.update("nodes", store.get("nodes", "default", "n1"))
    assert ec.lookup(1, "n1", "NoDiskConflict") is None
    ec.update(1, "n1", "CheckVolumeBinding", True, ())
    ec.update(1, "n1", "GeneralPredicates", True, ())
    store.create("persistentvolumeclaims", volume_pvc(TORCH, "c"))
    assert ec.lookup(1, "n1", "CheckVolumeBinding") is None
    assert ec.lookup(1, "n1", "GeneralPredicates") is not None
    store.create("pods", plain_pod(TORCH, "bound", node_name="n1"))
    assert ec.lookup(1, "n1", "GeneralPredicates") is None


# --- seeded random volume worlds ------------------------------------------------


def _random_pod(b, rng, name, n_nodes, n_bound_claims, wffc):
    """One pending pod of the random world: plain, on a bound zoned
    claim, on its own WaitForFirstConsumer claim, with an inline disk
    (shared pd names, some read-only), with many PDs, or on the claim
    that has no PV. Returns the WFFC claims made so far."""
    cpu = f"{int(rng.choice([100, 500, 1000]))}m"
    prio = int(rng.choice([0, 0, 100]))
    kind = rng.randint(6)
    if kind == 0:
        vpod(b, name, cpu=cpu, priority=prio)
    elif kind == 1:
        vpod(b, name, claims=[f"data-b{rng.randint(n_bound_claims)}"],
             cpu=cpu, priority=prio, owner="db")
    elif kind == 2:
        claim = f"data-u{wffc}"
        pvc(b, claim, cls="zonal", wffc=True, gi=int(rng.randint(5, 11)))
        vpod(b, name, claims=[claim], cpu=cpu, priority=prio, owner="web")
        wffc += 1
    elif kind == 3:
        disk = (GCE_PD, f"pd-s{rng.randint(3)}", bool(rng.rand() < 0.3))
        vpod(b, name, disks=[disk], cpu=cpu, priority=prio, owner="cache")
    elif kind == 4:
        disks = [(GCE_PD, f"pd-{name}-{d}", False)
                 for d in range(rng.randint(2, 7))]
        vpod(b, name, disks=disks, cpu=cpu, priority=prio)
    else:
        vpod(b, name, claims=["orphan"], cpu=cpu, priority=prio)
    return wffc


@pytest.mark.parametrize("ecache", VOLUME_SCHEDULING)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_volume_worlds(seed, ecache):
    """Seeded worlds of 12 nodes (one without a zone label): bound
    zoned GCE PD claims, free zonal PVs of 10, 20 and 50 Gi in two zones
    only (commits lose in the third), WaitForFirstConsumer claims of
    5-10 Gi (so that every free PV holds every claim: CheckVolumeBinding
    ignores a claim's size and the VolumeBinder does not, and a claim no
    free PV of its node's zone can hold re-queues forever in both
    packages), inline disks on shared pd names,
    pods with many PDs toward the per-node limit, a claim with no PV,
    priorities that preempt, bound disk holders; the VolumeBinder on,
    waves of 16. Drained, then a second batch after the backoffs pass
    and a deletion, compared after every drain."""
    rng = np.random.RandomState(seed)
    n_nodes = 12
    b = Both(features=VOLUME_SCHEDULING[ecache])
    for i in range(n_nodes):
        zone = None if i == n_nodes - 1 else f"z{i % 3}"
        b.node(f"n{i}", cpu=str(int(rng.choice([2, 4, 8]))), zone=zone)
    n_bound_claims = 6
    for k in range(n_bound_claims):
        z = f"z{rng.randint(3)}"
        pv(b, f"pv-b{k}", kind=GCE_PD, vid=f"pd-b{k}", zone=z, affinity=z,
           cls="zonal")
        pvc(b, f"data-b{k}", volume_name=f"pv-b{k}", cls="zonal")
    for k in range(6):
        z = f"z{k % 2}"
        pv(b, f"pv-f{k}", kind=GCE_PD, vid=f"pd-f{k}", zone=z, affinity=z,
           cls="zonal", gi=int(rng.choice([10, 20, 50])))
    pvc(b, "orphan", cls="none")
    for k in range(4):
        vpod(b, f"holder-{k}", disks=[(GCE_PD, f"pd-s{k % 3}", False)],
             cpu="100m", node_name=f"n{rng.randint(n_nodes)}")
    wffc = 0
    for j in range(40):
        wffc = _random_pod(b, rng, f"p{j}", n_nodes, n_bound_claims, wffc)
    b.run()
    b.advance(61)
    b.delete("holder-0")
    for j in range(40, 52):
        wffc = _random_pod(b, rng, f"p{j}", n_nodes, n_bound_claims, wffc)
    b.run()
    bound = [v for v in claims(b.stores["torch"]).values() if v]
    assert len(bound) == len(set(bound))  # no PV bound twice
