"""Seeded cluster worlds for the parity tests of kubernetes_tpu_torch.

Each builder takes a package (`kubernetes_tpu` or `kubernetes_tpu_torch`)
and draws the same objects from the same numpy seed in either one, so a
test can build one world in both packages, or build it once and carry
its numpy tensors across with `to_torch`. `op_world` and
`store_world` cover taints of every effect, tolerations, host ports,
nodeSelectors, required and preferred node affinity (In, NotIn, Exists,
DoesNotExist, Gt, Lt, matchFields), node conditions, spreading
selectors, preferAvoidPods, priorities, zones and racks. `ipa_world`
and `ipa_store_world` add inter-pod affinity and topology spread: bound
pods with required anti-affinity terms (the symmetry plane) and with
required and preferred terms (the priority counts), pending pods with
required and preferred pod (anti-)affinity over zone and hostname, term
namespaces, the bootstrap rule (a required affinity that only the pod
itself matches), hard and soft spread constraints on zone and hostname,
and nodes without a zone label. `volume_pv`, `volume_pvc` and
`volume_pod` build persistent volumes, claims and pods with claims or
inline disks.
"""

from __future__ import annotations

import importlib

import numpy as np

EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")


def _mods(pkg: str):
    return (importlib.import_module(f"{pkg}.api.types"),
            importlib.import_module(f"{pkg}.api.labels"))


def make_nodes(pkg: str, rng: np.random.RandomState, n: int):
    api, _ = _mods(pkg)
    nodes = []
    for i in range(n):
        labels = {"failure-domain.beta.kubernetes.io/zone": f"z{rng.randint(3)}",
                  "kubernetes.io/hostname": f"n{i}"}
        if rng.rand() < 0.5:
            labels["disk"] = ["ssd", "hdd"][rng.randint(2)]
        if rng.rand() < 0.4:
            labels["gen"] = str(rng.randint(1, 5))
        if rng.rand() < 0.3:
            labels["topology.kubernetes.io/superpod"] = f"s{rng.randint(2)}"
        if rng.rand() < 0.5:
            labels["topology.kubernetes.io/rack"] = f"r{rng.randint(4)}"
        if rng.rand() < 0.3:
            labels["accelerator.kubernetes.io/generation"] = str(rng.randint(1, 4))
        taints = []
        for _ in range(rng.randint(0, 3)):
            taints.append(api.Taint(key=f"k{rng.randint(4)}",
                                    value=f"v{rng.randint(3)}",
                                    effect=EFFECTS[rng.randint(3)]))
        conds = [api.NodeCondition(api.NODE_READY,
                                   api.COND_TRUE if rng.rand() < 0.9
                                   else api.COND_FALSE)]
        if rng.rand() < 0.1:
            conds.append(api.NodeCondition(api.NODE_MEMORY_PRESSURE,
                                           api.COND_TRUE))
        annotations = {}
        if rng.rand() < 0.1:
            annotations["scheduler.alpha.kubernetes.io/preferAvoidPods"] = "{}"
        alloc = api.resource_list(cpu=str(rng.randint(2, 9)),
                                  memory=f"{rng.randint(2, 9)}Gi",
                                  pods=int(rng.randint(4, 40)),
                                  ephemeral_storage="100Gi")
        nodes.append(api.Node(
            metadata=api.ObjectMeta(name=f"n{i}", uid=f"node-{i}",
                                    labels=labels, annotations=annotations),
            spec=api.NodeSpec(unschedulable=bool(rng.rand() < 0.05),
                              taints=taints),
            status=api.NodeStatus(capacity=dict(alloc), allocatable=alloc,
                                  conditions=conds)))
    return nodes


def make_pod(pkg: str, rng: np.random.RandomState, name: str, n_nodes: int,
             node_name: str = "", rich: bool = True):
    """One pod. rich=False keeps to resources, ports and labels (the
    existing pods of a world)."""
    api, lbl = _mods(pkg)
    ports = []
    if rng.rand() < 0.3:
        p = int(8000 + rng.randint(4))
        ports = [api.ContainerPort(container_port=p, host_port=p)]
    reqs = {}
    if rng.rand() < 0.9:
        reqs = api.resource_list(cpu=f"{rng.randint(1, 8) * 100}m",
                                 memory=f"{rng.randint(1, 9) * 128}Mi")
    owners = []
    if rng.rand() < 0.5:
        owners = [api.OwnerReference(kind="ReplicaSet", name="rs",
                                     uid=f"rs-{rng.randint(3)}",
                                     controller=True)]
    labels = {"app": ["a", "b", "c"][rng.randint(3)]}
    kw = {}
    if rich:
        if rng.rand() < 0.3:
            kw["node_selector"] = {"disk": ["ssd", "hdd", "nvme"][rng.randint(3)]}
        tols = []
        ops = (api.TOLERATION_OP_EQUAL, api.TOLERATION_OP_EXISTS)
        for _ in range(rng.randint(0, 3)):
            tols.append(api.Toleration(
                key=f"k{rng.randint(4)}" if rng.rand() > 0.2 else "",
                operator=ops[rng.randint(2)], value=f"v{rng.randint(3)}",
                effect=EFFECTS[rng.randint(3)] if rng.rand() > 0.3 else ""))
        kw["tolerations"] = tols
        if rng.rand() < 0.4:
            kw["affinity"] = api.Affinity(node_affinity=_node_affinity(
                api, lbl, rng, n_nodes))
        kw["priority"] = [None, 0, 5, 10][rng.randint(4)]
    return api.Pod(
        metadata=api.ObjectMeta(name=name, uid=name, labels=labels,
                                owner_references=owners),
        spec=api.PodSpec(
            node_name=node_name,
            containers=[api.Container(
                resources=api.ResourceRequirements(requests=reqs),
                ports=ports)],
            **kw))


def _node_affinity(api, lbl, rng, n_nodes):
    def req():
        r = rng.randint(7)
        if r == 0:
            return lbl.Requirement("disk", lbl.IN, ("ssd",))
        if r == 1:
            return lbl.Requirement("disk", lbl.NOT_IN, ("hdd",))
        if r == 2:
            return lbl.Requirement("gen", lbl.EXISTS)
        if r == 3:
            return lbl.Requirement("gen", lbl.DOES_NOT_EXIST)
        if r == 4:
            return lbl.Requirement("gen", lbl.GT, (str(rng.randint(0, 4)),))
        if r == 5:
            return lbl.Requirement("gen", lbl.LT, (str(rng.randint(2, 5)),))
        return lbl.Requirement(
            "failure-domain.beta.kubernetes.io/zone", lbl.IN,
            (f"z{rng.randint(3)}", f"z{rng.randint(3)}"))

    required = None
    if rng.rand() < 0.5:
        terms = []
        for _ in range(rng.randint(1, 3)):
            fields = []
            if rng.rand() < 0.15:
                fields = [lbl.Requirement(api.NODE_FIELD_NAME, lbl.IN,
                                          (f"n{rng.randint(n_nodes)}",))]
            terms.append(api.NodeSelectorTerm(
                match_expressions=[req() for _ in range(rng.randint(0, 3))],
                match_fields=fields))
        required = api.NodeSelector(node_selector_terms=terms)
    preferred = [api.PreferredSchedulingTerm(
        weight=int(rng.randint(1, 100)),
        preference=api.NodeSelectorTerm(match_expressions=[req()]))
        for _ in range(rng.randint(0, 3))]
    return api.NodeAffinity(required=required, preferred=preferred)


def group_selectors(pkg: str):
    """Spreading selectors: every pod is selected by a service on its
    own app label."""
    _, lbl = _mods(pkg)
    return lambda pod: [lbl.Selector.from_set({"app": pod.metadata.labels["app"]})]


def op_world(pkg: str, seed: int, n_nodes: int = 24, n_existing: int = 16,
             n_pending: int = 12, caps=None, featurize: bool = True):
    """(snapshot, featurized PodBatch, pending pods) of a seeded world,
    built with the package's own cache, snapshot and featurizer. caps:
    pre-sized Caps; featurize=False leaves the batch to the caller
    (None)."""
    state = importlib.import_module(f"{pkg}.state.snapshot")
    cache_mod = importlib.import_module(f"{pkg}.state.cache")
    feat_mod = importlib.import_module(f"{pkg}.state.featurize")
    rng = np.random.RandomState(seed)
    cache = cache_mod.SchedulerCache()
    snap = state.Snapshot(caps=caps)
    for node in make_nodes(pkg, rng, n_nodes):
        cache.add_node(node)
        snap.set_node(cache.node_infos[node.name])
    for i in range(n_existing):
        p = make_pod(pkg, rng, f"e{i}", n_nodes,
                     node_name=f"n{rng.randint(n_nodes)}", rich=False)
        cache.add_pod(p)
        snap.refresh_node_resources(cache.node_infos[p.spec.node_name])
        snap.add_pod(p)
    feat = feat_mod.PodFeaturizer(snap, group_selectors(pkg))
    pods = [make_pod(pkg, rng, f"p{i}", n_nodes) for i in range(n_pending)]
    return snap, feat.featurize(pods) if featurize else None, pods


def store_world(pkg: str, seed: int, n_nodes: int, n_pods: int):
    """A store holding nodes, some bound pods and a pending backlog, plus
    services that give the backlog spreading selectors. Returns
    (store, pending pod names)."""
    api, _ = _mods(pkg)
    store_mod = importlib.import_module(f"{pkg}.runtime.store")
    rng = np.random.RandomState(seed)
    store = store_mod.ObjectStore()
    for node in make_nodes(pkg, rng, n_nodes):
        store.create("nodes", node)
    for app in ("a", "b"):
        store.create("services", api.Service(
            metadata=api.ObjectMeta(name=f"svc-{app}", uid=f"svc-{app}"),
            selector={"app": app}))
    for i in range(n_pods // 10):
        pod = make_pod(pkg, rng, f"e{i}", n_nodes,
                       node_name=f"n{rng.randint(n_nodes)}", rich=False)
        if i < 4:
            # every host port the backlog can ask for is held somewhere:
            # a port no bound pod holds has no vocabulary id when the
            # backlog is featurized, and the JAX scheduler's per-wave
            # loop then retries such pods forever (ROADMAP, queue 3)
            port = 8000 + i
            pod.spec.containers[0].ports = [api.ContainerPort(
                container_port=port, host_port=port)]
        store.create("pods", pod)
    names = []
    for i in range(n_pods):
        pod = make_pod(pkg, rng, f"p{i}", n_nodes)
        store.create("pods", pod)
        names.append(pod.metadata.name)
    return store, names


def bindings(store) -> dict:
    """pod name -> node name ('' while pending)."""
    return {p.metadata.name: p.spec.node_name for p in store.list("pods")}


# --- inter-pod affinity and topology spread -------------------------------

HOSTNAME = "kubernetes.io/hostname"
ZONE = "failure-domain.beta.kubernetes.io/zone"
NAMESPACES = ("default", "prod")


def _term(api, lbl, rng, tk=None):
    """One PodAffinityTerm over the `grp` or `app` label, in the pod's own
    namespace or an explicit list."""
    r = rng.rand()
    if r < 0.5:
        sel = lbl.LabelSelector(match_labels={"grp": f"g{rng.randint(3)}"})
    elif r < 0.8:
        sel = lbl.LabelSelector(match_labels={"app": "abc"[rng.randint(3)]})
    else:
        sel = lbl.LabelSelector(match_expressions=(lbl.Requirement(
            "grp", lbl.NOT_IN, (f"g{rng.randint(3)}",)),))
    ns = [[], [], ["prod"], list(NAMESPACES)][rng.randint(4)]
    return api.PodAffinityTerm(
        label_selector=sel, namespaces=ns,
        topology_key=tk or (HOSTNAME, ZONE)[rng.randint(2)])


def _preferred(api, lbl, rng):
    return [api.WeightedPodAffinityTerm(weight=int(rng.randint(1, 101)),
                                        pod_affinity_term=_term(api, lbl, rng))
            for _ in range(rng.randint(1, 3))]


def _ipa_affinity(api, lbl, rng, bound: bool, solo: str):
    """The pod's Affinity or None. Required terms of one kind share one
    topology key (the port refuses pods whose terms span two)."""
    r = rng.rand()
    if bound:
        if r < 0.4:
            return api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
                required=[_term(api, lbl, rng)]))
        if r < 0.55:
            return api.Affinity(pod_affinity=api.PodAffinity(
                required=[_term(api, lbl, rng, ZONE)]))
        if r < 0.75:
            return api.Affinity(pod_affinity=api.PodAffinity(
                preferred=_preferred(api, lbl, rng)),
                pod_anti_affinity=api.PodAntiAffinity(
                    preferred=_preferred(api, lbl, rng)))
        return None
    tk = (HOSTNAME, ZONE)[rng.randint(2)]
    if r < 0.2:
        return api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
            required=[_term(api, lbl, rng, tk)
                      for _ in range(rng.randint(1, 3))]))
    if r < 0.35:
        return api.Affinity(pod_affinity=api.PodAffinity(
            required=[_term(api, lbl, rng, tk)]))
    if r < 0.45:
        # bootstrap: only pods of this `solo` set match the term
        return api.Affinity(pod_affinity=api.PodAffinity(required=[
            api.PodAffinityTerm(
                label_selector=lbl.LabelSelector(match_labels={"solo": solo}),
                topology_key=tk)]))
    if r < 0.6:
        return api.Affinity(pod_affinity=api.PodAffinity(
            preferred=_preferred(api, lbl, rng)),
            pod_anti_affinity=api.PodAntiAffinity(
                preferred=_preferred(api, lbl, rng)))
    if r < 0.7:
        return api.Affinity(
            pod_affinity=api.PodAffinity(required=[_term(api, lbl, rng,
                                                         ZONE)]),
            pod_anti_affinity=api.PodAntiAffinity(
                required=[_term(api, lbl, rng, HOSTNAME)]))
    return None


def _spread(api, lbl, rng, app: str):
    out = []
    if rng.rand() < 0.5:
        sel = (lbl.LabelSelector(match_labels={"app": app})
               if rng.rand() < 0.9 else None)
        out.append(api.TopologySpreadConstraint(
            max_skew=int(rng.randint(1, 3)), topology_key=ZONE,
            when_unsatisfiable=api.DO_NOT_SCHEDULE, label_selector=sel))
    if rng.rand() < 0.3:
        out.append(api.TopologySpreadConstraint(
            max_skew=1, topology_key=HOSTNAME,
            when_unsatisfiable=api.SCHEDULE_ANYWAY,
            label_selector=lbl.LabelSelector(match_labels={"app": app})))
    return out


def make_ipa_pod(pkg: str, rng: np.random.RandomState, name: str,
                 node_name: str = ""):
    """One pod of an affinity/spread world: no host ports, random
    namespace, labels app/grp (and `solo` for some), an Affinity, and for
    pending pods topology spread constraints."""
    api, lbl = _mods(pkg)
    app = "abc"[rng.randint(3)]
    solo = f"s{rng.randint(2)}"
    labels = {"app": app, "grp": f"g{rng.randint(3)}"}
    if rng.rand() < 0.15:
        labels["solo"] = solo
    aff = _ipa_affinity(api, lbl, rng, bool(node_name), solo)
    spread = [] if node_name else _spread(api, lbl, rng, app)
    return api.Pod(
        metadata=api.ObjectMeta(name=name, uid=name, labels=labels,
                                namespace=NAMESPACES[rng.randint(2)]),
        spec=api.PodSpec(
            node_name=node_name, affinity=aff,
            topology_spread_constraints=spread,
            priority=[None, 0, 5][rng.randint(3)],
            containers=[api.Container(resources=api.ResourceRequirements(
                requests=api.resource_list(
                    cpu=f"{rng.randint(1, 6) * 100}m",
                    memory=f"{rng.randint(1, 5) * 128}Mi")))]))


def _ipa_nodes(pkg: str, rng: np.random.RandomState, n: int):
    """make_nodes, with the zone label taken off about one node in eight
    (spread constraints on zone then fail there)."""
    nodes = make_nodes(pkg, rng, n)
    for node in nodes:
        if rng.rand() < 0.125:
            del node.metadata.labels[ZONE]
    return nodes


def ipa_world(pkg: str, seed: int, n_nodes: int = 12, n_existing: int = 10,
              n_pending: int = 14, caps=None, featurize: bool = True):
    """(snapshot, featurized PodBatch, pending pods) of a seeded
    affinity/spread world, built with the package's own cache, snapshot
    and featurizer. caps: pre-sized Caps (fewer distinct shapes);
    featurize=False leaves the batch to the caller (None)."""
    state = importlib.import_module(f"{pkg}.state.snapshot")
    cache_mod = importlib.import_module(f"{pkg}.state.cache")
    feat_mod = importlib.import_module(f"{pkg}.state.featurize")
    rng = np.random.RandomState(seed)
    cache = cache_mod.SchedulerCache()
    snap = state.Snapshot(caps=caps)
    for node in _ipa_nodes(pkg, rng, n_nodes):
        cache.add_node(node)
        snap.set_node(cache.node_infos[node.name])
    for i in range(n_existing):
        p = make_ipa_pod(pkg, rng, f"e{i}", f"n{rng.randint(n_nodes)}")
        cache.add_pod(p)
        snap.refresh_node_resources(cache.node_infos[p.spec.node_name])
        snap.add_pod(p)
    feat = feat_mod.PodFeaturizer(snap, group_selectors(pkg))
    pods = [make_ipa_pod(pkg, rng, f"p{i}") for i in range(n_pending)]
    return snap, feat.featurize(pods) if featurize else None, pods


def ipa_store_world(pkg: str, seed: int, n_nodes: int, n_pods: int):
    """A store holding nodes, bound pods with affinity terms, services on
    `app`, and a pending backlog with pod (anti-)affinity and spread
    constraints. Returns (store, pending pod names)."""
    api, _ = _mods(pkg)
    store_mod = importlib.import_module(f"{pkg}.runtime.store")
    rng = np.random.RandomState(seed)
    store = store_mod.ObjectStore()
    for node in _ipa_nodes(pkg, rng, n_nodes):
        store.create("nodes", node)
    for ns in NAMESPACES:
        for app in ("a", "b"):
            store.create("services", api.Service(
                metadata=api.ObjectMeta(name=f"svc-{app}", namespace=ns,
                                        uid=f"svc-{ns}-{app}"),
                selector={"app": app}))
    for i in range(n_pods // 10):
        store.create("pods", make_ipa_pod(pkg, rng, f"e{i}",
                                          f"n{rng.randint(n_nodes)}"))
    names = []
    for i in range(n_pods):
        pod = make_ipa_pod(pkg, rng, f"p{i}")
        store.create("pods", pod)
        names.append(pod.metadata.name)
    return store, names


def spread_store_world(pkg: str, seed: int, n_nodes: int, n_pods: int,
                       n_apps: int):
    """Deployments spread the way users spread them: every pod of
    Deployment `app=d{k}` carries a hard zone spread (maxSkew 1,
    DoNotSchedule) and a soft hostname spread (ScheduleAnyway), both
    selecting its own app. Nodes sit in three zones; a tenth of the
    backlog's apps already have bound pods. Returns (store, pending pod
    names)."""
    api, lbl = _mods(pkg)
    store_mod = importlib.import_module(f"{pkg}.runtime.store")
    rng = np.random.RandomState(seed)
    store = store_mod.ObjectStore()
    for i in range(n_nodes):
        size = int(rng.randint(4, 9))
        store.create("nodes", api.Node(
            metadata=api.ObjectMeta(name=f"n{i}", uid=f"node-{i}", labels={
                ZONE: f"z{i % 3}", HOSTNAME: f"n{i}"}),
            status=api.NodeStatus(
                allocatable=api.resource_list(cpu=str(size),
                                              memory=f"{size}Gi", pods=40),
                conditions=[api.NodeCondition(api.NODE_READY,
                                              api.COND_TRUE)])))

    def pod(name, app, node_name=""):
        sel = lbl.LabelSelector(match_labels={"app": app})
        return api.Pod(
            metadata=api.ObjectMeta(name=name, uid=name, labels={"app": app}),
            spec=api.PodSpec(
                node_name=node_name,
                topology_spread_constraints=[
                    api.TopologySpreadConstraint(
                        max_skew=1, topology_key=ZONE,
                        when_unsatisfiable=api.DO_NOT_SCHEDULE,
                        label_selector=sel),
                    api.TopologySpreadConstraint(
                        max_skew=1, topology_key=HOSTNAME,
                        when_unsatisfiable=api.SCHEDULE_ANYWAY,
                        label_selector=sel)],
                containers=[api.Container(resources=api.ResourceRequirements(
                    requests=api.resource_list(
                        cpu=f"{rng.randint(1, 4) * 100}m",
                        memory=f"{rng.randint(1, 4) * 128}Mi")))]))

    for i in range(n_pods // 10):
        store.create("pods", pod(f"e{i}", f"d{rng.randint(n_apps)}",
                                 f"n{rng.randint(n_nodes)}"))
    names = []
    for i in range(n_pods):
        p = pod(f"p{i}", f"d{rng.randint(n_apps)}")
        store.create("pods", p)
        names.append(p.metadata.name)
    return store, names


def zone_skew(store) -> dict:
    """app -> max minus min count of its bound pods over the zones."""
    zone_of = {n.metadata.name: n.metadata.labels.get(ZONE)
               for n in store.list("nodes")}
    zones = sorted({z for z in zone_of.values() if z})
    counts: dict = {}
    for p in store.list("pods"):
        if p.spec.node_name:
            c = counts.setdefault(p.metadata.labels["app"], dict.fromkeys(
                zones, 0))
            c[zone_of[p.spec.node_name]] += 1
    return {app: max(c.values()) - min(c.values())
            for app, c in counts.items()}


# --- small hand-built worlds for the gang and preemption scenarios ------------


class FakeClock:
    """A virtual clock for both packages' schedulers: backoff deadlines
    and assumed-pod expiry move only when a test advances it."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, d: float) -> None:
        self.t += d


def plain_node(pkg: str, name: str, cpu: str = "4", memory: str = "8Gi",
               pods: int = 110, taints=(), zone=None):
    """A Ready node (tests/helpers.py make_node) in either package; zone
    sets its zone label."""
    api, _ = _mods(pkg)
    alloc = api.resource_list(cpu=cpu, memory=memory, pods=pods,
                              ephemeral_storage="100Gi")
    labels = {HOSTNAME: name}
    if zone is not None:
        labels[ZONE] = zone
    return api.Node(
        metadata=api.ObjectMeta(name=name, uid=f"node-{name}",
                                labels=labels),
        spec=api.NodeSpec(taints=list(taints)),
        status=api.NodeStatus(
            capacity=dict(alloc), allocatable=alloc,
            conditions=[api.NodeCondition(api.NODE_READY, api.COND_TRUE)]))


def plain_pod(pkg: str, name: str, cpu=None, memory=None, priority=None,
              labels=None, gang=None, min_avail=None, node_name="",
              affinity=None):
    """A pod (tests/helpers.py make_pod) in either package; gang names its
    PodGroup annotation, min_avail the min-available annotation,
    node_name binds it, and affinity(api, lbl) builds its Affinity in the
    package's own types."""
    api, lbl = _mods(pkg)
    reqs = {}
    if cpu is not None or memory is not None:
        reqs = api.resource_list(cpu=cpu, memory=memory)
    annotations = {}
    if gang is not None:
        annotations[api.POD_GROUP_NAME_ANNOTATION] = gang
        if min_avail is not None:
            annotations[api.POD_GROUP_MIN_AVAILABLE_ANNOTATION] = str(min_avail)
    return api.Pod(
        metadata=api.ObjectMeta(name=name, uid=name, labels=dict(labels or {}),
                                annotations=annotations),
        spec=api.PodSpec(
            priority=priority, node_name=node_name,
            affinity=affinity(api, lbl) if affinity is not None else None,
            containers=[api.Container(
                name="c", resources=api.ResourceRequirements(requests=reqs))]))


def multikey_affinity(app: str = "db", tier: str = "cache",
                      anti: bool = False):
    """affinity(api, lbl) for plain_pod: required pod affinity over two
    topology keys (the JAX package's exact host path): the zone of an
    `app=<app>` pod and the host of a `tier=<tier>` pod; anti: the same
    two terms as required anti-affinity. In the 1.11 semantics both
    packages keep (predicates.go anyPodsMatchingTopologyTerms) ONE bound
    pod must match every term and share every term's domain with the
    node, so only a pod labelled with both anchors the terms."""

    def build(api, lbl):
        terms = [api.PodAffinityTerm(
                     label_selector=lbl.LabelSelector(
                         match_labels={"app": app}), topology_key=ZONE),
                 api.PodAffinityTerm(
                     label_selector=lbl.LabelSelector(
                         match_labels={"tier": tier}),
                     topology_key=HOSTNAME)]
        if anti:
            return api.Affinity(pod_anti_affinity=api.PodAntiAffinity(
                required=terms))
        return api.Affinity(pod_affinity=api.PodAffinity(required=terms))

    return build


def bench_node(pkg: str, i: int):
    """bench.py build_cluster's node: 3 zones, 16 CPU, 32Gi, 110 pods."""
    api, _ = _mods(pkg)
    return api.Node(
        metadata=api.ObjectMeta(name=f"node-{i}", labels={
            ZONE: f"zone-{i % 3}", HOSTNAME: f"node-{i}"}),
        status=api.NodeStatus(
            allocatable=api.resource_list(cpu="16", memory="32Gi", pods=110,
                                          ephemeral_storage="200Gi"),
            conditions=[api.NodeCondition(api.NODE_READY, api.COND_TRUE)]))


def bench_pod(pkg: str, name: str, prefix: str, cpu: str = "100m",
              priority=None):
    """bench.py _base_pod (100m / 128Mi, controlled by an RC named after
    the prefix), its CPU request and priority set as run_preempt_config
    sets them."""
    api, _ = _mods(pkg)
    return api.Pod(
        metadata=api.ObjectMeta(
            name=name, uid=name, labels={"type": prefix},
            owner_references=[api.OwnerReference(
                kind="ReplicationController", name=prefix, uid=f"rc-{prefix}",
                controller=True)]),
        spec=api.PodSpec(priority=priority, containers=[api.Container(
            resources=api.ResourceRequirements(
                requests=api.resource_list(cpu=cpu, memory="128Mi")))]))


def pod_group(pkg: str, name: str, min_member: int):
    api, _ = _mods(pkg)
    return api.PodGroup(metadata=api.ObjectMeta(name=name),
                        spec=api.PodGroupSpec(min_member=min_member))


def pdb(pkg: str, name: str, match_labels: dict, allowed: int):
    api, lbl = _mods(pkg)
    return api.PodDisruptionBudget(
        metadata=api.ObjectMeta(name=name),
        spec=api.PodDisruptionBudgetSpec(
            selector=lbl.LabelSelector(match_labels=match_labels)),
        status=api.PodDisruptionBudgetStatus(disruptions_allowed=allowed))



# --- volumes ----------------------------------------------------------------

GI = 2 ** 30
GCE_PD = "GCEPersistentDisk"
EBS = "AWSElasticBlockStore"


def zone_affinity(pkg: str, zone: str):
    """A PV node affinity that admits the nodes of one zone."""
    api, lbl = _mods(pkg)
    return api.NodeSelector(node_selector_terms=[api.NodeSelectorTerm(
        match_expressions=[lbl.Requirement(ZONE, lbl.IN, (zone,))])])


def volume_pv(pkg: str, name: str, kind: str = "", vid: str = "",
              zone=None, affinity=None, cls: str = "", gi=None):
    """A PersistentVolume of source `kind`/`vid`: zone labels it with a
    zone (or a '__'-joined zone set), affinity (a zone) gives it the
    node affinity of that zone, gi its capacity."""
    api, _ = _mods(pkg)
    return api.PersistentVolume(
        metadata=api.ObjectMeta(name=name,
                                labels={ZONE: zone} if zone else {}),
        spec=api.PersistentVolumeSpec(
            source_kind=kind, source_id=vid, storage_class_name=cls,
            capacity={"storage": gi * GI} if gi else {},
            node_affinity=(zone_affinity(pkg, affinity) if affinity
                           else None)))


def volume_pvc(pkg: str, name: str, volume_name: str = "", cls: str = "",
               wffc: bool = False, gi=None):
    """A PersistentVolumeClaim, bound to `volume_name` or unbound;
    wffc: its class binds WaitForFirstConsumer (the scheduler's
    VolumeBinder binds it at commit), else Immediate."""
    api, _ = _mods(pkg)
    return api.PersistentVolumeClaim(
        metadata=api.ObjectMeta(name=name),
        spec=api.PersistentVolumeClaimSpec(
            volume_name=volume_name, storage_class_name=cls,
            volume_binding_mode=("WaitForFirstConsumer" if wffc
                                 else "Immediate"),
            requests={"storage": gi * GI} if gi else {}))


def volume_pod(pkg: str, name: str, claims=(), disks=(), owner=None,
               **kw):
    """plain_pod(**kw) with a volume per claim name and per inline disk
    (kind, id, read_only); owner names the StatefulSet that controls
    it."""
    api, _ = _mods(pkg)
    pod = plain_pod(pkg, name, **kw)
    pod.spec.volumes = (
        [api.Volume(name=c, pvc_name=c) for c in claims]
        + [api.Volume(name=f"disk-{i}", source_kind=k, source_id=v,
                      read_only=ro) for i, (k, v, ro) in enumerate(disks)])
    if owner is not None:
        pod.metadata.owner_references = [api.OwnerReference(
            kind="StatefulSet", name=owner, uid=f"ss-{owner}",
            controller=True)]
    return pod
