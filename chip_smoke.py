#!/usr/bin/env python3
"""Smoke run of kubernetes_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device  — the card's name and power limit, the CUDA and torch versions;
  2. build   — compiles csrc/taint_ports.cu for sm_90a from this checkout;
  3. kernel  — the taint/host-port kernel against its plain PyTorch version
               on seeded worlds at the main path's shapes and at the
               kernel's edges (taint_ports.EDGE_TABLES; exact equality),
               then timed on a dense world, on a world with no toleration
               and no port (its store path alone), and beside a plain
               fill of the same two outputs (the card's write rate);
  4. density — the main path at full size: Scheduler(store,
               device="cuda").schedule_pending() over 5 000 nodes and a
               30 000-pod backlog; the store's bindings must respect every
               resource, taint, host-port and nodeSelector constraint, and
               the kernel must have launched during the run, on the live
               waves' rows only (printed per round). The host time
               of each phase of the rounds is printed; then the kernel is
               held against its plain version on a copy of the inputs the
               rounds gave it (one of each row count; exact equality), as
               it is after phases 6 and 7, and timed with its plain
               version by CUDA events on the first round's, beside the
               kernel's bound;
  5. parity  — reduced worlds of the density, mixed and spread shapes
               (500 nodes, 1 000 pods, same seed) scheduled on the card and
               on the CPU: identical bindings;
  6. mixed   — bench.py's mixed5k shape at full width: 5 000 nodes with
               node-affinity labels, 30 000 pods in four quarters (density,
               required node affinity, service spreading, required hostname
               anti-affinity in 50 groups). Every placement invariant
               holds (resources, node affinity, no two pods of one
               anti-group on a node), every round runs at most 64 waves
               and launches the kernel on its live rows only, and at least
               one round runs with inter-pod affinity. Printed: pods/s,
               host seconds by phase, each round's has_ipa, waves and
               device_round seconds, ms per pod with and without ipa, the
               implicit host syncs of one ipa round (that round is left
               out of the per-pod and per-wave times), and
               incoming_statics timed on one full-width wave;
  7. spread  — 5 000 nodes and 10 000 pods of 20 Deployments, each pod
               with a hard zone spread (maxSkew 1) and a soft hostname
               spread: every Deployment's zone counts differ by at most 1,
               every round runs with topology spread; the same timing
               lines, and topo_statics timed on one full-width wave.
Each drain sets the kernel's launch count to 0 before it and reads it
after. Then it prints the kernel table as one JSON line (launches of
every drain), the card's name and power limit, and last
{"ok": true, "device": {...}}.

It needs the kubernetes_tpu_torch package beside it, and a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 20261017
FULL_NODES, FULL_PODS = 5000, 30000
SPREAD_PODS, SPREAD_APPS = 10000, 20
SMALL_NODES, SMALL_PODS = 500, 1000
WAVE = 128
# the round's wave cap with inter-pod affinity (sched/scheduler.py)
IPA_MAX_WAVES = 64
ZONE = "failure-domain.beta.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
# H100 SXM HBM bandwidth (NVIDIA data sheet). The kernel's compares and
# logic are 32-bit integer work: an SM has 64 INT32 lanes a clock (the
# 128 FP32 lanes, and the 67 TFLOP/s that count an FMA as two, do not
# apply), so the integer rate is SMs x 64 x the SM clock, read from the
# card at run time
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# the fields of the node and pod tensors that taint_ports_masks reads
KERNEL_NODE_FIELDS = ("taint_key", "taint_val", "taint_effect", "ports")
KERNEL_POD_FIELDS = ("tol_key", "tol_val", "tol_op", "tol_effect", "ports")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# --- worlds ------------------------------------------------------------------


def build_store(api, store_mod, n_nodes: int, n_pods: int, seed: int):
    """The deployment of the main path: kube-scheduler 1.11's 5 000-node
    scalability shape (bench.py build_cluster nodes: 3 zones, 16 CPU,
    32Gi, 110 pods), 1/4 of the nodes tainted dedicated=infra:NoSchedule
    and 1/20 maintenance:NoExecute, bound pods holding hostPort 8080 on
    1/10 of the nodes, and a backlog of bench.py's density pods
    (100m / 128Mi) of which 1/4 tolerate `dedicated`, 1/10 ask for
    hostPort 8080 and 1/10 carry a zone nodeSelector."""
    import numpy as np

    rng = np.random.RandomState(seed)
    store = store_mod.ObjectStore()
    port_nodes = []
    for i in range(n_nodes):
        taints = []
        if rng.rand() < 0.25:
            taints.append(api.Taint(key="dedicated", value="infra",
                                    effect=api.NO_SCHEDULE))
        if rng.rand() < 0.05:
            taints.append(api.Taint(key="maintenance",
                                    effect=api.NO_EXECUTE))
        if rng.rand() < 0.10:
            port_nodes.append(f"node-{i}")
        store.create("nodes", api.Node(
            metadata=api.ObjectMeta(name=f"node-{i}", labels={
                ZONE: f"zone-{i % 3}", HOSTNAME: f"node-{i}"}),
            spec=api.NodeSpec(taints=taints),
            status=api.NodeStatus(
                allocatable=api.resource_list(cpu="16", memory="32Gi",
                                              pods=110,
                                              ephemeral_storage="200Gi"),
                conditions=[api.NodeCondition(api.NODE_READY,
                                              api.COND_TRUE)])))

    def pod(name, node_name="", port=False, tolerate=False, zone=None):
        ports = ([api.ContainerPort(container_port=8080, host_port=8080)]
                 if port else [])
        if tolerate == "all":  # the bound port holders, daemon-style
            tolerations = [api.Toleration(
                operator=api.TOLERATION_OP_EXISTS)]
        elif tolerate:
            tolerations = [api.Toleration(
                key="dedicated", operator=api.TOLERATION_OP_EQUAL,
                value="infra", effect=api.NO_SCHEDULE)]
        else:
            tolerations = []
        return api.Pod(
            metadata=api.ObjectMeta(
                name=name, labels={"type": "density"},
                owner_references=[api.OwnerReference(
                    kind="ReplicationController", name="density",
                    uid="rc-density", controller=True)]),
            spec=api.PodSpec(
                node_name=node_name,
                node_selector=({ZONE: zone} if zone else {}),
                tolerations=tolerations,
                containers=[api.Container(
                    resources=api.ResourceRequirements(
                        requests=api.resource_list(cpu="100m",
                                                   memory="128Mi")),
                    ports=ports)]))

    for j, node_name in enumerate(port_nodes):
        store.create("pods", pod(f"holder-{j}", node_name=node_name,
                                 port=True, tolerate="all"))
    for j in range(n_pods):
        store.create("pods", pod(
            f"pod-{j}", port=rng.rand() < 0.10, tolerate=rng.rand() < 0.25,
            zone=f"zone-{rng.randint(3)}" if rng.rand() < 0.10 else None))
    return store, len(port_nodes)


def add_plain_nodes(api, store, n_nodes: int, affinity_labels: int = 0):
    """bench.py build_cluster: 3 zones, 16 CPU, 32Gi, 110 pods a node, and
    with affinity_labels one of K `aff-{i % K}=yes` labels a node."""
    for i in range(n_nodes):
        labels = {ZONE: f"zone-{i % 3}", HOSTNAME: f"node-{i}"}
        if affinity_labels:
            labels[f"aff-{i % affinity_labels}"] = "yes"
        store.create("nodes", api.Node(
            metadata=api.ObjectMeta(name=f"node-{i}", labels=labels),
            status=api.NodeStatus(
                allocatable=api.resource_list(cpu="16", memory="32Gi",
                                              pods=110,
                                              ephemeral_storage="200Gi"),
                conditions=[api.NodeCondition(api.NODE_READY,
                                              api.COND_TRUE)])))


def build_mixed(api, lbl, store_mod, n_nodes: int, n_pods: int):
    """bench.py's `mixed` workload (make_pods "mixed" over build_cluster
    with affinity_labels=10), rebuilt here without the JAX package: four
    quarters of 100m / 128Mi pods, created in this order — density;
    required node affinity `aff-{i % 10} In (yes)`; spreading over 10
    services `svc=s{i % 10}`; required anti-affinity on the hostname
    within 50 groups `anti-group=g{i % 50}` (the last quarter takes the
    remainder). Returns (store, 0 bound pods)."""
    store = store_mod.ObjectStore()
    add_plain_nodes(api, store, n_nodes, affinity_labels=10)
    for s in range(10):
        store.create("services", api.Service(
            metadata=api.ObjectMeta(name=f"svc-{s}"),
            spec=api.ServiceSpec(selector={"svc": f"s{s}"})))

    def pod(name, prefix, labels=None, affinity=None):
        return api.Pod(
            metadata=api.ObjectMeta(
                name=name, labels=labels or {"type": prefix},
                owner_references=[api.OwnerReference(
                    kind="ReplicationController", name=prefix,
                    uid=f"rc-{prefix}", controller=True)]),
            spec=api.PodSpec(affinity=affinity, containers=[api.Container(
                resources=api.ResourceRequirements(
                    requests=api.resource_list(cpu="100m",
                                               memory="128Mi")))]))

    quarter = n_pods // 4
    for wl in ("density", "affinity", "spreading", "antiaffinity"):
        prefix = f"{wl}-pod"
        for i in range(quarter if wl != "antiaffinity"
                       else n_pods - 3 * quarter):
            name = f"{prefix}-{i}"
            if wl == "density":
                p = pod(name, prefix)
            elif wl == "affinity":
                p = pod(name, prefix, affinity=api.Affinity(
                    node_affinity=api.NodeAffinity(
                        required=api.NodeSelector([api.NodeSelectorTerm(
                            match_expressions=[lbl.Requirement(
                                f"aff-{i % 10}", "In", ("yes",))])]))))
            elif wl == "spreading":
                p = pod(name, prefix, labels={"type": prefix,
                                              "svc": f"s{i % 10}"})
            else:
                group = i % 50
                p = pod(name, prefix,
                        labels={"type": prefix, "anti-group": f"g{group}"},
                        affinity=api.Affinity(
                            pod_anti_affinity=api.PodAntiAffinity(
                                required=[api.PodAffinityTerm(
                                    label_selector=lbl.LabelSelector(
                                        match_labels={
                                            "anti-group": f"g{group}"}),
                                    topology_key=HOSTNAME)])))
            store.create("pods", p)
    return store, 0


def build_spread(api, lbl, store_mod, n_nodes: int, n_pods: int,
                 n_apps: int):
    """Deployments spread evenly across zones as a hard rule and across
    nodes as a preference: n_apps Deployments `app=d{k}` whose ReplicaSets
    create their pods one Deployment after another, each pod 100m /
    128Mi with a zone spread (maxSkew 1, DoNotSchedule) and a hostname
    spread (maxSkew 1, ScheduleAnyway) on its own app. Nodes as
    bench.py build_cluster. Returns (store, 0 bound pods)."""
    store = store_mod.ObjectStore()
    add_plain_nodes(api, store, n_nodes)
    per_app = n_pods // n_apps
    for k in range(n_apps):
        app = f"d{k}"
        sel = lbl.LabelSelector(match_labels={"app": app})
        for i in range(per_app if k < n_apps - 1
                       else n_pods - per_app * (n_apps - 1)):
            store.create("pods", api.Pod(
                metadata=api.ObjectMeta(
                    name=f"{app}-{i}", labels={"app": app},
                    owner_references=[api.OwnerReference(
                        kind="ReplicaSet", name=f"{app}-rs", uid=f"rs-{app}",
                        controller=True)]),
                spec=api.PodSpec(
                    topology_spread_constraints=[
                        api.TopologySpreadConstraint(
                            max_skew=1, topology_key=ZONE,
                            when_unsatisfiable=api.DO_NOT_SCHEDULE,
                            label_selector=sel),
                        api.TopologySpreadConstraint(
                            max_skew=1, topology_key=HOSTNAME,
                            when_unsatisfiable=api.SCHEDULE_ANYWAY,
                            label_selector=sel)],
                    containers=[api.Container(
                        resources=api.ResourceRequirements(
                            requests=api.resource_list(
                                cpu="100m", memory="128Mi")))])))
    return store, 0


def scheduler_caps(enc, bucket_size, n_nodes, n_pods, n_bound, n_terms=0):
    """Pre-sized as bench.py run_config does, so no capacity grows (and
    no shape changes) mid-run: E holds one term row per anti-affinity
    pod."""
    return enc.Caps(M=bucket_size(n_pods + n_bound + 64), P=WAVE,
                    E=bucket_size(n_terms + 64) if n_terms else 8,
                    LV=bucket_size(n_nodes + 256, 64))


def check_bindings(api, store) -> int:
    """The invariants of a placement, read back from the store: taints,
    nodeSelector and required node affinity, host ports, resources and
    pod counts. Returns the number of bound pods."""
    nodes = {n.metadata.name: n for n in store.list("nodes")}
    used = {}
    bound = 0
    for p in store.list("pods"):
        name = p.spec.node_name
        if not name:
            continue
        bound += 1
        node = nodes.get(name)
        if node is None:
            fail(f"{p.metadata.name} bound to unknown node {name}")
        for taint in node.spec.taints:
            if taint.effect in (api.NO_SCHEDULE, api.NO_EXECUTE) and not \
                    api.tolerations_tolerate_taint(p.spec.tolerations, taint):
                fail(f"{p.metadata.name} on {name} does not tolerate "
                     f"{taint}")
        if not api.pod_matches_node_selector(p, node):
            fail(f"{p.metadata.name} on {name} misses its nodeSelector or "
                 "required node affinity")
        u = used.setdefault(name, {"cpu": 0, "memory": 0, "pods": 0,
                                   "ports": set()})
        req = api.get_resource_request(p)
        u["cpu"] += req.get("cpu", 0)
        u["memory"] += req.get("memory", 0)
        u["pods"] += 1
        for cp in api.get_container_ports(p):
            key = (cp.protocol, cp.host_port)
            if key in u["ports"]:
                fail(f"host port {key} used twice on {name}")
            u["ports"].add(key)
    for name, u in used.items():
        alloc = nodes[name].status.allocatable
        for res in ("cpu", "memory", "pods"):
            if u[res] > alloc.get(res, 0):
                fail(f"{name} over-committed on {res}: {u[res]} > "
                     f"{alloc.get(res, 0)}")
    return bound


def check_anti_affinity(store) -> int:
    """No bound pod shares a topology domain with a pod its required
    anti-affinity terms select (in the terms' namespaces). Returns the
    number of bound pods carrying such terms."""
    node_labels = {n.metadata.name: n.metadata.labels or {}
                   for n in store.list("nodes")}
    bound = [p for p in store.list("pods") if p.spec.node_name]
    by_domain = {}
    for p in bound:
        for key, value in node_labels[p.spec.node_name].items():
            by_domain.setdefault((key, value), []).append(p)
    checked = 0
    for p in bound:
        aff = p.spec.affinity
        if aff is None or aff.pod_anti_affinity is None:
            continue
        checked += 1
        for term in aff.pod_anti_affinity.required:
            value = node_labels[p.spec.node_name].get(term.topology_key)
            if value is None:
                continue
            namespaces = set(term.namespaces) or {p.namespace}
            for q in by_domain[(term.topology_key, value)]:
                if q is not p and q.namespace in namespaces and \
                        term.label_selector.matches(q.metadata.labels):
                    fail(f"{p.metadata.name} and {q.metadata.name} share "
                         f"{term.topology_key}={value} against "
                         f"{p.metadata.name}'s anti-affinity")
    return checked


def zone_counts(store) -> dict:
    """app -> {zone: bound pods of the app}."""
    zone_of = {n.metadata.name: n.metadata.labels[ZONE]
               for n in store.list("nodes")}
    zones = sorted(set(zone_of.values()))
    out = {}
    for p in store.list("pods"):
        if p.spec.node_name:
            c = out.setdefault(p.metadata.labels["app"],
                               dict.fromkeys(zones, 0))
            c[zone_of[p.spec.node_name]] += 1
    return out


def bindings(store) -> dict:
    return {p.metadata.name: p.spec.node_name for p in store.list("pods")}


# --- kernel phase --------------------------------------------------------------


def int_ops_per_s(torch):
    """(integer ops per second, SMs, SM MHz): SMs x 64 INT32 lanes x the
    card's maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi clocks.max.sm: {smi.stderr.strip()}")
    mhz = float(smi.stdout.split()[0])
    return sms * INT32_LANES_PER_SM * mhz * 1e6, sms, mhz


def kernel_bound(nt, pb, effects, int_rate):
    """(least ms, what bounds it, bytes, ops): the bytes the function
    must move (each input read once, each output written once) over HBM
    bandwidth, and the integer work these inputs need over the card's
    integer rate. Work: 8 ops per (relevant node taint, live pod
    toleration) pair, 2 per (live pod port, live node port) pair; a pad
    slot needs no compare."""
    N, T = nt.taint_key.shape
    PP = nt.ports.shape[1]
    P, TL = pb.tol_key.shape
    PQ = pb.ports.shape[1]
    in_bytes = 4 * (N * (3 * T + PP) + P * (4 * TL + PQ))
    out_bytes = 2 * P * N
    relevant = sum(int((nt.taint_effect == e).sum()) for e in effects)
    live_tol = int((pb.tol_op != -1).sum())
    node_ports = int((nt.ports > 0).sum())
    pod_ports = int((pb.ports > 0).sum())
    ops = 8 * relevant * live_tol + 2 * node_ports * pod_ports
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            in_bytes + out_bytes, ops)


def check_kernel(torch, tp, nt, pb, effects, what):
    """The kernel against its plain version on one world: exact equality
    of both masks, launched once. Returns the largest |kernel - plain|."""
    before = tp.taint_ports_masks.launches
    got = tp.taint_ports_masks(nt, pb, effects=effects)
    torch.cuda.synchronize()
    if tp.taint_ports_masks.launches != before + 1:
        fail(f"the kernel did not launch once ({what})")
    want = tp.taint_ports_plain(nt, pb, effects)
    err = 0
    for g, w, name in zip(got, want, ("taints", "ports")):
        err = max(err, int((g.to(torch.int32) - w.to(torch.int32))
                           .abs().max()))
        if not torch.equal(g, w):
            fail(f"kernel != plain ({name}, {what})")
    return err


def check_captured(torch, tp, name, captured):
    """The kernel against its plain version on the inputs each drain's
    rounds gave it, one of each row count: exact equality of both masks.
    Returns the largest |kernel - plain|."""
    err = 0
    for rows, (nt, pb) in captured.items():
        err = max(err, check_kernel(torch, tp, nt, pb, tp.DEFAULT_EFFECTS,
                                    f"{name} round inputs, P={rows}"))
        log(f"[{name}] kernel == plain on the round's inputs P={rows} "
            f"N={nt.taint_key.shape[0]}")
    return err


def cuda_ms(torch, fn, reps=25, warm=3, runs=5) -> float:
    """Device milliseconds of one call of fn: CUDA events around reps
    calls in a row, divided by reps (so the host's time to issue a call
    overlaps the device's work on the previous one); the median of runs
    such runs, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


class PhaseClock:
    """Host wall seconds per phase of the scheduler's rounds, taken by
    wrapping the callables the scheduler calls. The device round and the
    upload are closed with a device sync, so they include device time
    (the round syncs at its fetch right after anyway)."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn, sync=None):
        def timed(*args, **kw):
            t0 = time.monotonic()
            out = fn(*args, **kw)
            if sync is not None:
                sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.monotonic() - t0)
            return out

        return timed


# --- drains ----------------------------------------------------------------------


def drain(torch, mods, name, store, caps, n_bound, statics=None,
          sync_probe=False):
    """One Scheduler(store, device="cuda").schedule_pending(), watched:
    the kernel's launch count is set to 0 just before and read just
    after; every round's live and launched kernel rows, waves, pods,
    has_ipa / has_ts and device_round seconds are recorded; the host
    seconds of each phase are summed. statics names the statics function
    of ops/kernel.py whose first call's arguments are kept for timing;
    sync_probe counts the implicit host syncs of the first ipa round
    (torch.cuda.set_sync_debug_mode("warn")); that round's seconds go to
    a phase of their own and into no per-pod or per-wave time, since the
    warnings it records cost time of their own. The bindings must hold
    every invariant of check_bindings, every round must launch the
    kernel on its live rows only, and the scheduler must report the
    card. Returns a dict of what was seen."""
    api, tp, kernel_mod, sched_mod, Scheduler = mods
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda")
    clock = PhaseClock()
    sync = torch.cuda.synchronize
    sched.featurizer.featurize = clock.wrap("featurize",
                                            sched.featurizer.featurize)
    sched.snapshot.stage_pending = clock.wrap("stage",
                                              sched.snapshot.stage_pending)
    sched.snapshot.to_device = clock.wrap("upload", sched.snapshot.to_device,
                                          sync)
    sched._commit = clock.wrap("commit", sched._commit)
    seen = {"rounds": [], "captured": {}, "statics_args": None,
            "syncs": None}
    kernel_launch = kernel_mod.taint_ports_masks
    round_fn = sched_mod.schedule_round
    statics_fn = getattr(kernel_mod, statics) if statics else None

    def capture(nt_, pb_, **kw):
        # a copy of the first inputs of each row count the rounds gave
        # the kernel (the node tensors are updated in place later)
        if pb_.tol_key.shape[0] not in seen["captured"]:
            seen["captured"][pb_.tol_key.shape[0]] = (
                nt_._replace(**{f: getattr(nt_, f).clone()
                                for f in KERNEL_NODE_FIELDS}),
                pb_._replace(**{f: getattr(pb_, f).clone()
                                for f in KERNEL_POD_FIELDS}))
        seen["rounds"][-1]["launched"] += pb_.tol_key.shape[0]
        return kernel_launch(nt_, pb_, **kw)

    def capture_statics(*args):
        if seen["statics_args"] is None:
            seen["statics_args"] = args
        return statics_fn(*args)

    def counted_round(nt_, pm_, tt_, pbs, *args, **kw):
        # the waves up to the last live one are the round's live rows
        active = pbs.valid.any(dim=1).tolist()
        n_live = max((i + 1 for i, a in enumerate(active) if a), default=0)
        rec = {"live": n_live * pbs.valid.shape[1], "launched": 0,
               "waves": n_live, "W": pbs.valid.shape[0],
               "pods": int(pbs.valid.sum()),
               "has_ipa": bool(kw.get("has_ipa")),
               "has_ts": bool(pbs.ts_valid.any()), "probed": False}
        seen["rounds"].append(rec)
        probe = sync_probe and rec["has_ipa"] and seen["syncs"] is None
        rec["probed"] = probe
        t0 = time.monotonic()
        if probe:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = round_fn(nt_, pm_, tt_, pbs, *args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            # (file:line -> count) of the Python lines that synced
            seen["syncs"] = {}
            for w in caught:
                if "synchroniz" in str(w.message):
                    where = f"{Path(w.filename).name}:{w.lineno}"
                    seen["syncs"][where] = seen["syncs"].get(where, 0) + 1
        else:
            out = round_fn(nt_, pm_, tt_, pbs, *args, **kw)
        sync()
        rec["seconds"] = time.monotonic() - t0
        phase = "sync_probe_round" if probe else "device_round"
        clock.seconds[phase] = clock.seconds.get(phase, 0.0) + rec["seconds"]
        return out

    kernel_mod.taint_ports_masks = capture
    sched_mod.schedule_round = counted_round
    if statics:
        setattr(kernel_mod, statics, capture_statics)
    tp.taint_ports_masks.launches = 0
    try:
        t0 = time.monotonic()
        placed = sched.schedule_pending()
        sync()
        wall = time.monotonic() - t0
        launches = tp.taint_ports_masks.launches
    finally:
        kernel_mod.taint_ports_masks = kernel_launch
        sched_mod.schedule_round = round_fn
        if statics:
            setattr(kernel_mod, statics, statics_fn)
    if launches < 1:
        fail(f"{name}: the rounds never launched the taint/port kernel")
    if sched.wave_path() != "cuda":
        fail(f"{name}: wave_path() is {sched.wave_path()!r}, expected "
             "'cuda'")
    bound = check_bindings(api, store)
    if bound != placed + n_bound:
        fail(f"{name}: store holds {bound} bound pods, expected "
             f"{placed + n_bound}")
    for i, r in enumerate(seen["rounds"]):
        log(f"[{name}] round {i}: pods {r['pods']}, waves {r['waves']} "
            f"(bucket {r['W']}), has_ipa {r['has_ipa']}, has_ts "
            f"{r['has_ts']}, device_round {r['seconds']:.3f} s = "
            f"{1e3 * r['seconds'] / max(r['pods'], 1):.3f} ms/pod"
            f"{' (sync probe, untimed)' if r['probed'] else ''}; live "
            f"rows {r['live']}, launched rows {r['launched']}")
        if r["launched"] != r["live"]:
            fail(f"{name}: round {i} launched the kernel on "
                 f"{r['launched']} rows, not on its {r['live']} live rows")
    phases = dict(clock.seconds)
    phases["other"] = wall - sum(phases.values())
    log(f"[{name}] placed {placed} in {wall:.3f} s = {placed / wall:.1f} "
        f"pods/s; kernel launches {launches}; invariants hold")
    log(f"[{name}] host seconds by phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()))
    seen.update(placed=placed, wall=wall, launches=launches)
    return seen


def per_pod_ms(rounds, flag):
    """Device_round ms per pod over the rounds with and without `flag`,
    the sync-probed round left out (None where no round falls in a
    group)."""
    out = {}
    for want in (True, False):
        rs = [r for r in rounds if r[flag] == want and not r["probed"]]
        pods = sum(r["pods"] for r in rs)
        out[want] = (1e3 * sum(r["seconds"] for r in rs) / pods
                     if pods else None)
    return out


def time_statics(torch, name, fn, args, rounds, flag):
    """The statics function once on one full-width wave's inputs (CUDA
    events, the median of 3 runs of 5 calls), against the mean
    device_round time of a wave in the rounds with `flag`, the
    sync-probed round left out."""
    ms = cuda_ms(torch, lambda: fn(*args), reps=5, warm=1, runs=3)
    rs = [r for r in rounds if r[flag] and not r["probed"]]
    wave_ms = (1e3 * sum(r["seconds"] for r in rs)
               / sum(r["waves"] for r in rs))
    log(f"[{name}] {fn.__name__} on one wave (P={WAVE}, N="
        f"{args[0].valid.shape[0]}, M={args[1].valid.shape[0]}): {ms:.4f} ms"
        f", {ms / wave_ms:.1%} of a {flag} wave's {wave_ms:.3f} ms "
        "device_round")
    return ms


# --- main ----------------------------------------------------------------------


def main() -> None:
    if not (REPO / "kubernetes_tpu_torch" / "__init__.py").is_file():
        fail("the kubernetes_tpu_torch package is not beside chip_smoke.py")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(REPO))
    from kubernetes_tpu_torch.api import labels as lbl
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.ops import affinity
    from kubernetes_tpu_torch.ops import encoding as enc
    from kubernetes_tpu_torch.ops import kernel as kernel_mod
    from kubernetes_tpu_torch.ops import taint_ports as tp
    from kubernetes_tpu_torch.ops import topology
    from kubernetes_tpu_torch.runtime import store as store_mod
    from kubernetes_tpu_torch.sched import scheduler as sched_mod
    from kubernetes_tpu_torch.sched.scheduler import Scheduler
    from kubernetes_tpu_torch.state.vocab import bucket_size

    mods = (api, tp, kernel_mod, sched_mod, Scheduler)
    t_start = time.monotonic()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    # 2. build
    tp.build()
    log(f"[build] {tp.build_info['library']} in "
        f"{tp.build_info['seconds']:.2f} s")
    for line in tp.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    # 3. kernel against its plain version at the main path's shapes and
    # at its edges
    int_rate, sms, mhz = int_ops_per_s(torch)
    log(f"[kernel] integer rate {int_rate / 1e12:.3f} T ops/s = {sms} SMs x "
        f"{INT32_LANES_PER_SM} INT32 lanes x {mhz:.0f} MHz (clocks.max.sm)")
    n_bucket = bucket_size(FULL_NODES)
    round_rows = WAVE * 128  # PIPELINE_MAX_WAVES waves of WAVE pods
    effects_all = {"noschedule+noexecute": tp.DEFAULT_EFFECTS,
                   "noexecute": (enc.EFFECT_NO_EXECUTE,)}
    max_err = 0
    cases = [(WAVE, FULL_NODES, {}), (round_rows, FULL_NODES, {}),
             (round_rows - 37, FULL_NODES + 3, {}), (round_rows, n_bucket, {}),
             (1000, FULL_NODES, dict(tolerations="none")),
             (1000, FULL_NODES, dict(tolerations="all", TL=8, PQ=8,
                                     port_rate=0.9)),
             (1000, FULL_NODES, dict(port_rate=0.0))]
    cases += [(P, N, kw) for P, N, kw in tp.EDGE_TABLES]
    for k, (P, N, kw) in enumerate(cases):
        nt, pb = tp.random_tables(P, N, SEED + k, **kw)
        for ename, eff in effects_all.items():
            max_err = max(max_err, check_kernel(
                torch, tp, nt, pb, eff, f"P={P}, N={N}, {kw}, {ename}"))
        plan = tp.launch_plan(nt, pb)
        log(f"[kernel] P={P} N={N} {kw or ''}: kernel == plain (both effect "
            f"sets; grid {plan['grid']}, block {plan['block']})")
    # the round's shape three ways: dense tolerations and ports (the most
    # compare work), no toleration and no port (the store path alone),
    # and a plain fill of the same two outputs (the card's write rate)
    for name, kw in (("dense", {}),
                     ("store-only", dict(tolerations="none", port_rate=0.0))):
        nt, pb = tp.random_tables(round_rows, n_bucket, SEED, **kw)
        ms = cuda_ms(torch, lambda: tp.taint_ports_masks(nt, pb))
        b_ms, b_by, nbytes, nops = kernel_bound(nt, pb, tp.DEFAULT_EFFECTS,
                                                int_rate)
        log(f"[kernel] {name} random world P={round_rows} N={n_bucket}: "
            f"kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
            f"{nops} ops)")
    outs = [torch.empty((round_rows, n_bucket), dtype=torch.bool,
                        device="cuda") for _ in range(2)]
    fill_ms = cuda_ms(torch, lambda: [o.fill_(True) for o in outs])
    log(f"[kernel] fill of the two [{round_rows}, {n_bucket}] outputs: "
        f"{fill_ms:.4f} ms = {2 * round_rows * n_bucket / fill_ms / 1e9:.3f} "
        "TB/s")
    del nt, pb, outs

    # 4. the density drain at full size
    store, n_bound = build_store(api, store_mod, FULL_NODES, FULL_PODS, SEED)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, FULL_PODS, n_bound)
    dens = drain(torch, mods, "density", store, caps, n_bound)
    if dens["placed"] < FULL_PODS // 2:
        fail(f"density: only {dens['placed']} of {FULL_PODS} pods placed")
    del store

    # the kernel and its plain version on the inputs the rounds gave it;
    # the first round's (the full round) are timed
    captured = dens.pop("captured")
    max_err = max(max_err, check_captured(torch, tp, "density", captured))
    nt, pb = next(iter(captured.values()))
    k_ms = cuda_ms(torch, lambda: tp.taint_ports_masks(nt, pb))
    p_ms = cuda_ms(torch, lambda: tp.taint_ports_plain(nt, pb), reps=3,
                   runs=3)
    k_ms2 = cuda_ms(torch, lambda: tp.taint_ports_masks(nt, pb))
    bound_ms, bound_by, nbytes, nops = kernel_bound(nt, pb,
                                                     tp.DEFAULT_EFFECTS,
                                                     int_rate)
    P, N = pb.tol_key.shape[0], nt.taint_key.shape[0]
    dims = (nt.taint_key.shape[1], pb.tol_key.shape[1], nt.ports.shape[1],
            pb.ports.shape[1])
    plan = tp.launch_plan(nt, pb)
    log(f"[kernel] round inputs (T, TL, PP, PQ) = {dims}: grid "
        f"{plan['grid']} blocks of {plan['block']} threads, "
        f"{plan['shared_bytes']} B of shared memory a block, "
        f"{plan['blocks_per_sm']} blocks an SM")
    log(f"[kernel] round inputs P={P} N={N}: kernel == plain; kernel "
        f"{k_ms:.4f} / {k_ms2:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {nops} ops), "
        f"{bound_ms / k_ms:.1%} of bound; no single PyTorch call computes "
        "this function, so no library time")
    del nt, pb, captured
    torch.cuda.empty_cache()

    # 5. card against CPU on reduced worlds of the three shapes
    worlds = {  # name -> (store maker, anti-affinity pods)
        "density": (lambda: build_store(api, store_mod, SMALL_NODES,
                                        SMALL_PODS, SEED), 0),
        "mixed": (lambda: build_mixed(api, lbl, store_mod, SMALL_NODES,
                                      SMALL_PODS),
                  SMALL_PODS - 3 * (SMALL_PODS // 4)),
        "spread": (lambda: build_spread(api, lbl, store_mod, SMALL_NODES,
                                        SMALL_PODS, SPREAD_APPS), 0),
    }
    for wname, (build, n_terms) in worlds.items():
        got = {}
        for device in ("cuda", "cpu"):
            store, n_bound = build()
            caps = scheduler_caps(enc, bucket_size, SMALL_NODES, SMALL_PODS,
                                  n_bound, n_terms)
            s = Scheduler(store, wave_size=WAVE, caps=caps, device=device)
            t0 = time.monotonic()
            n = s.schedule_pending()
            check_bindings(api, store)
            check_anti_affinity(store)
            got[device] = bindings(store)
            log(f"[parity] {wname} {device}: placed {n} in "
                f"{time.monotonic() - t0:.3f} s")
        if got["cuda"] != got["cpu"]:
            diff = [k for k in got["cpu"] if got["cpu"][k] != got["cuda"][k]]
            fail(f"{wname}: card and CPU bindings differ for {len(diff)} "
                 f"pods, e.g. {diff[:5]}")
        log(f"[parity] {wname}, {SMALL_NODES} nodes, {SMALL_PODS} pods: "
            "card == CPU bindings")

    # 6. the mixed5k drain at full width
    store, n_bound = build_mixed(api, lbl, store_mod, FULL_NODES, FULL_PODS)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, FULL_PODS, n_bound,
                          FULL_PODS - 3 * (FULL_PODS // 4))
    mixed = drain(torch, mods, "mixed", store, caps, n_bound,
                  statics="incoming_statics", sync_probe=True)
    if mixed["placed"] != FULL_PODS:
        fail(f"mixed: placed {mixed['placed']} of {FULL_PODS} pods")
    n_anti = check_anti_affinity(store)
    log(f"[mixed] {n_anti} anti-affinity pods: no two of one group share "
        "a node")
    rounds = mixed["rounds"]
    if not any(r["has_ipa"] for r in rounds):
        fail("mixed: no round ran with inter-pod affinity")
    if max(r["W"] for r in rounds) > IPA_MAX_WAVES:
        fail(f"mixed: a round ran more than {IPA_MAX_WAVES} waves")
    ms = per_pod_ms(rounds, "has_ipa")
    syncs = mixed["syncs"]
    log(f"[mixed] device_round ms per pod: with ipa {ms[True]:.3f}, without "
        f"{ms[False]:.3f}; implicit host syncs in the first ipa round: "
        f"{sum(syncs.values())} (" + ", ".join(
            f"{k} x{v}" for k, v in sorted(syncs.items())) + ")")
    time_statics(torch, "mixed", affinity.incoming_statics,
                 mixed.pop("statics_args"), rounds, "has_ipa")
    max_err = max(max_err, check_captured(torch, tp, "mixed",
                                          mixed.pop("captured")))
    del store
    torch.cuda.empty_cache()

    # 7. the spread drain
    store, n_bound = build_spread(api, lbl, store_mod, FULL_NODES,
                                  SPREAD_PODS, SPREAD_APPS)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, SPREAD_PODS,
                          n_bound)
    spread = drain(torch, mods, "spread", store, caps, n_bound,
                   statics="topo_statics")
    if spread["placed"] != SPREAD_PODS:
        fail(f"spread: placed {spread['placed']} of {SPREAD_PODS} pods")
    counts = zone_counts(store)
    worst = max(max(c.values()) - min(c.values()) for c in counts.values())
    if worst > 1 or len(counts) != SPREAD_APPS:
        fail(f"spread: a Deployment's zone counts differ by {worst}")
    log(f"[spread] {len(counts)} Deployments: zone counts differ by at most "
        f"{worst}")
    if not all(r["has_ts"] for r in spread["rounds"]):
        fail("spread: a round ran without topology spread")
    ms = per_pod_ms(spread["rounds"], "has_ts")
    log(f"[spread] device_round ms per pod with ts {ms[True]:.3f}")
    time_statics(torch, "spread", topology.topo_statics,
                 spread.pop("statics_args"), spread["rounds"], "has_ts")
    max_err = max(max_err, check_captured(torch, tp, "spread",
                                          spread.pop("captured")))
    del store
    launches = dens["launches"] + mixed["launches"] + spread["launches"]
    log(f"[smoke] kernel launches: density {dens['launches']}, mixed "
        f"{mixed['launches']}, spread {spread['launches']}; total "
        f"{time.monotonic() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "taint_ports_masks",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/taint_ports.cu",
        "replaces": "kubernetes_tpu/ops/pallas_kernels.py:41",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
