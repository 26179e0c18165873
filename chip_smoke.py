#!/usr/bin/env python3
"""Smoke run of kubernetes_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device  — the card's name and power limit, the CUDA and torch versions;
  2. build   — compiles csrc/taint_ports.cu and csrc/preempt_whatif.cu
               for sm_90a from this checkout, one nvcc each, together;
  3. kernel  — the taint/host-port kernel against its plain PyTorch version
               on seeded worlds at the main path's shapes and at the
               kernel's edges (taint_ports.EDGE_TABLES; exact equality),
               then timed on a dense world, on a world with no toleration
               and no port (its store path alone), and beside a plain
               fill of the same two outputs (the card's write rate); the
               what-if kernels against their plain version run on a CPU
               copy of the same inputs (preempt.EDGE_WORLDS and two worlds
               at the drains' widths; exact equality — the plain version
               on the card sums by atomics in no fixed order), and timed
               on the dense edge world (see phase 9);
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
               on the CPU: identical bindings; then bench.py's preempt
               shape (50 nodes, 100 hogs, 100 vips) and its gangstorm
               shape (100 nodes, 48 gangs of 8, 32 high pods) on a virtual
               clock: identical bindings and victim sets; then the
               multi-key world: the reduced density world with anchor pods
               bound first, drained, then 16 pods and a gang of 4 whose
               required pod affinity spans the zone and the host key (the
               exact host path, plugins/golden.py): identical bindings,
               every multi-key pod bound where both terms hold (read back
               from the store), the host-path passes and their seconds
               printed;
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
               lines, and topo_statics timed on one full-width wave;
  8. gang    — bench.py's gangstorm shape at 5 000 nodes, P = 16: 2 400
               gangs of 8 members (4 cores, priority 1, min-available 8)
               fill 96% of the CPU slots, one dispatch a gang; then 1 600
               single 4-core pods at priority 1000 get in by preemption.
               Every high pod bound, every gang with 0 or 8 members
               bound, every victim at priority 1, evictions a multiple of
               8, every resource respected. Printed: pods/s of the fill
               and of the high pods, gang dispatches, evictions, host
               seconds by phase, each kernel's launches; the what-if
               timed on the drain's chunk (P = 16) as in phase 9;
  9. preempt — bench.py's preempt shape at 5 000 nodes, P = 128: 10 000
               priority-1 hogs of 8 cores (two a node), then 10 000
               priority-100 vips of 8 cores, each placing only by
               evicting a hog. 10 000 placed, 10 000 evicted, every
               preemption done by the pipeline. Printed: vip pods/s,
               what-if chunks and launches, host validation seconds; on
               the largest chunk, the what-if by CUDA events as a whole
               call and as its two main kernels alone (on a prebuilt row
               list and slot table) beside its bound, the host syncs of
               one call, and the plain version's ms on the CPU.
  10. trickle — bench.py trickle at 5 000 nodes (DRIVER_SUITE runs 500):
               caps as bench.py _warmed_scheduler, 64 warm pods through
               warm_pipeline and deleted, a fresh Metrics, then 2 048
               pods in chunks of 64 with schedule_pending() after each.
               Printed: pods/s, the p99 of pod_scheduling_latency and of
               e2e_scheduling_latency, rounds, launches, and the implicit
               host syncs of one more chunk's round;
  11. paced  — bench.py paced at its own shape: 5 000 nodes, 4 000 pods
               offered at 200 pods/s in chunks of 100 on the wall clock,
               then bench.py's stalled-drain loop (a stall fails the
               phase). Printed: the p99 of pod_scheduling_latency against
               the 5 s SLO and the offered rate achieved;
  12. preempt_host — bench.py run_preempt_config at its own size (50
               nodes, 100 hogs of 8 cores at priority 1, 100 vips at
               priority 100, wave 16) with device_preemption = False, on a
               virtual clock: every vip placed, 100 evictions, all hogs, no
               what-if launch; the same run with device="cpu" gives the
               same bindings and victims.
Phases 8, 9 and 12 run with PodBackoff(initial=0.001), as bench.py
run_preempt_config does. In each, one what-if input of each pod-row
count is captured and the kernel held equal to the plain version on a
CPU copy of it. Each drain sets both kernels' launch counts to 0 before
it and reads them after. Then it prints the kernel table as one JSON
line (launches of every drain), the card's name and power limit, and
last {"ok": true, "device": {...}}.

It needs the kubernetes_tpu_torch package beside it, and a CUDA card.
"""

from __future__ import annotations

import gc
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
# phase 8 (bench.py gangstorm, scaled to 5 000 nodes): gangs of 8 pods of
# 4 cores at priority 1 fill 96% of the 4 slots a node, then high pods
GANGS, GANG_SIZE, GANG_HIGH = 2400, 8, 1600
GANG_P = 16
# phase 9 (bench.py preempt at 5 000 nodes): two 8-core hogs a node, then
# as many 8-core vips
PREEMPT_VIPS = 10000
# phase 5's reduced preempt and gangstorm worlds (bench.py's own sizes)
SMALL_PREEMPT_NODES, SMALL_VIPS = 50, 100
SMALL_GANG_NODES, SMALL_GANGS, SMALL_HIGH = 100, 48, 32
# phase 5's multi-key pods: single pods and one gang, each pod with
# required pod affinity over the zone and the host
MULTIKEY_PODS, MULTIKEY_GANG = 16, 4
# phases 10 and 11 (bench.py trickle and paced; DRIVER_SUITE runs
# trickle at 500 nodes, paced at 5 000)
TRICKLE_PODS, TRICKLE_CHUNK = 2048, 64
PACED_PODS, PACED_RATE, PACED_CHUNK = 4000, 200.0, 100
PACED_SLO_S = 5.0
# phase 12 (bench.py preempt_host, its own size)
HOST_PREEMPT_NODES, HOST_PREEMPT_VIPS, HOST_PREEMPT_WAVE = 50, 100, 16
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


def batch_pod(api, name, prefix, cpu, priority, gang=None):
    """bench.py _base_pod (100m / 128Mi, controlled by an RC) with its
    CPU request set to `cpu` cores and a priority; gang: a PodGroup name,
    min-available GANG_SIZE."""
    p = api.Pod(
        metadata=api.ObjectMeta(
            name=name, labels={"type": prefix},
            owner_references=[api.OwnerReference(
                kind="ReplicationController", name=prefix,
                uid=f"rc-{prefix}", controller=True)]),
        spec=api.PodSpec(priority=priority, containers=[api.Container(
            resources=api.ResourceRequirements(
                requests=api.resource_list(cpu=str(cpu),
                                           memory="128Mi")))]))
    if gang is not None:
        p.metadata.annotations = {
            api.POD_GROUP_NAME_ANNOTATION: gang,
            api.POD_GROUP_MIN_AVAILABLE_ANNOTATION: str(GANG_SIZE)}
    return p


def add_gangs(api, store, n_gangs):
    """bench.py's gangstorm gangs: n_gangs PodGroups of GANG_SIZE members,
    4 cores each at priority 1, min-available GANG_SIZE."""
    for g in range(n_gangs):
        for j in range(GANG_SIZE):
            store.create("pods", batch_pod(api, f"gang-{g}-m{j}", "storm-low",
                                           4, 1, gang=f"gang-{g}"))


def add_singles(api, store, prefix, n, cpu, priority):
    for i in range(n):
        store.create("pods", batch_pod(api, f"{prefix}-{i}", prefix, cpu,
                                       priority))


class VirtualClock:
    """A clock that moves only when told to: backoff deadlines then fall
    at the same points of a run on the card and on the CPU."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def settle(sched, clock=None, limit=200):
    """schedule_pending until no pod is pending, stepping the virtual
    clock (or sleeping past PodBackoff(initial=0.001)) between passes;
    stops after `limit` passes in a row that place nothing. Returns pods
    placed."""
    placed = sched.schedule_pending()
    stalled = 0
    while sched.pending_count() and stalled < limit:
        if clock is not None:
            clock.t += 1.0
        else:
            time.sleep(0.002)
        n = sched.schedule_pending()
        placed += n
        stalled = stalled + 1 if n == 0 else 0
    return placed


def gang_counts(api, store):
    """gang name -> bound members, over the gang pods still in the store."""
    out = {}
    for p in store.list("pods"):
        g = api.pod_group_name(p)
        if g is not None:
            out[g] = out.get(g, 0) + bool(p.spec.node_name)
    return out


def small_world(api, store_mod, enc, bucket_size, Scheduler, PodBackoff,
                kind, device):
    """Phase 5's reduced preempt or gangstorm world on `device`, driven
    to the end on a virtual clock: (bindings, evictions)."""
    store = store_mod.ObjectStore()
    clock = VirtualClock()
    if kind == "preempt":
        nodes, arrivals = SMALL_PREEMPT_NODES, 2 * SMALL_PREEMPT_NODES + SMALL_VIPS
        caps = enc.Caps(M=bucket_size(2 * arrivals + 64), P=WAVE,
                        LV=bucket_size(nodes + 256, 64))
    else:
        nodes = SMALL_GANG_NODES
        arrivals = GANG_SIZE * SMALL_GANGS + SMALL_HIGH
        caps = enc.Caps(M=bucket_size(2 * arrivals + 64), P=GANG_P,
                        LV=bucket_size(nodes + 256, 64))
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      clock=clock, backoff=PodBackoff(initial=0.001,
                                                      clock=clock))
    add_plain_nodes(api, store, nodes)
    if kind == "preempt":
        add_singles(api, store, "hog", 2 * nodes, 8, 1)
        settle(sched, clock)
        add_singles(api, store, "vip", SMALL_VIPS, 8, 100)
    else:
        add_gangs(api, store, SMALL_GANGS)
        settle(sched, clock)
        add_singles(api, store, "high", SMALL_HIGH, 4, 1000)
    settle(sched, clock)
    check_bindings(api, store)
    return bindings(store), evictions(sched)


def whatif_bound(torch, pre, w, int_rate):
    """(least ms, what bounds it, bytes, ops) of the what-if on these
    inputs: each input read once and the [5, P, N] output written once
    over HBM bandwidth, against the integer work this run's data needs
    over the card's integer rate — the victim-class sums, for each
    distinct threshold min(level, pod priority) of the chunk and each
    node, over the node's kept rows (live, or with a non-finite request:
    2 ops a resource column and 6 a row), and the fit test (4 a column
    and 3) of each level walked, up to the one taken, for each (pod,
    node) its static predicates pass."""
    cpu = pre.WhatIf(*[None if t is None else t.cpu() for t in w])
    _, level = pre.whatif_plain(cpu, with_level=True)
    P, N = cpu.static_ok.shape
    M, R = cpu.ep_req.shape
    L = cpu.levels.shape[0]
    walked = torch.where(level < L, level + 1, L).to(torch.int64)
    walked = walked * cpu.static_ok
    row_ptr, _, _ = pre.live_rows(cpu.ep_node, cpu.live, cpu.ep_req, N)
    _, _, n_slots = pre.threshold_slots(cpu.levels, cpu.pb_prio)
    ops = (int(n_slots) * int(row_ptr[-1]) * (2 * R + 6)
           + int(walked.sum()) * (4 * R + 3))
    in_bytes = (2 * 4 * N * R + 2 * 4 * N + 4 * M * R + 4 * M + M
                + (4 * M if cpu.gang_w is not None else 0)
                + 4 * (N + 1) + 4 * M + 4 * L + 4 * P * R + 4 * P + P * N)
    out_bytes = 5 * 4 * P * N
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            in_bytes + out_bytes, ops)


def time_whatif(torch, pre, w, int_rate, tag, what):
    """The what-if on `w` timed by CUDA events two ways — the whole
    preempt_whatif call (row lists, slots, both kernels, allocations) and
    the class-stats and pick kernels alone on a prebuilt row list and
    slot table — beside its bound; the host syncs of one call counted
    with torch.cuda.set_sync_debug_mode("warn"). Returns (call ms,
    kernels ms, bound ms, what bounds it)."""
    call_ms = cuda_ms(torch, lambda: pre.preempt_whatif(w), reps=10, runs=3)
    prep = pre.whatif_prepare(w)
    kernels_ms = cuda_ms(torch, lambda: pre.whatif_launch(prep))
    del prep
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pre.preempt_whatif(w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(c.message) for c in caught)
    bound, by, nbytes, ops = whatif_bound(torch, pre, w, int_rate)
    P, N = w.static_ok.shape
    log(f"[{tag}] what-if on {what} (P={P}, N={N}, "
        f"M={w.ep_node.shape[0]}): call {call_ms:.4f} ms, kernels alone "
        f"{kernels_ms:.4f} ms, bound {bound:.4f} ms ({by}: {nbytes} B, "
        f"{ops} ops); kernels at {bound / kernels_ms:.1%} of the bound, "
        f"the call at {bound / call_ms:.1%}; {syncs} host syncs in a call")
    return call_ms, kernels_ms, bound, by


def check_whatif(torch, pre, w, what):
    """The what-if kernel on `w` (on the card) against the plain version
    on a CPU copy of it: exact equality of the packed planes, launched
    once. Returns the largest |kernel - plain| over the planes."""
    before = pre.preempt_whatif.launches
    got = pre.preempt_whatif(w)
    torch.cuda.synchronize()
    if pre.preempt_whatif.launches != before + 1:
        fail(f"the what-if kernel did not launch once ({what})")
    want = pre.whatif_plain(pre.WhatIf(*[None if t is None else t.cpu()
                                         for t in w]))
    got = got.cpu()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        bad = [i for i in range(5) if not torch.equal(got[i], want[i])]
        fail(f"what-if kernel != plain on the CPU (planes {bad}, {what})")
    return err


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


def evictions(sched) -> int:
    """Pods the scheduler's preemptions evicted (its metrics)."""
    return int(sched.metrics.pod_preemption_victims.value)


def count_syncs(torch, fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): (its result,
    {file:line -> implicit host syncs})."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{Path(w.filename).name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return out, where


class GcWatch:
    """Python's full (generation 2) garbage collections while it is
    installed: how many, and their seconds."""

    def __init__(self):
        self.count, self.seconds, self._t0 = 0, 0.0, None

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.monotonic()
        elif self._t0 is not None:
            self.count += 1
            self.seconds += time.monotonic() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def spread_line(times) -> str:
    """The first, median and slowest of per-chunk drain seconds."""
    k = max(range(len(times)), key=times.__getitem__)
    return (f"chunk drains: first {times[0]:.3f} s, median "
            f"{statistics.median(times):.3f} s, slowest {times[k]:.3f} s "
            f"(chunk {k})")


def multikey_affinity(api, lbl):
    """Required pod affinity over two topology keys, which the round
    cannot encode (the exact host path): the zone of an `app=db` pod and
    the host of a `tier=cache` pod. In the 1.11 semantics both packages
    keep (predicates.go anyPodsMatchingTopologyTerms), one bound pod must
    match both terms and share both domains with the node."""
    return api.Affinity(pod_affinity=api.PodAffinity(required=[
        api.PodAffinityTerm(label_selector=lbl.LabelSelector(
            match_labels={"app": "db"}), topology_key=ZONE),
        api.PodAffinityTerm(label_selector=lbl.LabelSelector(
            match_labels={"tier": "cache"}), topology_key=HOSTNAME)]))


def add_anchors(api, store):
    """Bound pods (100m / 128Mi) on untainted nodes: `app=db, tier=cache`
    on four, the only pods that anchor both multi-key terms, and decoys
    matching one term each on eight more."""
    free = [n.metadata.name for n in store.list("nodes") if not n.spec.taints]
    for labels, nodes in (({"app": "db", "tier": "cache"}, free[0:4]),
                          ({"app": "db"}, free[4:8]),
                          ({"tier": "cache"}, free[8:12])):
        for node in nodes:
            p = batch_pod(api, "-".join(labels.values()) + f"-{node}",
                          "anchor", "100m", None)
            p.metadata.labels = dict(labels)
            p.spec.node_name = node
            store.create("pods", p)


def add_multikey(api, lbl, store):
    """MULTIKEY_PODS single pods and one gang of MULTIKEY_GANG (its
    min-available), 100m / 128Mi each, with multikey_affinity."""
    for i in range(MULTIKEY_PODS + MULTIKEY_GANG):
        p = batch_pod(api, f"multikey-{i}", "multikey", "100m", None)
        p.spec.affinity = multikey_affinity(api, lbl)
        if i >= MULTIKEY_PODS:
            p.metadata.annotations = {
                api.POD_GROUP_NAME_ANNOTATION: "multikey-gang",
                api.POD_GROUP_MIN_AVAILABLE_ANNOTATION: str(MULTIKEY_GANG)}
        store.create("pods", p)


def check_multikey(store) -> int:
    """Every pod with required pod affinity over two topology keys is
    bound, to a node that holds its terms, read back from the store: some
    bound pod matches every term's selector and shares every term's
    domain with the node. Returns the number of such pods."""
    labels = {n.metadata.name: n.metadata.labels for n in store.list("nodes")}
    pods = store.list("pods")
    bound = [p for p in pods if p.spec.node_name]
    checked = 0
    for p in pods:
        aff = p.spec.affinity
        if aff is None or aff.pod_affinity is None:
            continue
        terms = aff.pod_affinity.required
        if len({t.topology_key for t in terms}) < 2:
            continue
        checked += 1
        if not p.spec.node_name:
            fail(f"multikey: {p.metadata.name} is not bound")
        mine = labels[p.spec.node_name]
        if not any(q is not p and all(
                q.namespace == p.namespace
                and t.label_selector.matches(q.metadata.labels)
                and mine.get(t.topology_key) is not None
                and labels[q.spec.node_name].get(t.topology_key)
                == mine.get(t.topology_key) for t in terms)
                for q in bound):
            fail(f"multikey: {p.metadata.name} on {p.spec.node_name} does "
                 "not hold its two affinity terms")
    return checked


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
    api, tp, pre, kernel_mod, sched_mod, Scheduler = mods[:6]
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
    pre.preempt_whatif.launches = 0
    try:
        t0 = time.monotonic()
        placed = sched.schedule_pending()
        sync()
        wall = time.monotonic() - t0
        launches = tp.taint_ports_masks.launches
        seen["whatif_launches"] = pre.preempt_whatif.launches
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


class Watch:
    """Phases 8 and 9: one Scheduler on the card whose host phases, gang
    dispatches and what-if chunks are timed and counted, and whose
    what-if inputs are captured (a copy of the first of each pod-row
    count) — by wrapping the callables the scheduler calls."""

    def __init__(self, torch, mods, store, caps):
        api, tp, pre, kernel_mod, sched_mod, Scheduler, PodBackoff = mods
        self.torch, self.tp, self.pre, self.sched_mod = torch, tp, pre, sched_mod
        self.sched = sched = Scheduler(store, wave_size=WAVE, caps=caps,
                                       device="cuda",
                                       backoff=PodBackoff(initial=0.001))
        self.clock = clock = PhaseClock()
        sync = torch.cuda.synchronize
        sched.featurizer.featurize = clock.wrap("featurize",
                                                sched.featurizer.featurize)
        sched.snapshot.stage_pending = clock.wrap(
            "stage", sched.snapshot.stage_pending)
        sched.snapshot.to_device = clock.wrap("upload",
                                              sched.snapshot.to_device, sync)
        sched._commit = clock.wrap("commit", sched._commit)
        sched._commit_gang = clock.wrap("commit", sched._commit_gang)
        sched._perform_preemption = self._count_preemptions(
            clock.wrap("evict", sched._perform_preemption))
        # the gang directory's scans of the cache (bound members, placed
        # gangs), each over every node's pods
        for name in ("bound_count", "placed_by_gang"):
            setattr(sched.gangs, name,
                    clock.wrap("gang_scan", getattr(sched.gangs, name)))
        # a preemption chunk's own host time — ranking the candidates of
        # each pod, skipping claimed nodes — is its time less that of the
        # phases above it ran
        chunk = sched._preempt_chunk

        def ranked_chunk(*a, **kw):
            before = sum(clock.seconds.values())
            t0 = time.monotonic()
            out = chunk(*a, **kw)
            sync()
            own = (time.monotonic() - t0
                   - (sum(clock.seconds.values()) - before))
            clock.seconds["rank"] = clock.seconds.get("rank", 0.0) + own
            return out

        sched._preempt_chunk = ranked_chunk
        self.preemptions = 0
        self.gang_dispatches = 0
        self.chunks = 0
        self.captured = {}
        self.saved = {name: getattr(sched_mod, name) for name in
                      ("schedule_round", "schedule_gang", "preemption_stats",
                       "select_victims_on_node")}
        self.saved_inputs = pre.whatif_inputs

        def gang(*a, **kw):
            self.gang_dispatches += 1
            return self.saved["schedule_gang"](*a, **kw)

        def whatif_chunk(*a, **kw):
            self.chunks += 1
            return self.saved["preemption_stats"](*a, **kw)

        def capture(*a, **kw):
            w = self.saved_inputs(*a, **kw)
            P = w.static_ok.shape[0]
            if P not in self.captured:
                self.captured[P] = pre.WhatIf(*[
                    None if t is None else t.clone() for t in w])
            return w

        sched_mod.schedule_round = clock.wrap(
            "device_round", self.saved["schedule_round"], sync)
        sched_mod.schedule_gang = clock.wrap("gang_dispatch", gang, sync)
        sched_mod.preemption_stats = clock.wrap("whatif", whatif_chunk, sync)
        sched_mod.select_victims_on_node = clock.wrap(
            "validate", self.saved["select_victims_on_node"])
        pre.whatif_inputs = capture

    def _count_preemptions(self, fn):
        def counted(*a, **kw):
            self.preemptions += 1
            return fn(*a, **kw)
        return counted

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.sched_mod, name, fn)
        self.pre.whatif_inputs = self.saved_inputs

    def stage(self, name, want):
        """Drain what is pending; returns (placed, wall seconds)."""
        t0 = time.monotonic()
        placed = settle(self.sched)
        self.torch.cuda.synchronize()
        wall = time.monotonic() - t0
        log(f"[{name}] placed {placed} in {wall:.3f} s = "
            f"{placed / wall:.1f} pods/s")
        if placed != want:
            fail(f"{name}: placed {placed}, expected {want}")
        return placed, wall

    def report(self, name, wall):
        phases = dict(self.clock.seconds)
        phases["other"] = wall - sum(phases.values())
        log(f"[{name}] host seconds by phase: " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()))


def gang_phase(torch, mods, enc, bucket_size):
    """Phase 8: the gangstorm drain at 5 000 nodes. Returns what it saw."""
    api, tp, pre = mods[0], mods[1], mods[2]
    store_mod = mods[-1]
    mods = mods[:-1]
    store = store_mod.ObjectStore()
    arrivals = GANGS * GANG_SIZE + GANG_HIGH
    caps = enc.Caps(M=bucket_size(2 * arrivals + 64), P=GANG_P,
                    LV=bucket_size(FULL_NODES + 256, 64))
    watch = Watch(torch, mods, store, caps)
    add_plain_nodes(api, store, FULL_NODES)
    add_gangs(api, store, GANGS)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    try:
        t0 = time.monotonic()
        _, fill_wall = watch.stage("gang fill", GANGS * GANG_SIZE)
        fill_dispatches = watch.gang_dispatches
        gang_launches = tp.taint_ports_masks.launches
        created = {p.metadata.name for p in store.list("pods")}
        add_singles(api, store, "high", GANG_HIGH, 4, 1000)
        # the high pods place into the free slots or by evicting gangs:
        # placed counts them and the evicted gangs' re-placements (none)
        _, high_wall = watch.stage("gang high", GANG_HIGH)
        wall = time.monotonic() - t0
        launches = tp.taint_ports_masks.launches
        whatif_launches = pre.preempt_whatif.launches
    finally:
        watch.restore()
    sched = watch.sched
    check_bindings(api, store)
    pods = {p.metadata.name: p for p in store.list("pods")}
    highs = [p for n, p in pods.items() if n.startswith("high-")]
    if len(highs) != GANG_HIGH or not all(p.spec.node_name for p in highs):
        fail("gang: a high pod is not bound")
    counts = gang_counts(api, store)
    split = {g: n for g, n in counts.items() if n not in (0, GANG_SIZE)}
    if split:
        fail(f"gang: gangs partially bound: {list(split.items())[:5]}")
    evicted = created - set(pods)
    if len(evicted) != evictions(sched):
        fail(f"gang: {len(evicted)} pods gone, {evictions(sched)} counted "
             "as evicted")
    if any(not n.startswith("gang-") for n in evicted):
        fail("gang: a victim is not a priority-1 gang member")
    if len(evicted) % GANG_SIZE:
        fail(f"gang: {len(evicted)} evictions, not a multiple of "
             f"{GANG_SIZE}")
    if launches < 1 or whatif_launches < 1:
        fail(f"gang: kernel launches {launches}, what-if launches "
             f"{whatif_launches}")
    log(f"[gang] fill: {GANGS} gangs of {GANG_SIZE} in {fill_wall:.3f} s = "
        f"{GANGS * GANG_SIZE / fill_wall:.1f} pods/s, {fill_dispatches} gang "
        f"dispatches, {gang_launches} taint/port launches; high: "
        f"{GANG_HIGH} pods in {high_wall:.3f} s = "
        f"{GANG_HIGH / high_wall:.1f} pods/s, {watch.preemptions} "
        f"preemptions ({sched.pipeline_preemptions} by the pipeline), "
        f"{len(evicted)} evictions = {len(evicted) // GANG_SIZE} whole "
        f"gangs; {len(counts)} gangs left, all whole")
    log(f"[gang] kernel launches: taint/port {launches}, what-if "
        f"{whatif_launches} in {watch.chunks} chunks; invariants hold")
    watch.report("gang", wall)
    return dict(launches=launches, whatif_launches=whatif_launches,
                captured=watch.captured)


def preempt_phase(torch, mods, enc, bucket_size):
    """Phase 9: the preempt drain at 5 000 nodes. Returns what it saw."""
    api, tp, pre = mods[0], mods[1], mods[2]
    store_mod = mods[-1]
    mods = mods[:-1]
    store = store_mod.ObjectStore()
    hogs = 2 * FULL_NODES
    caps = enc.Caps(M=bucket_size(hogs + PREEMPT_VIPS + hogs + 64), P=WAVE,
                    LV=bucket_size(FULL_NODES + 256, 64))
    watch = Watch(torch, mods, store, caps)
    add_plain_nodes(api, store, FULL_NODES)
    add_singles(api, store, "hog", hogs, 8, 1)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    try:
        t0 = time.monotonic()
        _, fill_wall = watch.stage("preempt fill", hogs)
        fill_clock = dict(watch.clock.seconds)
        watch.clock.seconds.clear()
        add_singles(api, store, "vip", PREEMPT_VIPS, 8, 100)
        _, vip_wall = watch.stage("preempt vips", PREEMPT_VIPS)
        wall = time.monotonic() - t0
        launches = tp.taint_ports_masks.launches
        whatif_launches = pre.preempt_whatif.launches
    finally:
        watch.restore()
    sched = watch.sched
    check_bindings(api, store)
    pods = {p.metadata.name: p for p in store.list("pods")}
    vips = [p for n, p in pods.items() if n.startswith("vip-")]
    if len(vips) != PREEMPT_VIPS or not all(p.spec.node_name for p in vips):
        fail("preempt: a vip is not bound")
    if evictions(sched) != PREEMPT_VIPS or len(pods) != hogs:
        fail(f"preempt: {evictions(sched)} evicted, {len(pods)} pods left; "
             f"expected {PREEMPT_VIPS} and {hogs}")
    if watch.preemptions != sched.pipeline_preemptions:
        fail(f"preempt: {watch.preemptions} preemptions, "
             f"{sched.pipeline_preemptions} by the pipeline")
    if launches < 1 or whatif_launches < 1:
        fail(f"preempt: kernel launches {launches}, what-if launches "
             f"{whatif_launches}")
    log(f"[preempt] fill: {hogs} hogs at {hogs / fill_wall:.1f} pods/s "
        f"(host seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in fill_clock.items()) + ")")
    log(f"[preempt] vips: {PREEMPT_VIPS} in {vip_wall:.3f} s = "
        f"{PREEMPT_VIPS / vip_wall:.1f} pods/s; {evictions(sched)} "
        f"evicted, {sched.pipeline_preemptions} preemptions all by the "
        f"pipeline; what-if chunks {watch.chunks}, launches "
        f"{whatif_launches}; taint/port launches {launches}; host "
        f"validation {watch.clock.seconds.get('validate', 0.0):.3f} s")
    watch.report("preempt vips", vip_wall)
    return dict(launches=launches, whatif_launches=whatif_launches,
                captured=watch.captured)


def multikey_world(api, lbl, store_mod, enc, bucket_size, Scheduler, device):
    """Phase 5's multi-key world on `device`, on a virtual clock: the
    reduced density world with its anchors bound first is drained, then
    the multi-key pods and their gang arrive and are drained through the
    exact host path. Returns (bindings, host-path pods, their seconds,
    bound pods when they arrived)."""
    store, n_bound = build_store(api, store_mod, SMALL_NODES, SMALL_PODS, SEED)
    add_anchors(api, store)
    extra = MULTIKEY_PODS + MULTIKEY_GANG + 12
    clock = VirtualClock()
    caps = scheduler_caps(enc, bucket_size, SMALL_NODES, SMALL_PODS + extra,
                          n_bound + 12)
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device=device,
                      clock=clock)
    settle(sched, clock)
    resident = sum(1 for p in store.list("pods") if p.spec.node_name)
    host = {"pods": 0, "seconds": 0.0}
    inner = sched._schedule_host_path

    def timed(pod, *a, **kw):
        t0 = time.monotonic()
        try:
            return inner(pod, *a, **kw)
        finally:
            host["pods"] += 1
            host["seconds"] += time.monotonic() - t0

    sched._schedule_host_path = timed
    add_multikey(api, lbl, store)
    settle(sched, clock)
    check_bindings(api, store)
    check_anti_affinity(store)
    if check_multikey(store) != MULTIKEY_PODS + MULTIKEY_GANG:
        fail("multikey: not every multi-key pod was checked")
    return bindings(store), host["pods"], host["seconds"], resident


def warm_up(api, store, sched, Metrics, n_pods, n_waves):
    """bench.py's warm-up: n_pods warm pods created, warm_pipeline over
    them (n_waves picks the bucket), deleted again, and a fresh Metrics."""
    warm = [batch_pod(api, f"warmup-{i}", "warmup", "100m", None)
            for i in range(n_pods)]
    for p in warm:
        store.create("pods", p)
    sched.warm_pipeline(warm, n_waves=n_waves)
    for p in warm:
        store.delete("pods", "default", p.metadata.name)
    sched.metrics = Metrics()


def warmed_scheduler(mods, enc, bucket_size, Metrics, n_nodes, extra_pods):
    """bench.py _warmed_scheduler on the card: caps sized for
    `extra_pods`, waves of WAVE, the nodes, and min(WAVE, 64) warm pods
    through warm_up (one wave). Returns (store, scheduler)."""
    api, Scheduler, store_mod = mods[0], mods[5], mods[-1]
    store = store_mod.ObjectStore()
    caps = enc.Caps(M=bucket_size(extra_pods + 64), P=WAVE,
                    LV=bucket_size(n_nodes + 256, 64))
    sched = Scheduler(store, wave_size=WAVE, caps=caps, device="cuda")
    add_plain_nodes(api, store, n_nodes)
    warm_up(api, store, sched, Metrics, min(WAVE, 64), 1)
    return store, sched


def add_chunk(api, store, prefix, first, n):
    for i in range(first, first + n):
        store.create("pods", batch_pod(api, f"{prefix}-{i}", prefix, "100m",
                                       None))


def trickle_phase(torch, mods, enc, bucket_size, Metrics):
    """Phase 10: bench.py trickle at 5 000 nodes. Returns what it saw."""
    api, tp, pre, sched_mod = mods[0], mods[1], mods[2], mods[4]
    t_phase = time.monotonic()
    store, sched = warmed_scheduler(mods, enc, bucket_size, Metrics,
                                    FULL_NODES, TRICKLE_PODS + TRICKLE_CHUNK)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    # host seconds by phase of the chunks' rounds, the first chunk's apart
    clock = PhaseClock()
    sync = torch.cuda.synchronize
    sched.featurizer.featurize = clock.wrap("featurize",
                                            sched.featurizer.featurize)
    sched.snapshot.to_device = clock.wrap("upload", sched.snapshot.to_device,
                                          sync)
    sched._commit = clock.wrap("commit", sched._commit)
    round_fn = sched_mod.schedule_round
    sched_mod.schedule_round = clock.wrap("device_round", round_fn, sync)
    placed = made = 0
    chunk_s = []
    t0 = time.monotonic()
    try:
        with GcWatch() as gcw:
            while made < TRICKLE_PODS:
                n = min(TRICKLE_CHUNK, TRICKLE_PODS - made)
                add_chunk(api, store, "trickle-pod", made, n)
                made += n
                t_chunk = time.monotonic()
                placed += sched.schedule_pending()
                chunk_s.append(time.monotonic() - t_chunk)
                if len(chunk_s) == 1:
                    first = dict(clock.seconds)
            torch.cuda.synchronize()
    finally:
        sched_mod.schedule_round = round_fn
    wall = time.monotonic() - t0
    launches = tp.taint_ports_masks.launches
    whatif_launches = pre.preempt_whatif.launches
    if placed != TRICKLE_PODS:
        fail(f"trickle: placed {placed} of {TRICKLE_PODS}")
    m = sched.metrics
    p99, p99_round = (m.pod_scheduling_latency.quantile(0.99),
                      m.e2e_scheduling_latency.quantile(0.99))
    rounds = m.e2e_scheduling_latency.total
    # one more chunk, its round run under the sync probe (left out of
    # the numbers above)
    syncs = {}

    def probed(*a, **kw):
        out, where = count_syncs(torch, lambda: round_fn(*a, **kw))
        syncs.update(where)
        return out

    sched_mod.schedule_round = probed
    try:
        add_chunk(api, store, "trickle-probe", 0, TRICKLE_CHUNK)
        probe_placed = sched.schedule_pending()
    finally:
        sched_mod.schedule_round = round_fn
    if check_bindings(api, store) != TRICKLE_PODS + probe_placed:
        fail("trickle: the store's bindings do not match the placements")
    if launches < rounds or sched.wave_path() != "cuda":
        fail(f"trickle: {launches} kernel launches in {rounds} rounds, "
             f"wave_path {sched.wave_path()!r}")
    log(f"[trickle] {FULL_NODES} nodes (DRIVER_SUITE: 500), {TRICKLE_PODS} "
        f"pods in chunks of {TRICKLE_CHUNK}: placed {placed} in {wall:.3f} s "
        f"= {placed / wall:.1f} pods/s; p99 pod_scheduling_latency "
        f"{p99:.4f} s, p99 e2e_scheduling_latency (a round) "
        f"{p99_round:.4f} s; {rounds} rounds, taint/port launches "
        f"{launches}, what-if launches {whatif_launches}; implicit host "
        f"syncs in one round: {sum(syncs.values())} (" + ", ".join(
            f"{k} x{v}" for k, v in sorted(syncs.items())) + f"); probe "
        f"chunk placed {probe_placed}; {spread_line(chunk_s)}; {gcw.count} "
        f"full garbage collections, {gcw.seconds:.3f} s; phase "
        f"{time.monotonic() - t_phase:.1f} s")
    rest = {k: v - first.get(k, 0.0) for k, v in clock.seconds.items()}
    log("[trickle] host seconds by phase, first chunk: " + ", ".join(
        f"{k} {v:.3f}" for k, v in first.items()) + "; the other "
        f"{len(chunk_s) - 1} chunks: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rest.items()))
    return dict(launches=launches, whatif_launches=whatif_launches)


def paced_phase(torch, mods, enc, bucket_size, Metrics):
    """Phase 11: bench.py paced (its own shape: 5 000 nodes, 4 000 pods
    offered at 200 pods/s in chunks of 100, on the wall clock). Returns
    what it saw."""
    api, tp, pre = mods[0], mods[1], mods[2]
    t_phase = time.monotonic()
    store, sched = warmed_scheduler(mods, enc, bucket_size, Metrics,
                                    FULL_NODES, PACED_PODS)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    interval = PACED_CHUNK / PACED_RATE
    made = placed = 0
    chunk_s = []
    t0 = time.monotonic()
    next_tick = t0
    with GcWatch() as gcw:
        while made < PACED_PODS:
            now = time.monotonic()
            if now < next_tick:
                time.sleep(next_tick - now)
            n = min(PACED_CHUNK, PACED_PODS - made)
            add_chunk(api, store, "paced-pod", made, n)
            made += n
            next_tick += interval
            t_chunk = time.monotonic()
            placed += sched.schedule_pending()
            chunk_s.append(time.monotonic() - t_chunk)
        stalled = 0
        while placed < PACED_PODS:
            time.sleep(0.002)
            n = sched.schedule_pending()
            placed += n
            # an unplaceable remainder makes no progress: fail, not spin
            stalled = stalled + 1 if n == 0 else 0
            if stalled > 2000:
                fail(f"paced: the drain stalled at {placed} of {PACED_PODS}")
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = tp.taint_ports_masks.launches
    whatif_launches = pre.preempt_whatif.launches
    if check_bindings(api, store) != PACED_PODS:
        fail("paced: the store's bindings do not match the placements")
    if launches < 1 or sched.wave_path() != "cuda":
        fail(f"paced: {launches} kernel launches, wave_path "
             f"{sched.wave_path()!r}")
    m = sched.metrics
    p99 = m.pod_scheduling_latency.quantile(0.99)
    log(f"[paced] {FULL_NODES} nodes, {PACED_PODS} pods offered at "
        f"{PACED_RATE:.0f} pods/s in chunks of {PACED_CHUNK}: placed "
        f"{placed} in {wall:.3f} s, achieved {PACED_PODS / wall:.1f} pods/s "
        f"offered; p99 pod_scheduling_latency {p99:.4f} s against the "
        f"{PACED_SLO_S:.0f} s SLO ({'met' if p99 <= PACED_SLO_S else 'MISSED'}"
        f"); p50 {m.pod_scheduling_latency.quantile(0.5):.4f} s, max "
        f"{m.pod_scheduling_latency.max:.4f} s; "
        f"{m.e2e_scheduling_latency.total} rounds, taint/port launches "
        f"{launches}, what-if launches {whatif_launches}; "
        f"{spread_line(chunk_s)}; {gcw.count} full garbage collections, "
        f"{gcw.seconds:.3f} s; phase {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, whatif_launches=whatif_launches)


def preempt_host_world(mods, enc, bucket_size, Metrics, device):
    """Phase 12's run on `device`: bench.py run_preempt_config at its own
    size with device_preemption = False — 50 nodes, 100 hogs of 8 cores at
    priority 1, a warm-up, then 100 vips of 8 cores at priority 100, wave
    16, PodBackoff(initial=0.001), on a virtual clock stepped 2 ms between
    passes. Returns (bindings, evicted names, vip wall seconds, taint/port
    launches, what-if launches, scheduler) of the vips' drain."""
    api, tp, pre, Scheduler, PodBackoff = (mods[0], mods[1], mods[2],
                                           mods[5], mods[6])
    store_mod = mods[-1]
    clock = VirtualClock()
    nodes, vips, wave = (HOST_PREEMPT_NODES, HOST_PREEMPT_VIPS,
                         HOST_PREEMPT_WAVE)
    store = store_mod.ObjectStore()
    caps = enc.Caps(M=bucket_size(2 * nodes + vips + 64), P=wave,
                    LV=bucket_size(nodes + 256, 64))
    sched = Scheduler(store, wave_size=wave, caps=caps, device=device,
                      clock=clock, backoff=PodBackoff(initial=0.001,
                                                      clock=clock))
    sched.device_preemption = False
    add_plain_nodes(api, store, nodes)
    add_singles(api, store, "hog", 2 * nodes, 8, 1)
    if settle(sched, clock) != 2 * nodes:
        fail("preempt_host: the hogs did not all place")
    warm_up(api, store, sched, Metrics, wave, min(-(-vips // wave), 128))
    created = {p.metadata.name for p in store.list("pods")}
    add_singles(api, store, "vip", vips, 8, 100)
    tp.taint_ports_masks.launches = 0
    pre.preempt_whatif.launches = 0
    t0 = time.monotonic()
    done = sched.schedule_pending()
    stalled = 0
    while done < vips:
        clock.t += 0.002
        n = sched.schedule_pending()
        done += n
        stalled = stalled + 1 if n == 0 else 0
        if stalled > 2000:
            fail(f"preempt_host ({device}): stalled at {done} of {vips}")
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_bindings(api, store)
    evicted = sorted(created - {p.metadata.name for p in store.list("pods")})
    return (bindings(store), evicted, wall, tp.taint_ports_masks.launches,
            pre.preempt_whatif.launches, sched)


def preempt_host_phase(torch, mods, enc, bucket_size, Metrics):
    """Phase 12: the preempt_host shape on the card, then on the CPU."""
    t_phase = time.monotonic()
    got, wall, launches, whatif_launches, sched = {}, 0.0, 0, 0, None
    for device in ("cuda", "cpu"):
        b, evicted, w, tl, wl, s = preempt_host_world(
            mods, enc, bucket_size, Metrics, device)
        got[device] = (b, evicted)
        if device == "cuda":
            wall, launches, whatif_launches, sched = w, tl, wl, s
    binds, evicted = got["cuda"]
    vips = [n for n in binds if n.startswith("vip-")]
    if len(vips) != HOST_PREEMPT_VIPS or not all(binds[n] for n in vips):
        fail("preempt_host: a vip is not bound")
    if len(evicted) != HOST_PREEMPT_VIPS or evictions(sched) != len(evicted):
        fail(f"preempt_host: {len(evicted)} pods gone, {evictions(sched)} "
             f"counted as evicted; expected {HOST_PREEMPT_VIPS}")
    if not all(n.startswith("hog-") for n in evicted):
        fail("preempt_host: a victim is not a priority-1 hog")
    if whatif_launches != 0 or launches < 1:
        fail(f"preempt_host: what-if launches {whatif_launches} (expected "
             f"0), taint/port launches {launches}")
    if got["cuda"] != got["cpu"]:
        a, b = got["cuda"][0], got["cpu"][0]
        diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        fail(f"preempt_host: card and CPU differ (pods {diff[:5]})")
    log(f"[preempt_host] {HOST_PREEMPT_NODES} nodes, wave "
        f"{HOST_PREEMPT_WAVE}, device_preemption False: {HOST_PREEMPT_VIPS} "
        f"vips in {wall:.3f} s = {HOST_PREEMPT_VIPS / wall:.1f} pods/s; "
        f"{len(evicted)} evicted, all hogs; {sched.pipeline_preemptions} "
        f"pipeline preemptions; what-if launches {whatif_launches}, "
        f"taint/port launches {launches}; card == CPU bindings and victim "
        f"sets; phase {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, whatif_launches=whatif_launches)


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
    from kubernetes_tpu_torch.ops import preempt as pre
    from kubernetes_tpu_torch.ops import taint_ports as tp
    from kubernetes_tpu_torch.ops import topology
    from kubernetes_tpu_torch.runtime import store as store_mod
    from kubernetes_tpu_torch.sched import scheduler as sched_mod
    from kubernetes_tpu_torch.sched.scheduler import Scheduler
    from kubernetes_tpu_torch.state.vocab import bucket_size
    from kubernetes_tpu_torch.utils.backoff import PodBackoff
    from kubernetes_tpu_torch.utils.metrics import Metrics

    mods = (api, tp, pre, kernel_mod, sched_mod, Scheduler)
    phase_mods = mods + (PodBackoff, store_mod)
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

    # 2. build: one nvcc for each source, started together
    import threading

    errors = []

    def build(mod):
        try:
            mod.build()
        except Exception as e:  # reported below, and the run fails
            errors.append(f"{mod.SOURCE.name}: {e}")

    t_build = time.monotonic()
    threads = [threading.Thread(target=build, args=(m,)) for m in (tp, pre)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail("kernel build failed: " + "; ".join(errors))
    log(f"[build] both kernels in {time.monotonic() - t_build:.2f} s")
    for mod in (tp, pre):
        log(f"[build] {mod.build_info['library']} in "
            f"{mod.build_info['seconds']:.2f} s")
        for line in mod.build_info["log"].splitlines():
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
    cases = [(WAVE, FULL_NODES, {}), (GANG_P, n_bucket, {}),
             (round_rows, FULL_NODES, {}),
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
    # the what-if kernel against its plain version on a CPU copy, at its
    # edges and at the drains' widths
    whatif_err = 0
    for P, N, M, kw in pre.EDGE_WORLDS + (
            (WAVE, n_bucket, 32768, dict(large=True)),
            (GANG_P, n_bucket, 65536, {})):
        w = pre.random_whatif(P, N, M, seed=SEED + P + N, **kw)
        whatif_err = max(whatif_err, check_whatif(
            torch, pre, w, f"P={P}, N={N}, M={M}, {kw}"))
        log(f"[kernel] what-if P={P} N={N} M={M} {kw or ''}: kernel == "
            "plain on the CPU")
    P, N, M, kw = next(e for e in pre.EDGE_WORLDS if e[3].get("dense"))
    w = pre.random_whatif(P, N, M, seed=SEED + P + N, **kw)
    time_whatif(torch, pre, w, int_rate, "kernel", "the dense edge world")
    del w

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
    for wname in ("preempt", "gangstorm"):
        got = {}
        for device in ("cuda", "cpu"):
            t0 = time.monotonic()
            got[device] = small_world(api, store_mod, enc, bucket_size,
                                      Scheduler, PodBackoff, wname, device)
            log(f"[parity] {wname} {device}: "
                f"{sum(1 for v in got[device][0].values() if v)} bound, "
                f"{got[device][1]} evicted in "
                f"{time.monotonic() - t0:.3f} s")
        if got["cuda"] != got["cpu"]:
            a, b = got["cuda"][0], got["cpu"][0]
            diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
            fail(f"{wname}: card and CPU differ (evicted {got['cuda'][1]} / "
                 f"{got['cpu'][1]}; pods {diff[:5]})")
        if not got["cuda"][1]:
            fail(f"{wname}: nothing was evicted")
        log(f"[parity] {wname}: card == CPU bindings and victim sets")
    t_new = time.monotonic()
    got = {}
    for device in ("cuda", "cpu"):
        t0 = time.monotonic()
        got[device] = multikey_world(api, lbl, store_mod, enc, bucket_size,
                                     Scheduler, device)
        _, n_host, host_s, resident = got[device]
        log(f"[parity] multikey {device}: {n_host} host-path passes in "
            f"{host_s:.3f} s = {host_s / max(n_host, 1):.3f} s a pass, "
            f"{resident} bound pods on {SMALL_NODES} nodes; world "
            f"{time.monotonic() - t0:.3f} s")
    if got["cuda"][0] != got["cpu"][0]:
        a, b = got["cuda"][0], got["cpu"][0]
        diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        fail(f"multikey: card and CPU bindings differ, e.g. {diff[:5]}")
    log(f"[parity] multikey, {SMALL_NODES} nodes, {SMALL_PODS} density pods "
        f"then {MULTIKEY_PODS} pods and a gang of {MULTIKEY_GANG} with "
        "required pod affinity over zone and host: card == CPU bindings, "
        "every multi-key pod bound where both terms hold")
    t_new = time.monotonic() - t_new

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
    torch.cuda.empty_cache()

    # 8. the gangstorm drain
    gang = gang_phase(torch, phase_mods, enc, bucket_size)
    captured = gang.pop("captured")
    for P, w in sorted(captured.items()):
        whatif_err = max(whatif_err, check_whatif(
            torch, pre, w, f"gang drain input, P={P}"))
        log(f"[gang] what-if kernel == plain on the drain's input P={P} "
            f"N={w.static_ok.shape[1]} M={w.ep_node.shape[0]}")
    time_whatif(torch, pre, captured[max(captured)], int_rate, "gang",
                "the drain's chunk")
    del captured
    torch.cuda.empty_cache()

    # 9. the preempt drain
    prem = preempt_phase(torch, phase_mods, enc, bucket_size)
    captured = prem.pop("captured")
    for P, w in sorted(captured.items()):
        whatif_err = max(whatif_err, check_whatif(
            torch, pre, w, f"preempt drain input, P={P}"))
        log(f"[preempt] what-if kernel == plain on the drain's input P={P}")
    w = captured[max(captured)]
    w_ms, w_kernels_ms, w_bound, w_by = time_whatif(
        torch, pre, w, int_rate, "preempt", "the drain's chunk")
    cpu_w = pre.WhatIf(*[None if t is None else t.cpu() for t in w])
    t0 = time.monotonic()
    pre.whatif_plain(cpu_w)
    w_plain_ms = 1e3 * (time.monotonic() - t0)
    log(f"[preempt] what-if plain version on the CPU {w_plain_ms:.1f} ms; "
        "no single PyTorch call computes this function, so no library "
        "time")
    del w, cpu_w, captured
    torch.cuda.empty_cache()

    # 10-12. the rest of bench.py's DRIVER_SUITE
    t0 = time.monotonic()
    trickle = trickle_phase(torch, phase_mods, enc, bucket_size, Metrics)
    paced = paced_phase(torch, phase_mods, enc, bucket_size, Metrics)
    phost = preempt_host_phase(torch, phase_mods, enc, bucket_size, Metrics)
    t_new += time.monotonic() - t0
    drains = {"density": dens, "mixed": mixed, "spread": spread,
              "gang": gang, "preempt": prem, "trickle": trickle,
              "paced": paced, "preempt_host": phost}
    launches = sum(d["launches"] for d in drains.values())
    whatif_launches = sum(d["whatif_launches"] for d in drains.values())
    log("[smoke] taint/port kernel launches: " + ", ".join(
        f"{k} {d['launches']}" for k, d in drains.items())
        + "; what-if kernel launches: " + ", ".join(
        f"{k} {d['whatif_launches']}" for k, d in drains.items())
        + f"; phases of this slice (multikey, trickle, paced, preempt_host) "
        f"{t_new:.1f} s; total {time.monotonic() - t_start:.1f} s")

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
    }, {
        "name": "preempt_whatif",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/preempt_whatif.cu",
        "replaces": "kubernetes_tpu/ops/preempt.py:85",
        "launches": whatif_launches,
        "max_abs_err": whatif_err,
        "ms": w_ms,
        "kernels_ms": w_kernels_ms,
        "plain_ms": w_plain_ms,
        "bound_ms": w_bound,
        "bound_by": w_by,
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
