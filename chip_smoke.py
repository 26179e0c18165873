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
  4. round   — the main path at full size: Scheduler(store,
               device="cuda").schedule_pending() over 5 000 nodes and a
               30 000-pod backlog; the store's bindings must respect every
               resource, taint, host-port and nodeSelector constraint, and
               the kernel must have launched during the run, on the live
               waves' rows only (printed per round). The host time
               of each phase of the rounds is printed; then the kernel and
               its plain version are timed with CUDA events on the inputs
               the round gave the kernel, beside the kernel's bound;
  5. parity  — a reduced world of the same shape (500 nodes, 1 000 pods,
               same seed) scheduled on the card and on the CPU: identical
               bindings.
Then it prints the kernel table as one JSON line, the card's name and
power limit, and last {"ok": true, "device": {...}}.

It needs the kubernetes_tpu_torch package beside it, and a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 20261017
FULL_NODES, FULL_PODS = 5000, 30000
SMALL_NODES, SMALL_PODS = 500, 1000
WAVE = 128
# H100 SXM HBM bandwidth (NVIDIA data sheet). The kernel's compares and
# logic are 32-bit integer work: an SM has 64 INT32 lanes a clock (the
# 128 FP32 lanes, and the 67 TFLOP/s that count an FMA as two, do not
# apply), so the integer rate is SMs x 64 x the SM clock, read from the
# card at run time
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


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
                "failure-domain.beta.kubernetes.io/zone": f"zone-{i % 3}",
                "kubernetes.io/hostname": f"node-{i}"}),
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
                node_selector=({"failure-domain.beta.kubernetes.io/zone":
                                zone} if zone else {}),
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


def scheduler_caps(enc, bucket_size, n_nodes, n_pods, n_bound):
    """Pre-sized as bench.py run_config does, so no capacity grows (and
    no shape changes) mid-run."""
    return enc.Caps(M=bucket_size(n_pods + n_bound + 64), P=WAVE,
                    LV=bucket_size(n_nodes + 256, 64))


def check_bindings(api, store) -> int:
    """The invariants of a placement, read back from the store. Returns
    the number of bound pods."""
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
        labels = node.metadata.labels or {}
        for k, v in (p.spec.node_selector or {}).items():
            if labels.get(k) != v:
                fail(f"{p.metadata.name} on {name} misses nodeSelector "
                     f"{k}={v}")
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


# --- main ----------------------------------------------------------------------


def main() -> None:
    if not (REPO / "kubernetes_tpu_torch" / "__init__.py").is_file():
        fail("the kubernetes_tpu_torch package is not beside chip_smoke.py")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(REPO))
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.ops import encoding as enc
    from kubernetes_tpu_torch.ops import taint_ports as tp
    from kubernetes_tpu_torch.runtime import store as store_mod
    from kubernetes_tpu_torch.sched.scheduler import Scheduler
    from kubernetes_tpu_torch.state.vocab import bucket_size

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

    # 4. the main path at full size
    from kubernetes_tpu_torch.ops import kernel as kernel_mod
    from kubernetes_tpu_torch.sched import scheduler as sched_mod

    store, n_bound = build_store(api, store_mod, FULL_NODES, FULL_PODS, SEED)
    caps = scheduler_caps(enc, bucket_size, FULL_NODES, FULL_PODS, n_bound)
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
    captured = []
    rounds = []  # (live rows, launched rows) of each round
    kernel_launch = kernel_mod.taint_ports_masks

    def capture(nt_, pb_, **kw):
        if not captured:
            captured.append((nt_, pb_))
        rounds[-1][1] += pb_.tol_key.shape[0]
        return kernel_launch(nt_, pb_, **kw)

    kernel_mod.taint_ports_masks = capture
    round_fn = sched_mod.schedule_round
    timed_round = clock.wrap("device_round", round_fn, sync)

    def counted_round(nt_, pm_, tt_, pbs, *args, **kw):
        # the waves up to the last live one are the round's live rows
        active = pbs.valid.any(dim=1).tolist()
        n_live = max((i + 1 for i, a in enumerate(active) if a), default=0)
        rounds.append([n_live * pbs.valid.shape[1], 0])
        return timed_round(nt_, pm_, tt_, pbs, *args, **kw)

    sched_mod.schedule_round = counted_round
    tp.taint_ports_masks.launches = 0
    t0 = time.monotonic()
    placed = sched.schedule_pending()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = tp.taint_ports_masks.launches
    if launches < 1:
        fail("the round never launched the taint/port kernel")
    if sched.wave_path() != "cuda":
        fail(f"wave_path() is {sched.wave_path()!r}, expected 'cuda'")
    bound = check_bindings(api, store)
    if bound != placed + n_bound:
        fail(f"store holds {bound} bound pods, expected {placed + n_bound}")
    if placed < FULL_PODS // 2:
        fail(f"only {placed} of {FULL_PODS} pods placed")
    kernel_mod.taint_ports_masks = kernel_launch
    sched_mod.schedule_round = round_fn
    for i, (live, launched) in enumerate(rounds):
        log(f"[round] round {i}: live rows {live}, launched rows {launched}")
        if launched != live:
            fail(f"round {i} launched the kernel on {launched} rows, not on "
                 f"its {live} live rows")
    log(f"[round] {FULL_NODES} nodes, {FULL_PODS} pods: placed {placed} in "
        f"{wall:.3f} s = {placed / wall:.1f} pods/s; kernel launches "
        f"{launches}; invariants hold")
    phases = dict(clock.seconds)
    phases["other"] = wall - sum(phases.values())
    log("[round] host seconds by phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()))
    del sched, store

    # the kernel and its plain version on the inputs the round gave it
    nt, pb = captured[0]
    want = tp.taint_ports_plain(nt, pb)
    got = tp.taint_ports_masks(nt, pb)
    for g, w in zip(got, want):
        max_err = max(max_err, int((g.to(torch.int32)
                                    - w.to(torch.int32)).abs().max()))
        if not torch.equal(g, w):
            fail("kernel != plain on the round's inputs")
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
    del nt, pb, captured, got, want

    # 5. card against CPU on the reduced world
    got = {}
    for device in ("cuda", "cpu"):
        store, n_bound = build_store(api, store_mod, SMALL_NODES, SMALL_PODS,
                                     SEED)
        caps = scheduler_caps(enc, bucket_size, SMALL_NODES, SMALL_PODS,
                              n_bound)
        s = Scheduler(store, wave_size=WAVE, caps=caps, device=device)
        t0 = time.monotonic()
        n = s.schedule_pending()
        check_bindings(api, store)
        got[device] = bindings(store)
        log(f"[parity] {device}: placed {n} in "
            f"{time.monotonic() - t0:.3f} s")
    if got["cuda"] != got["cpu"]:
        diff = [k for k in got["cpu"] if got["cpu"][k] != got["cuda"][k]]
        fail(f"card and CPU bindings differ for {len(diff)} pods, e.g. "
             f"{diff[:5]}")
    log(f"[parity] {SMALL_NODES} nodes, {SMALL_PODS} pods: card == CPU "
        f"bindings; total {time.monotonic() - t_start:.1f} s")

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
