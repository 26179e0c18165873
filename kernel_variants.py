#!/usr/bin/env python3
"""Variants of the port's hand-written kernels, timed side by side on one
card.

    python3 kernel_variants.py [--only taint_ports|whatif]
        [--baseline OLD_taint_ports.cu]
        [--whatif-baseline OLD_preempt_whatif.cu]

Each variant is a kernel source of kubernetes_tpu_torch/csrc/ with one
design choice undone by a text substitution, built with nvcc for sm_90a
into kubernetes_tpu_torch/_build/variants/ (all at once, one nvcc each)
and launched through its C entries. The card's name and power limit are
printed first. Times are CUDA events around many launches in a row, the
median of 5 such runs, each variant timed twice (forward, then reverse
order). Every variant must equal the plain version on every world.

The taint/host-port kernel (csrc/taint_ports.cu; no Python wrapper in
the timed loop). Beside the variants: `floor`, a kernel that stores the
same words in the same block and row order with no staging and no
compare (what the store pattern alone costs), and a plain fill of the
two outputs. Three worlds at the round's full shape (P = 16384 pod rows,
N = 8192 nodes): `roundlike` (sparse as the smoke run's round: 1/4 of
the pods one toleration, 1/10 one host port; 3/10 of the nodes one
relevant taint, 1/10 one port), `store-only` (no toleration, no pod
port; dense node taints) and `dense` (the kernel's most compare work:
taint_ports.random_tables' defaults). --baseline adds an older version
of the kernel's source (same C entry) as the variant `baseline`.

The preemption what-if (csrc/preempt_whatif.cu): `kernel`, and the
kernel with each of its four design switches off — `all-rows` (every
row in the node lists, not only live ones), `per-pod-slots` (one class
pass per (pod, level) instead of per distinct threshold),
`scalar-stores` (the pick's stores one word at a time) and
`per-entry-loads` (the pick's slot lookups and stats loads once per
entry, not once per 4 entries of a pod's row); and `pick-2`, `pick-4`
with 2 or 4 groups of 4 entries a pick thread (one a thread in
`kernel`). Each is timed as
a whole call (row lists, slots and the two main kernels, through
ops/preempt.py's steps with the variant's library) and as its two main
kernels alone on a prebuilt row list and slot table. --whatif-baseline
adds an older source with one C entry `kpw_preempt_whatif` over a CSR of
every row (the design before the live-row lists), its CSR built as it
was built then (sort and bincount). Beside them, a fill of the [5, P, N]
output, the host syncs of one call of `kernel` and of the old CSR
build, a torch.profiler breakdown of `kernel`'s call by kernel, and each
world's bound (chip_smoke.py `whatif_bound`). Two worlds: `drain-chunk`, the preempt drain's chunk midway
(P = 128, N = 8192, M = 32768, R = 3; 5 000 nodes, 5 000 hogs at
priority 1 and 5 000 placed vips at 100, 5 000 removed rows, 17 768
free rows at node 0) and `dense` (preempt.dense_whatif at N = 2048:
110 live rows a node, L + P - 1 thresholds).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
P, N = 16384, 8192


def variants(src: str) -> dict:
    def sub(old, new):
        if old not in src:
            sys.exit(f"kernel_variants: {old!r} not in the kernel source")
        return src.replace(old, new)

    return {
        "kernel": src,
        "no-merge": sub("constexpr int MERGE_MAX = 64;",
                        "constexpr int MERGE_MAX = 0;"),
        "no-unroll": src.replace("#pragma unroll 2\n", ""),
        "2x-walkers": sub(
            "int walkers = (sms * pl.per_sm + tiles - 1) / tiles;",
            "int walkers = (2 * sms * pl.per_sm + tiles - 1) / tiles;"),
        # 8 KB more shared memory a block: 3 blocks an SM instead of 4
        "3-blocks": sub("bytes = off_ncnt + 2 * nb;",
                        "bytes = off_ncnt + 2 * nb + 8192;"),
    }


FLOOR = r'''
#include <cstdint>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256)
floor_kernel(uint8_t* a, uint8_t* b, int P, int N, int pb) {
  const int n0 = blockIdx.x * 512 + threadIdx.x * 16;
  const uint4 w = make_uint4(0x01010101u, 0x01010101u, 0x01010101u,
                             0x01010101u);
  const int chunks = (P + pb - 1) / pb;
  for (int ch = blockIdx.y; ch < chunks; ch += gridDim.y)
    for (int r = threadIdx.y; r < pb && ch * pb + r < P; r += blockDim.y) {
      const long o = (long)(ch * pb + r) * N + n0;
      __stcs(reinterpret_cast<uint4*>(a + o), w);
      __stcs(reinterpret_cast<uint4*>(b + o), w);
    }
}
extern "C" int run_floor(uint8_t* a, uint8_t* b, int P, int N, int walkers,
                         int pb) {
  floor_kernel<<<dim3(N / 512, walkers), dim3(32, 8)>>>(a, b, P, N, pb);
  return (int)cudaGetLastError();
}
'''


def build_all(nvcc: str, sources: dict, out: Path) -> dict:
    """All variants built at once, one nvcc each."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"kernel_variants: nvcc failed on {name}:\n{log}")
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
        print(f"[build] {name}: {', '.join(regs)} registers", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def roundlike(enc, seed: int):
    rng = np.random.RandomState(seed)
    T, TL, PP, PQ = 4, 4, 8, 4
    tk, tv, te = (np.zeros((N, T), np.int32) for _ in range(3))
    tainted = rng.rand(N) < 0.3
    tk[tainted, 0], tv[tainted, 0] = 7, 3
    te[tainted, 0] = np.where(rng.rand(int(tainted.sum())) < 0.8,
                              enc.EFFECT_NO_SCHEDULE, enc.EFFECT_NO_EXECUTE)
    nports = np.zeros((N, PP), np.int32)
    nports[rng.rand(N) < 0.1, 0] = 5
    pk, pv, pe = (np.zeros((P, TL), np.int32) for _ in range(3))
    po = np.full((P, TL), enc.TOL_PAD, np.int32)
    tol = rng.rand(P) < 0.25
    pk[tol, 0], pv[tol, 0], po[tol, 0] = 7, 3, enc.TOL_EQUAL
    pe[tol, 0] = enc.EFFECT_NO_SCHEDULE
    pports = np.zeros((P, PQ), np.int32)
    pports[rng.rand(P) < 0.1, 0] = 5

    def t(a):
        return torch.from_numpy(a).cuda()

    nt = enc.NodeTensors(*[None] * len(enc.NodeTensors._fields))._replace(
        taint_key=t(tk), taint_val=t(tv), taint_effect=t(te),
        ports=t(nports))
    pb = enc.PodBatch(*[None] * len(enc.PodBatch._fields))._replace(
        tol_key=t(pk), tol_val=t(pv), tol_op=t(po), tol_effect=t(pe),
        ports=t(pports))
    return nt, pb


def device_ms(fn, reps=20, runs=5) -> float:
    for _ in range(3):
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


def taint_ports_variants(args, libs_of) -> None:
    from kubernetes_tpu_torch.ops import encoding as enc
    from kubernetes_tpu_torch.ops import taint_ports as tp

    sources = variants(tp.SOURCE.read_text())
    if args.baseline is not None:
        sources["baseline"] = args.baseline.read_text()
    sources["floor"] = FLOOR
    libs = libs_of(sources, "")
    ptr = ctypes.c_void_p
    for name, lib in libs.items():
        if name == "floor":
            lib.run_floor.argtypes = [ptr, ptr] + [ctypes.c_int] * 4
        else:
            lib.ktt_taint_ports.argtypes = (
                [ptr] * 11 + [ctypes.c_int] * 6 + [ctypes.c_uint, ptr])
            if hasattr(lib, "ktt_launch_plan"):
                lib.ktt_launch_plan.argtypes = [ctypes.c_int] * 6 + [ptr]

    worlds = {
        "roundlike": roundlike(enc, 1),
        "store-only": tp.random_tables(P, N, 2, tolerations="none",
                                       port_rate=0.0),
        "dense": tp.random_tables(P, N, 3),
    }
    eff_mask = sum(1 << e for e in tp.DEFAULT_EFFECTS)
    a = torch.empty((P, N), dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    for wname, (nt, pb) in worlds.items():
        want = tp.taint_ports_plain(nt, pb)
        ins = [nt.taint_key, nt.taint_val, nt.taint_effect, nt.ports,
               pb.tol_key, pb.tol_val, pb.tol_op, pb.tol_effect, pb.ports]
        T, PP = nt.taint_key.shape[1], nt.ports.shape[1]
        TL, PQ = pb.tol_key.shape[1], pb.ports.shape[1]
        calls = {}
        for name, lib in libs.items():
            if name == "floor":
                calls[name] = lambda lib=lib: lib.run_floor(
                    a.data_ptr(), b.data_ptr(), P, N, 32, 64)
                continue
            if hasattr(lib, "ktt_launch_plan"):
                plan = (ctypes.c_int * 6)()
                lib.ktt_launch_plan(P, N, T, TL, PP, PQ, plan)
                print(f"[plan] {wname} {name}: grid {plan[0]}x{plan[1]}, "
                      f"{plan[4]} B shared, {plan[5]} blocks an SM",
                      flush=True)
            calls[name] = lambda lib=lib: lib.ktt_taint_ports(
                *[x.data_ptr() for x in ins], a.data_ptr(), b.data_ptr(), P,
                N, T, TL, PP, PQ, eff_mask, None)
        times = {name: [] for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                if calls[name]() != 0:
                    sys.exit(f"kernel_variants: {name} failed to launch")
                torch.cuda.synchronize()
                if name != "floor" and not (
                        torch.equal(a.bool(), want[0])
                        and torch.equal(b.bool(), want[1])):
                    sys.exit(f"kernel_variants: {name} != plain on {wname}")
                times[name].append(device_ms(calls[name]))
        print(f"[time] {wname} ms: " + ", ".join(
            f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in times.items()),
            flush=True)
    fill = device_ms(lambda: (a.fill_(1), b.fill_(1)))
    print(f"[time] fill of both outputs ms: {fill:.4f} = "
          f"{2 * P * N / fill / 1e9:.3f} TB/s", flush=True)


def whatif_variants(src: str) -> dict:
    def sub(old, new):
        if old not in src:
            sys.exit(f"kernel_variants: {old!r} not in the what-if source")
        return src.replace(old, new)

    def off(flag):
        return sub(f"constexpr bool {flag} = true;",
                   f"constexpr bool {flag} = false;")

    return {"kernel": src, "all-rows": off("LIVE_ROWS_ONLY"),
            "per-pod-slots": off("SHARE_SLOTS"),
            "scalar-stores": off("VECTOR_STORES"),
            "per-entry-loads": off("ROW_LOADS"),
            "pick-2": sub("constexpr int PICK_GROUPS = 1;",
                          "constexpr int PICK_GROUPS = 2;"),
            "pick-4": sub("constexpr int PICK_GROUPS = 1;",
                          "constexpr int PICK_GROUPS = 4;")}


def drain_chunk(pre, seed: int, device="cuda"):
    """The preempt drain's what-if chunk midway (see the module doc)."""
    rng = np.random.RandomState(seed)
    Pc, Nc, Mc, real = 128, 8192, 32768, 5000
    ep_node = np.zeros(Mc, np.int32)
    ep_prio = np.zeros(Mc, np.int32)
    live = np.zeros(Mc, bool)
    ep_req = np.zeros((Mc, 3), np.float32)
    # rows 0-9 999: the hogs, two a node; every other node's first hog
    # removed (its row keeps its node) and a vip placed there (rows
    # 10 000-14 999); rows past 15 000 free, at node 0
    ep_node[:10000] = np.arange(10000) // 2
    ep_prio[:10000] = 1
    live[:10000] = True
    evicted = np.arange(0, 10000, 2)
    live[evicted] = False
    ep_node[10000:15000] = ep_node[evicted]
    ep_prio[10000:15000] = 100
    live[10000:15000] = True
    ep_req[:15000, 0] = 8000
    ep_req[:15000, 1] = 2**30
    alloc = np.zeros((Nc, 3), np.float32)
    alloc[:real] = (16000, 32 * 2**30, 0)
    requested = np.zeros((Nc, 3), np.float64)
    np.add.at(requested, ep_node[live], ep_req[live].astype(np.float64))
    pod_count = np.bincount(ep_node[live], minlength=Nc).astype(np.int32)
    allowed = np.zeros(Nc, np.int32)
    allowed[:real] = 110
    levels = np.asarray(pre.victim_levels(ep_prio, live, 8), np.int32)
    pb_req = np.zeros((Pc, 3), np.float32)
    pb_req[:, 0], pb_req[:, 1] = 8000, 2**30
    pb_prio = np.full(Pc, 100, np.int32)
    static_ok = np.zeros((Pc, Nc), bool)
    static_ok[:, :real] = rng.rand(Pc, real) < 0.999
    return pre._whatif_tensors(alloc, requested.astype(np.float32),
                               pod_count, allowed, ep_node, live, ep_req,
                               ep_prio, None, levels, pb_req, pb_prio,
                               static_ok, device)


def old_csr(ep_node, N):
    """The row CSR of the what-if before the live-row lists: every row,
    sorted by max(node, 0) with a bincount for the pointers."""
    ids = ep_node.clamp(min=0)
    ids = torch.where(ids < N, ids, N)
    rows = torch.sort(ids, stable=True).indices.to(torch.int32)
    counts = torch.bincount(ids.long(), minlength=N + 1)[:N]
    row_ptr = torch.zeros((N + 1,), dtype=torch.int32, device=ep_node.device)
    row_ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return row_ptr, rows


def host_syncs(fn) -> int:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(c.message) for c in caught)


def device_breakdown(fn, reps=20) -> str:
    """Device microseconds a call by kernel name (torch.profiler's
    self device time of the device-side events over reps calls; an
    operator's own row would count its kernels twice), or a note that
    the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((us / reps, e.key[:48]))
    if not rows:
        return "the profiler saw no device time"
    rows.sort(reverse=True)
    return (f"{sum(r[0] for r in rows):.1f} us a call: "
            + ", ".join(f"{name} {us:.2f}" for us, name in rows))


def whatif_variants_main(args, libs_of) -> None:
    import chip_smoke
    from kubernetes_tpu_torch.ops import encoding as enc
    from kubernetes_tpu_torch.ops import preempt as pre

    int_rate = chip_smoke.int_ops_per_s(torch)[0]
    sources = whatif_variants(pre.SOURCE.read_text())
    if args.whatif_baseline is not None:
        sources["baseline"] = args.whatif_baseline.read_text()
    libs = libs_of(sources, "whatif-")
    ptr = ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        if name == "baseline":
            lib.kpw_preempt_whatif.argtypes = ([ptr] * 14 + [ctypes.c_int] * 5
                                               + [ptr, ptr])
        else:
            pre.bind(lib)
    worlds = {"drain-chunk": drain_chunk(pre, 1),
              "dense": pre.dense_whatif(128, 2048, 2, R=3, device="cuda")}
    for wname, w in worlds.items():
        cpu = pre.WhatIf(*[None if t is None else t.cpu() for t in w])
        want = pre.whatif_plain(cpu)
        Pw, Nw = w.static_ok.shape
        _, _, n_slots = pre.threshold_slots(cpu.levels, cpu.pb_prio)
        row_ptr, _, _ = pre.live_rows(cpu.ep_node, cpu.live, cpu.ep_req, Nw)
        bound, by, nbytes, ops = chip_smoke.whatif_bound(torch, pre, w,
                                                         int_rate)
        print(f"[whatif] {wname}: P={Pw} N={Nw} M={w.ep_node.shape[0]}, "
              f"{int(n_slots)} thresholds, {int(row_ptr[-1])} kept rows, "
              f"{int(want[0].sum())} feasible (pod, node); bound "
              f"{bound:.4f} ms ({by}: {nbytes} B, {ops} ops, chip_smoke "
              "whatif_bound)", flush=True)
        full, kernels = {}, {}
        for name, lib in libs.items():
            if name == "baseline":
                out = torch.empty((5, Pw, Nw), dtype=torch.int32,
                                  device="cuda")
                ins = [w.alloc, w.requested, w.pod_count, w.allowed_pods,
                       w.ep_req, w.ep_prio, w.live]
                tail = [w.levels, w.pb_req, w.pb_prio, w.static_ok]
                R, L = w.alloc.shape[1], w.levels.shape[0]

                def launch(csr, lib=lib, out=out, ins=ins, tail=tail, R=R,
                           L=L):
                    err = lib.kpw_preempt_whatif(
                        *[t.data_ptr() for t in ins],
                        None if w.gang_w is None else w.gang_w.data_ptr(),
                        csr[0].data_ptr(), csr[1].data_ptr(),
                        *[t.data_ptr() for t in tail], Pw, Nw, R, L,
                        enc.RES_FIXED, out.data_ptr(), stream)
                    if err:
                        sys.exit(f"kernel_variants: baseline launch {err}")
                    return out

                csr = old_csr(w.ep_node, Nw)
                full[name] = lambda launch=launch: launch(
                    old_csr(w.ep_node, Nw))
                kernels[name] = lambda launch=launch, csr=csr: launch(csr)
            else:
                prep = pre.whatif_prepare(w, lib=lib, stream=stream)
                full[name] = lambda lib=lib: pre.whatif_launch(
                    pre.whatif_prepare(w, lib=lib, stream=stream))
                kernels[name] = lambda prep=prep: pre.whatif_launch(prep)
        for label, calls in (("call", full), ("kernels", kernels)):
            times = {name: [] for name in calls}
            for order in (list(calls), list(calls)[::-1]):
                for name in order:
                    got = calls[name]()
                    torch.cuda.synchronize()
                    if not torch.equal(got.cpu(), want):
                        sys.exit(f"kernel_variants: what-if {name} != plain "
                                 f"on {wname}")
                    times[name].append(device_ms(calls[name], reps=10))
            print(f"[time] what-if {wname} {label} ms: " + ", ".join(
                f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in times.items()),
                flush=True)
        out = torch.empty((5, Pw, Nw), dtype=torch.int32, device="cuda")
        fill = device_ms(lambda: out.fill_(1))
        print(f"[time] what-if {wname}: fill of the [5, P, N] output "
              f"{fill:.4f} ms = {out.numel() * 4 / fill / 1e9:.3f} TB/s",
              flush=True)
        print(f"[profile] what-if {wname}, kernel, whole call, device us "
              f"by kernel: {device_breakdown(full['kernel'])}", flush=True)
        if wname == "drain-chunk":
            print("[sync] host syncs: one what-if call "
                  f"{host_syncs(full['kernel'])}, the old every-row CSR "
                  "build (sort + bincount) "
                  f"{host_syncs(lambda: old_csr(w.ep_node, Nw))}",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--only", choices=("taint_ports", "whatif"),
                    help="time one kernel's variants only")
    ap.add_argument("--baseline", type=Path,
                    help="an older csrc/taint_ports.cu to time beside")
    ap.add_argument("--whatif-baseline", type=Path,
                    help="an older csrc/preempt_whatif.cu to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from kubernetes_tpu_torch.ops import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)

    def libs_of(sources, prefix):
        built = build_all(cuda_build.nvcc(),
                          {prefix + k: v for k, v in sources.items()},
                          cuda_build.BUILD_DIR / "variants")
        return {k[len(prefix):]: v for k, v in built.items()}

    if args.only in (None, "taint_ports"):
        taint_ports_variants(args, libs_of)
    if args.only in (None, "whatif"):
        whatif_variants_main(args, libs_of)


if __name__ == "__main__":
    main()
