#!/usr/bin/env python3
"""Variants of the taint/host-port kernel, timed side by side on one card.

    python3 kernel_variants.py [--baseline OLD_taint_ports.cu]

Each variant is kubernetes_tpu_torch/csrc/taint_ports.cu with one design
choice undone by a text substitution, built with nvcc for sm_90a into
kubernetes_tpu_torch/_build/variants/ and launched through its C entry
(no Python wrapper in the timed loop). Beside them: `floor`, a kernel
that stores the same words in the same block and row order with no
staging and no compare (what the store pattern alone costs), and a
plain fill of the two outputs. Three worlds at the round's full shape
(P = 16384 pod rows, N = 8192 nodes): `roundlike` (sparse as the smoke
run's round: 1/4 of the pods one toleration, 1/10 one host port; 3/10 of
the nodes one relevant taint, 1/10 one port), `store-only` (no
toleration, no pod port; dense node taints) and `dense` (the kernel's
most compare work: taint_ports.random_tables' defaults). Every variant
must equal the plain version on every world. Times are CUDA events
around 20 launches in a row, the median of 5 such runs, each variant
timed twice (forward, then reverse order); the card's name and power
limit are printed first. --baseline adds an older version of the
kernel's source (same C entry) as the variant `baseline`, to compare
two versions in one run.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="an older csrc/taint_ports.cu to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from kubernetes_tpu_torch.ops import encoding as enc
    from kubernetes_tpu_torch.ops import taint_ports as tp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    sources = variants(tp.SOURCE.read_text())
    if args.baseline is not None:
        sources["baseline"] = args.baseline.read_text()
    sources["floor"] = FLOOR
    libs = build_all(tp._nvcc(), sources, tp.BUILD_DIR / "variants")
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


if __name__ == "__main__":
    main()
