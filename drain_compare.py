#!/usr/bin/env python3
"""The smoke world's drain, timed for two checkouts in turns on one card.

    python3 drain_compare.py TREE_A TREE_B [--pairs 5]

Each TREE is a checkout of this repo (for example one unpacked with
`git archive`). Every drain runs in a fresh process that imports TREE's
own kubernetes_tpu_torch and chip_smoke.py, builds the 5 000-node /
30 000-pod world from chip_smoke's seed and runs
`Scheduler(device="cuda").schedule_pending()` once. Pairs alternate
which tree goes first (A B, B A, ...), so drift of the host over the
call falls on both. Prints one line a drain (pods/s, host seconds in
`schedule_round`), then each tree's median and quartiles and how many
pairs each won. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def drain(tree: Path) -> dict:
    """One drain with tree's package (run in a child process)."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.ops import encoding as enc
    from kubernetes_tpu_torch.ops import taint_ports as tp
    from kubernetes_tpu_torch.runtime import store as store_mod
    from kubernetes_tpu_torch.sched import scheduler as sched_mod
    from kubernetes_tpu_torch.state.vocab import bucket_size

    if not torch.cuda.is_available():
        sys.exit("drain_compare: needs a CUDA card")
    tp.build()
    store, n_bound = cs.build_store(api, store_mod, cs.FULL_NODES,
                                    cs.FULL_PODS, cs.SEED)
    caps = cs.scheduler_caps(enc, bucket_size, cs.FULL_NODES, cs.FULL_PODS,
                             n_bound)
    sched = sched_mod.Scheduler(store, wave_size=cs.WAVE, caps=caps,
                                device="cuda")
    clock = cs.PhaseClock()
    sched_mod.schedule_round = clock.wrap(
        "device_round", sched_mod.schedule_round, torch.cuda.synchronize)
    t0 = time.monotonic()
    placed = sched.schedule_pending()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if placed != cs.FULL_PODS:
        sys.exit(f"drain_compare: placed {placed} of {cs.FULL_PODS}")
    return dict(pods_per_s=placed / wall, wall_s=wall,
                device_round_s=clock.seconds["device_round"])


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return q[0], statistics.median(xs), q[2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(drain(args.one.resolve())), flush=True)
        return
    if len(args.trees) != 2:
        ap.error("give two trees")
    import torch

    if not torch.cuda.is_available():
        sys.exit("drain_compare: needs a CUDA card")
    a, b = (t.resolve() for t in args.trees)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[card] {smi.stdout.strip()}", flush=True)
    runs = {a: [], b: []}
    wins = {a: 0, b: 0}
    for i in range(args.pairs):
        pair = {}
        for tree in ((a, b) if i % 2 == 0 else (b, a)):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--one",
                 str(tree)], capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"drain_compare: drain of {tree} failed:\n"
                         f"{proc.stdout}{proc.stderr}")
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            pair[tree] = r["pods_per_s"]
            runs[tree].append(r)
            print(f"[drain] pair {i} {tree.name}: {r['pods_per_s']:.1f} "
                  f"pods/s, {r['wall_s']:.3f} s, schedule_round "
                  f"{r['device_round_s']:.3f} s", flush=True)
        if pair[a] != pair[b]:
            wins[max(pair, key=pair.get)] += 1
    for tree in (a, b):
        lo, med, hi = quartiles([r["pods_per_s"] for r in runs[tree]])
        print(f"[summary] {tree.name}: median {med:.1f} pods/s "
              f"(quartiles {lo:.1f}-{hi:.1f}), won {wins[tree]} of "
              f"{args.pairs} pairs", flush=True)


if __name__ == "__main__":
    main()
