#!/usr/bin/env python3
"""chip_smoke phase 20 (c)'s preemption world at several vip counts.

    python3 extender_vips.py [VIPS ...] [--device cuda|cpu] [--budget S]

For each count (16 32 64 by default): chip_smoke's `ext_hog_world` (500
nodes, each full with two bound 8-core priority-1 hogs, and VIPS pending
8-core priority-100 vips), drained through chip_smoke's in-process
extender (every verb, nodeCacheCapable false, the first candidate node
of each preemption dropped) on a virtual clock until nothing is pending,
as phase 20 (c) drains it on one device. Prints one line a count: the
drain's seconds, the passes (`schedule_pending` calls), the POSTs per
verb, the vips bound and the pods evicted. A count whose drain takes
longer than --budget seconds (default 300) ends the run. Prints the
card's name and power limit first. The default device needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("vips", nargs="*", type=int, default=[16, 32, 64])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--budget", type=float, default=300.0)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from kubernetes_tpu_torch.api import types as api
    from kubernetes_tpu_torch.ops import encoding as enc
    from kubernetes_tpu_torch.ops import taint_ports as tp
    from kubernetes_tpu_torch.plugins.registry import Registry
    from kubernetes_tpu_torch.runtime import store as store_mod
    from kubernetes_tpu_torch.sched import scheduler as sched_mod
    from kubernetes_tpu_torch.state.vocab import bucket_size
    from kubernetes_tpu_torch.utils.backoff import PodBackoff

    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("extender_vips: needs a CUDA card (or --device cpu)")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(f"[card] {smi.stdout.strip()}", flush=True)
        tp.build()
    mods = (api, tp, None, None, sched_mod, sched_mod.Scheduler, PodBackoff,
            store_mod)
    ext = cs.ScriptExtender()
    try:
        for n_vips in args.vips:
            store, caps = cs.ext_hog_world(api, store_mod, enc, bucket_size,
                                           n_vips)
            created = {p.metadata.name for p in store.list("pods")}
            clock = cs.VirtualClock()
            sched = cs.ext_sched(mods, Registry, store, caps, args.device,
                                 ext.url, clock)
            passes = [0]
            inner = sched.schedule_pending

            def counted():
                passes[0] += 1
                return inner()

            sched.schedule_pending = counted
            ext.reset()
            t0 = time.monotonic()
            cs.settle(sched, clock)
            if args.device == "cuda":
                torch.cuda.synchronize()
            s = time.monotonic() - t0
            alive = cs.bindings(store)
            bound = sum(1 for k, v in alive.items()
                        if k.startswith("vip-") and v)
            evicted = len(created - set(alive))
            print(f"[vips {n_vips}] {args.device}: {s:.3f} s, "
                  f"{passes[0]} passes, POSTs " + ", ".join(
                      f"{k} {v}" for k, v in sorted(ext.verbs().items()))
                  + f"; {bound} of {n_vips} vips bound, {evicted} evicted",
                  flush=True)
            del sched, store
            if s > args.budget:
                print(f"[vips {n_vips}] past the budget of {args.budget} s;"
                      " stopping", flush=True)
                break
    finally:
        ext.close()


if __name__ == "__main__":
    main()
