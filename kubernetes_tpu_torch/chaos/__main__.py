"""Chaos campaign CLI of the port (a copy of kubernetes_tpu/chaos/
__main__.py, with the port's fault registry and KTPU_TORCH_FAULTPOINTS).
It runs on the CUDA card; `main(argv, device="cpu")` runs it on the CPU.

  python -m kubernetes_tpu_torch.chaos --seed 7 --schedules 50
  python -m kubernetes_tpu_torch.chaos --seed 7 --schedules 200 --budget 300
  KTPU_TORCH_FAULTPOINTS='snapshot.write=corrupt::4' \
      python -m kubernetes_tpu_torch.chaos --repro --seed 7

Exit status 0 = every schedule ran clean; 1 = at least one invariant
violation (each printed with its shrunk KTPU_TORCH_FAULTPOINTS reproducer).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.chaos",
        description="seeded fault-schedule campaign with invariant "
                    "checking and failing-schedule shrinking")
    ap.add_argument("--seed", type=int, default=0,
                    help="campaign seed (workload + schedule sampling)")
    ap.add_argument("--schedules", type=int, default=50,
                    help="fault schedules to sample and replay")
    ap.add_argument("--ticks", type=int, default=8,
                    help="virtual-clock ticks per replay")
    ap.add_argument("--budget", type=float, default=None, metavar="SECONDS",
                    help="wall-clock budget; stop sampling when exceeded")
    ap.add_argument("--repro", action="store_true",
                    help="replay ONE schedule from $KTPU_TORCH_FAULTPOINTS "
                         "against the --seed scenario (reproducer mode)")
    args = ap.parse_args(argv)

    from .campaign import replay, run_campaign

    if args.repro:
        spec = os.environ.pop("KTPU_TORCH_FAULTPOINTS", "")
        if not spec:
            print("--repro needs KTPU_TORCH_FAULTPOINTS set", file=sys.stderr)
            return 2
        out = replay((), args.seed, ticks=args.ticks, env_spec=spec,
                     device=device)
        fired = {k: v for k, v in out.injected.items() if v}
        print(f"repro seed={args.seed} spec={spec!r}: "
              f"checks={out.checks} placed={out.placed} fired={fired}")
        if out.violated:
            print(f"VIOLATION {out.violation}: {out.detail}")
            return 1
        print("clean")
        return 0

    res = run_campaign(args.seed, args.schedules, ticks=args.ticks,
                       budget_s=args.budget, log=print, device=device)
    print(f"campaign seed={res.seed}: {res.schedules} schedules, "
          f"{res.checks_total} invariant checks, "
          f"{res.injected_total} faults fired, "
          f"{len(res.findings)} violation(s)")
    for f in res.findings:
        print(f"  {f.outcome.violation}: KTPU_TORCH_FAULTPOINTS='{f.env}' "
              f"--seed {f.seed} (env re-triggers: {f.env_retriggers})")
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
