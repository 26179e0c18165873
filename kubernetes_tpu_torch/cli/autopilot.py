"""Offline autopilot tooling: train candidates, run promotion CI.

The in-process promotion pipeline (autopilot/controller.py) rides a
live scheduler; this CLI is the batch half of the loop:

    python -m kubernetes_tpu_torch.cli.autopilot train \
        --ledger /var/log/ktpu/rounds.jsonl --out candidates.json

fits the ridge trainer on a round ledger (rotated generation included)
and writes a --weight-profiles-compatible candidates JSON, and

    python -m kubernetes_tpu_torch.cli.autopilot replay \
        --profiles candidates.json [--name density] [--compare-baseline]

runs the storm trace-replay promotion CI over each candidate — the
standalone gate a deployment pipeline can run without touching a live
scheduler. Exit status is the gate verdict (0 = every replay passed),
so this IS the CI job.

A copy of kubernetes_tpu/cli/autopilot.py over the port's autopilot
modules, with the same subcommands, flags, output and exit codes. The
replays run on the CUDA card: `main(argv, device=None)` takes the
device as cli/kube_scheduler.py's `main` does (None is the card and
raises without one; tests pass device="cpu"); no flag selects it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _cmd_train(args) -> int:
    from ..autopilot.dataset import load_dataset
    from ..autopilot.trainer import RidgeTrainer
    from ..plugins.registry import default_profile

    ds = load_dataset(args.ledger)
    print(f"# ledger: {len(ds)} scored rounds, {ds.skipped} skipped, "
          f"versions {sorted(set(ds.versions))}", file=sys.stderr)
    trainer = RidgeTrainer(default_profile(None).weights(),
                           ridge_lambda=args.ridge_lambda,
                           step=args.step, min_rounds=args.min_rounds)
    try:
        weights = trainer.fit(ds)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    out = [{"name": args.name, "weights": weights, "role": "candidate"}]
    text = json.dumps(out, indent=2) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"# wrote {args.out}", file=sys.stderr)
    else:
        sys.stdout.write(text)
    return 0


def _cmd_replay(args, device=None) -> int:
    from ..autopilot.replay import run_replay
    from ..sched.weights import parse_profiles_file

    if args.profiles:
        entries = parse_profiles_file(args.profiles)
    else:
        from ..autopilot import workload_profiles_path

        entries = parse_profiles_file(workload_profiles_path())
    if args.name:
        entries = [e for e in entries if e["name"] == args.name]
        if not entries:
            print(f"error: no profile named {args.name!r}",
                  file=sys.stderr)
            return 1
    kw = dict(nodes=args.nodes, node_cpu=args.node_cpu, wave=args.wave,
              slo_scale=args.slo_scale, device=device)
    baseline = None
    if args.compare_baseline:
        baseline = run_replay(None, **kw)
        print(json.dumps(baseline.as_dict()))
    failed = 0
    for e in entries:
        rep = run_replay(dict(e.get("weights") or {}), name=e["name"],
                         **kw)
        verdict = dict(rep.as_dict())
        if baseline is not None:
            regress = rep.objective < baseline.objective - args.tolerance
            verdict["baseline_objective"] = round(baseline.objective, 4)
            if regress:
                verdict["failures"].append(
                    f"objective {rep.objective:.4f} regresses the "
                    f"static baseline {baseline.objective:.4f}")
                verdict["passed"] = False
        print(json.dumps(verdict))
        if not verdict["passed"]:
            failed += 1
    if failed:
        print(f"# {failed}/{len(entries)} candidates FAILED promotion CI",
              file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[List[str]] = None, *, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="autopilot",
        description="offline weight training + standalone promotion CI")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="fit a candidate weight table "
                                      "from a round ledger")
    tr.add_argument("--ledger", required=True,
                    help="round-ledger JSONL path (the rotated <path>.1 "
                         "generation is read too)")
    tr.add_argument("--out", default=None,
                    help="write candidates JSON here (default stdout)")
    tr.add_argument("--name", default="trained",
                    help="candidate WeightProfile name")
    tr.add_argument("--ridge-lambda", type=float, default=1.0)
    tr.add_argument("--step", type=float, default=0.5,
                    help="max fractional nudge per priority (0.5 = a "
                         "weight moves at most 50%%)")
    tr.add_argument("--min-rounds", type=int, default=4,
                    help="scored-round evidence floor for a fit")

    rp = sub.add_parser("replay", help="storm trace-replay promotion CI "
                                       "over candidate profiles")
    rp.add_argument("--profiles", default=None,
                    help="profiles JSON (default: the checked-in "
                         "per-workload table)")
    rp.add_argument("--name", default=None,
                    help="gate only this profile")
    rp.add_argument("--nodes", type=int, default=4)
    rp.add_argument("--node-cpu", default="8")
    rp.add_argument("--wave", type=int, default=16)
    rp.add_argument("--slo-scale", type=float, default=1.0,
                    help="multiply the per-class p99 gates (headroom "
                         "for slow CI hosts)")
    rp.add_argument("--compare-baseline", action="store_true",
                    help="also replay the static defaults and fail any "
                         "candidate whose objective regresses them")
    rp.add_argument("--tolerance", type=float, default=0.02,
                    help="allowed objective shortfall vs the baseline")

    args = ap.parse_args(argv)
    if args.cmd == "train":
        return _cmd_train(args)
    return _cmd_replay(args, device=device)


if __name__ == "__main__":
    sys.exit(main())
