"""Scheduler autopilot: offline weight training + gated auto-promotion.

A copy of kubernetes_tpu/autopilot/__init__.py (the same lazy exports
and workload_profiles_path(), whose JSON is a byte-for-byte copy). The
replay CI and the controller's gates run the port's scheduling round on
the live scheduler's device.

The closing of the learned-scoring loop the earlier subsystems built
the rails for: the round ledger (utils/tracing.py) is the dataset, the
shadow-scoring observatory (sched/weights.py) is the live-traffic
judge, the storm harness's SLO gates (bench.py) are the promotion CI,
and the live WeightProfile hot swap is the actuator. Pipeline:

  ledger JSONL --dataset--> feature/outcome matrices
               --trainer--> candidate WeightProfile (store watch path)
               --controller--> shadow gate -> replay CI -> promote live
                              -> regression watch (auto-rollback)

Every transition is ledgered (kind "autopilot"), metered
(scheduler_autopilot_promotions_total{outcome}), and served from the
kube-scheduler HealthServer at /debug/autopilot.
"""

# Lazy re-exports (PEP 562): the trainer/controller modules pull the
# ops stack (and with it torch), but CLI entry points only need the
# light replay-gate constants at import time — resolving submodules on
# first attribute access keeps `--help` torch-free.
_EXPORTS = {
    "AutopilotConfig": "controller", "AutopilotController": "controller",
    "OUTCOMES": "controller",
    "LedgerDataset": "dataset", "build_dataset": "dataset",
    "load_dataset": "dataset", "load_records": "dataset",
    "STORM_PRIORITY": "replay", "STORM_SLO_P99": "replay",
    "ReplayReport": "replay", "run_replay": "replay",
    "PolicyGradientTrainer": "trainer", "RidgeTrainer": "trainer",
    "Trainer": "trainer", "emit_candidate": "trainer",
}

__all__ = sorted(_EXPORTS) + ["workload_profiles_path"]


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)


def workload_profiles_path() -> str:
    """The checked-in hand-tuned per-workload weight table (density /
    trickle / gang / storm) — a standard --weight-profiles JSON, also
    the autopilot's seed candidate pool."""
    import os

    return os.path.join(os.path.dirname(__file__),
                        "workload_profiles.json")
