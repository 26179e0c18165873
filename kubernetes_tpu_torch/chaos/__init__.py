"""Chaos engineering surface of the port: continuously-checked cluster
invariants (invariants.py) and the seeded fault-schedule campaign runner
with failing-schedule shrinking (campaign.py, `python -m
kubernetes_tpu_torch.chaos`).

Copies of kubernetes_tpu/chaos/. The campaign composes the port's named
fault points (utils/faultpoints.py) into randomized fault schedules,
replays them against a kubemark HollowCluster (kubemark/hollow.py) with
the checker armed after every scheduling round, and shrinks any
violating schedule to a minimal `KTPU_TORCH_FAULTPOINTS` reproducer
string.
"""

from .campaign import (NASTY_PAIRS, SAMPLABLE, CampaignResult, FaultSpec,
                       Finding, ReplayOutcome, env_string, replay,
                       run_campaign, sample_schedule, shrink)
from .invariants import InvariantChecker, InvariantViolation

__all__ = ["InvariantChecker", "InvariantViolation",
           "SAMPLABLE", "NASTY_PAIRS", "FaultSpec", "ReplayOutcome",
           "Finding", "CampaignResult", "env_string", "sample_schedule",
           "replay", "shrink", "run_campaign"]
