"""Chaos engineering surface of the port: continuously-checked cluster
invariants (invariants.py).

A copy of kubernetes_tpu/chaos/__init__.py's checker exports. The JAX
package's seeded fault-schedule campaign (campaign.py, `python -m
kubernetes_tpu.chaos`) drives a kubemark HollowCluster with the checker
armed after every scheduling round; the port's copy of it, with the
kubelet and proxy copies it needs, is a later slice (ROADMAP.md queue 1
item 1).
"""

from .invariants import InvariantChecker, InvariantViolation

__all__ = ["InvariantChecker", "InvariantViolation"]
