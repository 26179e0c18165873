"""Offline weight trainers: ledger dataset -> candidate weight table.

A copy of kubernetes_tpu/autopilot/trainer.py: weights_table, Trainer,
RidgeTrainer, PolicyGradientTrainer and emit_candidate, over the port's
ops/kernel.py Weights, ops/scores.py stack_weights and WEIGHT_FIELDS and
its own fault registry (the `autopilot.train` point). The ridge fit is
numpy float64, so the same dataset gives the same table in both
packages, bit for bit.

Regression first: RidgeTrainer fits per-priority score-contribution
shares against round quality (closed-form ridge, numpy only) and turns
the coefficients into bounded multiplicative nudges of the current
weight table. A policy-gradient trainer is stubbed behind the same
interface — the seam the RL papers plug into (PAPERS.md: "Learning to
Score", RL custom scheduler) without touching the promotion pipeline.

A trainer only re-weights priorities it has EVIDENCE about (nonzero
contribution share somewhere in the dataset); everything else keeps
the base weight. Candidates are emitted as WeightProfile objects
through the store watch path (emit_candidate), so the scheduler's
informer — and the shadow observatory behind it — picks them up
exactly like an operator-applied profile.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from ..api import types as api
from ..ops.kernel import Weights
from ..ops.scores import SCORE_STACK, WEIGHT_FIELDS, stack_weights
from ..utils import faultpoints
from .dataset import LedgerDataset

# evidence floor: below this many scored rounds a fit is noise
MIN_ROUNDS = 4


def weights_table(w: Union[Weights, Dict[str, float]]) -> Dict[str, float]:
    """A Weights namedtuple (or an already-plain table) as a
    WeightProfile weights dict: tunable, nonzero rows only."""
    if isinstance(w, dict):
        return {k: float(v) for k, v in w.items()
                if WEIGHT_FIELDS.get(k) is not None and float(v)}
    vec = stack_weights(w)
    return {name: float(vec[s]) for s, name in enumerate(SCORE_STACK)
            if WEIGHT_FIELDS[name] is not None and vec[s]}


class Trainer:
    """The trainer interface: fit a dataset, return a SCORE_STACK-keyed
    candidate weight table (HostExtra never appears — it is pinned)."""

    name = "trainer"

    def __init__(self, base: Union[Weights, Dict[str, float]]):
        self.base = weights_table(base)

    def fit(self, ds: LedgerDataset) -> Dict[str, float]:
        raise NotImplementedError


class RidgeTrainer(Trainer):
    """Closed-form ridge regression of contribution shares vs quality.

    beta = (X'X + lam I)^-1 X'y over centered columns; coefficients are
    normalized to [-1, 1] and applied as bounded multiplicative nudges:
    an active priority moves by at most `step` of its base weight, and
    a priority with base weight 0 (its plane was activated by some live
    profile in the data) is introduced at `anchor * step * beta` only
    when its coefficient is positive — negative evidence about an
    inactive plane keeps it off rather than inventing a weight for it.
    """

    name = "ridge"

    def __init__(self, base: Union[Weights, Dict[str, float]],
                 ridge_lambda: float = 1.0, step: float = 0.5,
                 min_rounds: int = MIN_ROUNDS):
        super().__init__(base)
        self.ridge_lambda = float(ridge_lambda)
        self.step = float(step)
        self.min_rounds = int(min_rounds)

    def fit(self, ds: LedgerDataset) -> Dict[str, float]:
        faultpoints.fire("autopilot.train", payload=ds)
        if len(ds) < self.min_rounds:
            raise ValueError(
                f"ledger dataset has {len(ds)} scored rounds; "
                f"{self.min_rounds} required for a fit")
        names = [n for n in ds.active_priorities()
                 if WEIGHT_FIELDS[n] is not None]
        if not names:
            raise ValueError("no tunable priority has any observed "
                             "contribution in the dataset")
        idx = [SCORE_STACK.index(n) for n in names]
        X = ds.contrib[:, idx]
        X = X - X.mean(axis=0, keepdims=True)
        y = ds.quality - ds.quality.mean()
        A = X.T @ X + self.ridge_lambda * np.eye(len(idx))
        beta = np.linalg.solve(A, X.T @ y)
        bmax = float(np.max(np.abs(beta)))
        if bmax > 0:
            beta = beta / bmax
        # scale anchor for introducing a zero-base priority: the median
        # nonzero base weight keeps the new row on the table's scale
        nonzero = [v for v in self.base.values() if v > 0]
        anchor = float(np.median(nonzero)) if nonzero else 1.0
        out = dict(self.base)
        for k, n in enumerate(names):
            b = float(beta[k])
            basev = self.base.get(n, 0.0)
            if basev > 0:
                w = basev * (1.0 + self.step * b)
            elif b > 0:
                w = anchor * self.step * b
            else:
                continue
            w = max(0.0, round(w, 4))
            if w:
                out[n] = w
            else:
                out.pop(n, None)
        return out


class PolicyGradientTrainer(Trainer):
    """The RL seam: same interface, same emit path, different fit. Not
    implemented — the replay harness (autopilot/replay.py) is the
    episode generator a REINFORCE-style fit would roll out against,
    and the controller consumes its candidates unchanged."""

    name = "policy_gradient"

    def fit(self, ds: LedgerDataset) -> Dict[str, float]:
        faultpoints.fire("autopilot.train", payload=ds)
        raise NotImplementedError(
            "policy-gradient training is a stubbed seam; use "
            "RidgeTrainer (the promotion pipeline is trainer-agnostic)")


def emit_candidate(store, name: str, weights: Dict[str, float],
                   namespace: str = "default"):
    """Emit a trained weight table as a candidate WeightProfile through
    the store — the same watch path an operator-applied profile takes,
    so the scheduler's informer loads it and the shadow observatory
    starts judging it immediately. Updates in place when the profile
    already exists (a retrained candidate supersedes its old table)."""
    existing = store.get("weightprofiles", namespace, name)
    if existing is not None:
        existing.spec.weights = dict(weights)
        existing.spec.role = api.WEIGHT_PROFILE_ROLE_CANDIDATE
        return store.update("weightprofiles", existing)
    wp = api.WeightProfile(
        metadata=api.ObjectMeta(name=name, namespace=namespace),
        spec=api.WeightProfileSpec(
            weights=dict(weights),
            role=api.WEIGHT_PROFILE_ROLE_CANDIDATE))
    return store.create("weightprofiles", wp)
