"""Round-ledger JSONL -> dense per-round feature/outcome matrices.

A copy of kubernetes_tpu/autopilot/dataset.py: load_records,
round_quality, LedgerDataset, build_dataset and load_dataset, with
SCORE_STACK from the port's ops/scores.py. numpy only, so the port's
matrices are the JAX package's bit for bit from the same files.

The offline substrate the trainer fits on. One ledger record per
scheduling round (utils/tracing.py); this module streams the file —
rotated generation ("<path>.1") first, then the live file — and builds:

  * ``features``   [R, F] round-level covariates (utilization,
    fragmentation, margin, wall seconds, placed/pending depths,
    shadow-flip counts) in FEATURES order;
  * ``contrib``    [R, S] the per-priority share of winning score
    totals (SCORE_STACK-aligned, from ``scores.breakdown``) — the
    regressors a weight table can actually act on;
  * ``quality``    [R] the scalar outcome each round is judged by
    (see round_quality).

Robustness contract (tested): unknown keys are ignored (the documented
ledger contract), records of any schema version are accepted, records
without a ``scores`` aggregate (nothing placed, autopilot transitions,
background noise) are skipped, and undecodable lines are counted in
``skipped`` — a torn final line from a crashed run or a rotation race
must never poison a training job.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..ops.scores import SCORE_STACK

# feature column order of LedgerDataset.features
FEATURES = ("util_cpu", "frag_cpu", "margin_mean", "margin_rel",
            "wall_s", "placed", "pending", "shadow_flips", "preempted")


def load_records(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Stream ledger records from `path` (and its rotated `<path>.1`
    generation, read first so rows come out oldest-first). Returns
    (records, undecodable_line_count); a missing file contributes
    nothing — a fresh cluster simply has no history yet."""
    records: List[Dict[str, Any]] = []
    skipped = 0
    for p in (path + ".1", path):
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
                else:
                    skipped += 1
    return records, skipped


def round_quality(rec: Dict[str, Any]) -> float:
    """The scalar outcome a round is judged by: packed (high
    utilization, low fragmentation), decisive (margin-over-runner-up
    relative to the score scale, so re-weighted ledgers compare), and
    fast (wall seconds, clamped so one straggler round cannot dominate
    the fit). All terms are O(1) by construction."""
    tele = rec.get("telemetry") or {}
    scores = rec.get("scores") or {}
    util = float((tele.get("util") or {}).get("cpu", 0.0))
    frag = float((tele.get("frag") or {}).get("cpu", 0.0))
    margin = float((scores.get("margin") or {}).get("mean", 0.0))
    mean_total = abs(float(scores.get("mean", 0.0)))
    margin_rel = margin / mean_total if mean_total > 0 else 0.0
    wall = min(float(rec.get("wall_s", 0.0)), 10.0)
    return util - frag + 0.1 * min(margin_rel, 1.0) - 0.01 * wall


@dataclass
class LedgerDataset:
    features: np.ndarray  # [R, len(FEATURES)] float64
    contrib: np.ndarray   # [R, len(SCORE_STACK)] per-priority share
    quality: np.ndarray   # [R] float64
    rounds: List[int] = field(default_factory=list)
    versions: List[str] = field(default_factory=list)
    skipped: int = 0      # undecodable lines + recordless rounds

    def __len__(self) -> int:
        return int(self.features.shape[0])

    def active_priorities(self) -> List[str]:
        """SCORE_STACK names with any observed contribution — the only
        rows a trainer has evidence about."""
        return [name for s, name in enumerate(SCORE_STACK)
                if np.any(self.contrib[:, s] != 0.0)]


def _row(rec: Dict[str, Any]) -> Optional[Tuple[List[float], List[float]]]:
    """One ledger record -> (feature row, contrib-share row), or None
    when the record carries no scores aggregate (nothing to learn
    from). Reads only known keys — unknown keys and versions pass
    through untouched, per the ledger contract."""
    scores = rec.get("scores")
    if not isinstance(scores, dict):
        return None
    tele = rec.get("telemetry") or {}
    margin = float((scores.get("margin") or {}).get("mean", 0.0))
    mean_total = abs(float(scores.get("mean", 0.0)))
    flips = 0
    for entry in (rec.get("shadow") or {}).values():
        if isinstance(entry, dict):
            flips += int(entry.get("flips", 0))
    feats = [
        float((tele.get("util") or {}).get("cpu", 0.0)),
        float((tele.get("frag") or {}).get("cpu", 0.0)),
        margin,
        margin / mean_total if mean_total > 0 else 0.0,
        float(rec.get("wall_s", 0.0)),
        float(rec.get("placed", 0) or 0),
        float(rec.get("pending", 0) or 0),
        float(flips),
        float(rec.get("preempted", 0) or 0),
    ]
    breakdown = scores.get("breakdown") or {}
    raw = [abs(float(breakdown.get(name, 0.0))) for name in SCORE_STACK]
    total = sum(raw)
    shares = [v / total for v in raw] if total > 0 else raw
    return feats, shares


def build_dataset(records: List[Dict[str, Any]],
                  skipped: int = 0) -> LedgerDataset:
    rows: List[List[float]] = []
    shares: List[List[float]] = []
    quality: List[float] = []
    rounds: List[int] = []
    versions: List[str] = []
    for rec in records:
        if not isinstance(rec, dict):
            skipped += 1
            continue
        parsed = _row(rec)
        if parsed is None:
            skipped += 1
            continue
        feats, share = parsed
        rows.append(feats)
        shares.append(share)
        quality.append(round_quality(rec))
        rounds.append(int(rec.get("round", 0) or 0))
        versions.append(str(rec.get("weights_version", "")))
    if rows:
        features = np.asarray(rows, np.float64)
        contrib = np.asarray(shares, np.float64)
        q = np.asarray(quality, np.float64)
    else:
        features = np.zeros((0, len(FEATURES)), np.float64)
        contrib = np.zeros((0, len(SCORE_STACK)), np.float64)
        q = np.zeros((0,), np.float64)
    return LedgerDataset(features=features, contrib=contrib, quality=q,
                         rounds=rounds, versions=versions,
                         skipped=skipped)


def load_dataset(path: str) -> LedgerDataset:
    records, skipped = load_records(path)
    return build_dataset(records, skipped=skipped)
