"""Batched gang (coscheduling) joint assignment.

The port of kubernetes_tpu/ops/gang.py `_schedule_gang` (:73). A gang —
the pods of one PodGroup — is useless until minMember of its pods hold
capacity at the same time, so per-pod placement deadlocks two
half-placed gangs against each other. `_wave_body` (ops/kernel.py)
already commits members greedily under SHARED capacity: each member's
resource fit sees the usage of the members placed before it. This
wrapper makes that all-or-nothing: unless the loop placed at least
`need` members (minMember minus members already bound), EVERY placement
is discarded on the device (chosen := -1, the round-robin counter
rewound), so the host never sees a partial gang.

`need` and `rr_start` are device int32 tensors, and `ok`, `chosen` and
the rr rollback are `torch.where`s on the device: nothing is read on the
host before the caller's one fetch of chosen, ok, placed and finite. On
the card the wave launches the taint/port kernel once.

The host (sched/scheduler.py `_schedule_one_gang_inner`) replays the
placement through the exact int64 recheck with group-wide rollback.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import encoding as enc
from .kernel import Weights, _wave_body


class GangResult(NamedTuple):
    ok: torch.Tensor  # bool []  placed >= need (gang admits)
    chosen: torch.Tensor  # i32 [G]  node index per member, all -1 unless ok
    placed: torch.Tensor  # i32 []  members the loop could place
    fail_counts: torch.Tensor  # i32 [Q, G]  first-fail per predicate
    masks: torch.Tensor  # bool [Q, G, N]  per-predicate pass masks
    rr_end: torch.Tensor  # i32  round-robin counter (rr_start unless ok)
    # numeric-integrity sentinel per member (ops/kernel.py
    # WaveResult.finite)
    finite: Optional[torch.Tensor] = None  # bool [G]


def schedule_gang(nt: enc.NodeTensors, pm: enc.PodMatrix,
                  tt: enc.TermTable, pb: enc.PodBatch, extra_mask,
                  rr_start, extra_scores, need, *, weights: Weights,
                  num_zones: int, num_label_values: int = 64,
                  has_ipa: bool = False, has_ts: Optional[bool] = None,
                  weight_vec=None, ts_valid_host=None) -> GangResult:
    """Joint placement of one gang's members under shared capacity.

    `need`: i32 tensor — how many members must place for the gang to
    admit. `extra_mask` / `extra_scores` are the host inputs of
    schedule_wave, applied per member. has_ts defaults to whether any
    member carries a spread constraint, read from `ts_valid_host` (the
    batch's numpy ts_valid, as the JAX entry point reads it, :63) when
    given, else from pb.ts_valid.

    Members the loop could not place keep chosen == -1 even when the
    gang admits (minMember < gang size: the surplus parks individually);
    when it does not admit, ALL members report -1 and the usage the loop
    accumulated is dropped with its carry."""
    if has_ts is None:
        src = ts_valid_host if ts_valid_host is not None else pb.ts_valid
        has_ts = bool(src.any())
    dev = nt.valid.device
    rr0 = torch.as_tensor(rr_start, dtype=torch.int32, device=dev)
    res, _usage = _wave_body(nt, pm, tt, pb, extra_mask, rr0, extra_scores,
                             weights, num_zones, num_label_values, has_ipa,
                             weight_vec=weight_vec, has_ts=has_ts)
    placed = (res.chosen >= 0).sum(dtype=torch.int32)
    ok = placed >= torch.as_tensor(need, dtype=torch.int32, device=dev)
    chosen = torch.where(ok, res.chosen, -1)
    # a failed gang consumed no capacity, so it must not advance the
    # selectHost round-robin either — replays stay deterministic
    rr_end = torch.where(ok, res.rr_end, rr0)
    return GangResult(ok=ok, chosen=chosen, placed=placed,
                      fail_counts=res.fail_counts, masks=res.masks,
                      rr_end=rr_end, finite=res.finite)
