"""Per-zone node health tally as a batched reduction.

The port of kubernetes_tpu/ops/zonehealth.py. Reference:
pkg/controller/nodelifecycle/node_lifecycle_controller.go
ComputeZoneState — for every failure domain (the GetZoneKey string),
count ready vs not-ready nodes and classify the zone Normal /
PartialDisruption / FullDisruption. Here the tally is two integer
segment sums over dense columns (interned zone ids, a bad flag and a
valid flag a node row), and the classification rides whichever compute
path is healthy:

  device  one upload of the three columns, two int32 `index_add_`s on
          the requested device, one fetch of both counts. Integer
          atomics are exact, so the card's sums equal the host's in any
          order.
  host    np.bincount — taken when the device-path circuit breaker
          (sched/breaker.py) is open, or when the device call fails
          (which also feeds the breaker). Zone health is the input to
          eviction storm control; computing it can never be allowed to
          fail just because an accelerator is wedged.

A device failure must not pass quietly: it is logged with its exception
and counted in TALLY_COUNTS beside the tallies each path took. The
`nodelifecycle.tally` fault point fires at the head of the device path
(a `raise` there is a device failure like any other).
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from ..utils import faultpoints
from . import encoding as enc

LOG = logging.getLogger(__name__)

# tallies by the path that answered them, and device calls that failed
# (each of those was answered by the host)
TALLY_COUNTS = {"device": 0, "host": 0, "device_failures": 0}


def reset_counts() -> None:
    for k in TALLY_COUNTS:
        TALLY_COUNTS[k] = 0


def _tally_device(zone_id: np.ndarray, bad: np.ndarray, valid: np.ndarray,
                  num_zones: int, device: torch.device
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(totals, bad counts) i32 [num_zones] from zone_id i32, bad and
    valid bool, each [cap], summed on `device` (kubernetes_tpu/ops/
    zonehealth.py:38 _tally_device): the three columns go up as one
    i32 [3, cap] array and both counts come back in one fetch."""
    cols = np.stack([np.asarray(zone_id, np.int32),
                     np.asarray(valid, bool).astype(np.int32),
                     np.asarray(bad, bool).astype(np.int32)])
    t = torch.from_numpy(cols).to(device)
    idx = t[0].long()
    out = torch.zeros((2, num_zones), dtype=torch.int32, device=device)
    out[0].index_add_(0, idx, t[1])
    out[1].index_add_(0, idx, t[1] * t[2])
    host = out.cpu().numpy()
    return host[0], host[1]


def zone_tally_host(zone_id: np.ndarray, bad: np.ndarray, valid: np.ndarray,
                    num_zones: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host formulation of the same reduction (np.bincount)."""
    zid = np.asarray(zone_id, np.int64)
    v = np.asarray(valid, bool)
    b = np.asarray(bad, bool) & v
    totals = np.bincount(zid[v], minlength=num_zones)
    badc = np.bincount(zid[b], minlength=num_zones)
    return totals.astype(np.int32), badc.astype(np.int32)


def zone_tally(zone_id: np.ndarray, bad: np.ndarray, valid: np.ndarray,
               num_zones: int, breaker=None, device=None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(totals[Z], bad_counts[Z]) per interned zone id. Device path on
    `device` (None: the CUDA card) when the breaker admits it, host
    fallback otherwise; device failures are recorded to the breaker so
    persistent accelerator faults degrade the monitor pass instead of
    killing it. A device that cannot be resolved (None without a card)
    raises: that is a caller's error, not a device fault."""
    device = enc.resolve_device(device)
    if breaker is not None and not breaker.allow():
        TALLY_COUNTS["host"] += 1
        return zone_tally_host(zone_id, bad, valid, num_zones)
    try:
        faultpoints.fire("nodelifecycle.tally",
                         payload=(zone_id, num_zones))
        out = _tally_device(zone_id, bad, valid, int(num_zones), device)
    except Exception as e:
        TALLY_COUNTS["device_failures"] += 1
        TALLY_COUNTS["host"] += 1
        LOG.error("device zone tally failed, answered on the host: %s: %s",
                  type(e).__name__, e, exc_info=e)
        if breaker is not None:
            breaker.record_failure()
        return zone_tally_host(zone_id, bad, valid, num_zones)
    TALLY_COUNTS["device"] += 1
    if breaker is not None:
        breaker.record_success()
    return out
