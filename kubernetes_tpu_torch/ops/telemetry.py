"""Cluster-state telemetry: one reduction of the node tensors a traced
round.

The port of kubernetes_tpu/ops/telemetry.py. From the snapshot's node
tensors, already on the device for scheduling, it computes:

  * per-resource requested / allocatable / free totals, cluster-wide
    and per zone;
  * a free-capacity histogram (TELEMETRY_BINS buckets of free fraction
    per resource) and the largest single-node free block per resource,
    the inputs of the fragmentation index;
  * feasibility headroom for CANONICAL_SHAPES pod sizes: the nodes that
    could still take each shape, by the wave's resource fit and the node
    condition masks.

Everything packs into ONE f32 vector (the integer planes bitcast) so the
scheduler pays a single device-to-host fetch a traced round.

The reduction `_telemetry_body` is written once in torch and runs on
whatever device its tensors are on. It is bit-equal to the JAX package's
`cluster_telemetry` and its numpy twin `cluster_telemetry_host` on the
CPU, and on the card it equals this package's CPU result: the counts and
histograms are integer sums, the maxima exact, and the f32 resource sums
go through `_pairwise_sum`, the JAX module's fixed halving tree
(`x[0::2] + x[1::2]`, one IEEE add an element a level), never
`torch.sum`, whose association differs; the zones are a loop over Z,
each with its own tree. No float atomics.
"""

from __future__ import annotations

import numpy as np
import torch

from . import encoding as enc
from .kernel import record_dispatch

TELEMETRY_BINS = 8  # free-fraction histogram buckets per resource

_GI = float(1024 ** 3)
# canonical pod shapes for feasibility headroom (name, cpu milli, mem
# bytes). Stable order: ledger records and the headroom gauge key off
# these names.
CANONICAL_SHAPES = (
    ("1c-2g", 1000.0, 2 * _GI),
    ("2c-8g", 2000.0, 8 * _GI),
    ("4c-16g", 4000.0, 16 * _GI),
    ("8c-32g", 8000.0, 32 * _GI),
)

# core resource column names (extended columns are looked up from the
# snapshot's resource vocab by the exporter)
CORE_RESOURCE_NAMES = ("cpu", "memory", "ephemeral")


def shape_requests(R: int) -> np.ndarray:
    """f32 [K, R] request vectors for CANONICAL_SHAPES (extended
    resource columns zero: headroom probes core capacity)."""
    req = np.zeros((len(CANONICAL_SHAPES), R), np.float32)
    for i, (_name, cpu, mem) in enumerate(CANONICAL_SHAPES):
        req[i, enc.RES_CPU] = np.float32(cpu)
        req[i, enc.RES_MEM] = np.float32(mem)
    return req


def packed_len(R: int, Z: int) -> int:
    """Length of the packed telemetry vector for R resource columns and
    Z zone slots."""
    K = len(CANONICAL_SHAPES)
    return 4 * R + 2 * Z * R + R * TELEMETRY_BINS + K + 2


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over axis 0 by the JAX module's fixed halving tree
    (kubernetes_tpu/ops/telemetry.py:78): padded with +0.0 to a power of
    two, then x[0::2] + x[1::2] until one row is left."""
    n = x.shape[0]
    p = 1 << max(n - 1, 0).bit_length() if n > 1 else 1
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def _telemetry_body(nt: enc.NodeTensors, shapes_req: torch.Tensor,
                    num_zones: int) -> torch.Tensor:
    """The reduction (kubernetes_tpu/ops/telemetry.py:95), op for op:
    packed f32 [packed_len(R, Z)] on nt's device."""
    dev = nt.valid.device
    R = nt.alloc.shape[1]
    valid = nt.valid
    validf = valid[:, None]
    is_core = torch.arange(R, device=dev) < enc.RES_FIXED
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    alloc = torch.where(validf, nt.alloc, zero)
    req = torch.where(validf, nt.requested, zero)
    free = torch.maximum(alloc - req, zero)

    req_total = _pairwise_sum(req)  # f32 [R]
    alloc_total = _pairwise_sum(alloc)
    free_total = _pairwise_sum(free)
    free_max = free.amax(dim=0)  # f32 [R], exact in any order

    # per-zone sums: a masked copy of the planes a zone (0 = no zone key,
    # its own segment so the totals still tie out), each through the
    # same halving tree over N
    onehot = ((nt.zone_id[:, None]
               == torch.arange(num_zones, device=dev)[None, :])
              & validf)  # [N, Z]
    zone_req = torch.stack([
        _pairwise_sum(torch.where(onehot[:, z, None], req, zero))
        for z in range(num_zones)])  # [Z, R]
    zone_alloc = torch.stack([
        _pairwise_sum(torch.where(onehot[:, z, None], alloc, zero))
        for z in range(num_zones)])

    # free-fraction histogram: bin = floor(free/alloc * B) clipped; an
    # alloc-0 column lands in bin 0. A tensor divisor: IEEE division on
    # every device. Integer one-hot counts — exact.
    one = torch.ones((), dtype=torch.float32, device=dev)
    frac = free / torch.maximum(alloc, one)
    bins = torch.clamp(torch.floor(frac * float(TELEMETRY_BINS)),
                       0, TELEMETRY_BINS - 1).to(torch.int32)  # [N, R]
    hist = ((bins[:, :, None]
             == torch.arange(TELEMETRY_BINS, device=dev)[None, None, :])
            & validf[:, :, None]).sum(dim=0, dtype=torch.int32)  # [R, B]

    # feasibility headroom: the wave's resource fit and the
    # CheckNodeCondition / CheckNodeUnschedulable masks, per shape
    c = nt.cond
    cond_ok = ~(c[:, enc.COND_NOT_READY] | c[:, enc.COND_OUT_OF_DISK]
                | c[:, enc.COND_NET_UNAVAIL])
    sched_ok = valid & cond_ok & ~c[:, enc.COND_UNSCHEDULABLE]
    reqb = shapes_req[:, None, :]  # [K, 1, R]
    fits_col = nt.requested[None, :, :] + reqb <= nt.alloc[None, :, :]
    check = is_core[None, None, :] | (reqb > 0)
    dims_ok = (fits_col | ~check).all(dim=-1)  # [K, N]
    pods_ok = nt.pod_count + 1 <= nt.allowed_pods
    fits = dims_ok & pods_ok[None, :] & sched_ok[None, :]
    headroom = fits.sum(dim=1, dtype=torch.int32)  # i32 [K]

    counts = torch.stack([valid.sum(dtype=torch.int32),
                          sched_ok.sum(dtype=torch.int32)])  # i32 [2]

    f32_parts = torch.cat([
        req_total, alloc_total, free_total, free_max,
        zone_req.reshape(-1), zone_alloc.reshape(-1)])
    i32_parts = torch.cat([hist.reshape(-1), headroom, counts])
    return torch.cat([f32_parts.to(torch.float32),
                      i32_parts.to(torch.int32).view(torch.float32)])


def cluster_telemetry(nt: enc.NodeTensors, *, num_zones: int) -> torch.Tensor:
    """Packed f32 [packed_len(R, Z)] telemetry vector from the node
    tensors, on their device; counted as a "telemetry" dispatch under the
    JAX bucket (N, R, Z, devices) by ops/kernel.py record_dispatch."""
    R = nt.alloc.shape[1]
    bucket = (nt.valid.shape[0], R, num_zones, 1)
    return record_dispatch("telemetry", bucket, lambda: _telemetry_body(
        nt, torch.from_numpy(shape_requests(R)).to(nt.valid.device),
        num_zones))


class ClusterTelemetry:
    """Host-side view of one packed telemetry vector (a copy of the JAX
    module's class; the packed layouts are the same)."""

    def __init__(self, packed, R: int, Z: int):
        a = np.ascontiguousarray(np.asarray(packed, np.float32))
        if a.shape != (packed_len(R, Z),):
            raise ValueError(
                f"packed telemetry length {a.shape} != {packed_len(R, Z)}")
        self.packed = a
        K = len(CANONICAL_SHAPES)
        B = TELEMETRY_BINS
        o = 0

        def take(n):
            nonlocal o
            v = a[o:o + n]
            o += n
            return v

        self.req_total = take(R)
        self.alloc_total = take(R)
        self.free_total = take(R)
        self.free_max = take(R)
        self.zone_req = take(Z * R).reshape(Z, R)
        self.zone_alloc = take(Z * R).reshape(Z, R)
        self.free_hist = np.ascontiguousarray(
            take(R * B)).view(np.int32).reshape(R, B)
        self.headroom = np.ascontiguousarray(take(K)).view(np.int32)
        counts = np.ascontiguousarray(take(2)).view(np.int32)
        self.nodes_valid = int(counts[0])
        self.nodes_schedulable = int(counts[1])

    def utilization(self) -> np.ndarray:
        """requested / allocatable per resource (0 where nothing is
        allocatable)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            u = self.req_total / self.alloc_total
        return np.where(self.alloc_total > 0, u, 0.0).astype(np.float32)

    def fragmentation(self) -> np.ndarray:
        """1 - largest_free_block / total_free per resource: 0 when all
        free capacity sits on one node (a max-size pod can use it), ->1
        as free capacity shatters into unusably small pieces."""
        with np.errstate(invalid="ignore", divide="ignore"):
            f = 1.0 - self.free_max / self.free_total
        return np.where(self.free_total > 0, f, 0.0).astype(np.float32)
