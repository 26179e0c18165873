"""On-device cluster simulation plane (the cluster autoscaler's engine).

The port of kubernetes_tpu/ops/simulate.py. The reference autoscaler's
`simulator/` package answers two what-ifs by cloning NodeInfo maps
host-side and re-running predicates pod by pod:

  scale-up   "which/how many nodes of which template would make these
             pending pods feasible?"
  scale-down "can this node's residents be re-placed on the rest of the
             cluster simultaneously?"

Both are batched (pods x candidate-nodes) feasibility passes — the
computation the scheduler's wave already performs for real nodes — so
here the simulation runs on the device path:

  1. SHADOW SNAPSHOT — the host cache is re-featurized into a scratch
     `Snapshot` that shares the live vocabularies (interning is
     idempotent, so ids line up) but owns its caps and its tensors, so
     what-if growth never resizes the live mirror and never touches its
     device cache or row-delta state. Scale-up appends *virtual* rows
     featurized from NodeGroup template nodes AFTER the real rows;
     scale-down omits the candidate node (and its pods) instead.
  2. DEVICE PASS — the port's wave and gang run unchanged over the
     shadow tensors on `device` (the CUDA card unless the caller asks
     for another; on the card both launch the taint/port kernel):
     `schedule_wave` for scale-up (its greedy commit under shared
     capacity binpacks pods onto the virtual rows), `schedule_gang` with
     need == len(residents) for scale-down (the all-or-nothing plane IS
     the joint re-placement proof).
  3. VERDICT — placements plus the all-predicate feasibility matrix
     (the AND over the mask stack, the all-true host pseudo-predicate
     included) come back in one fetch; rows >= n_real are expansion
     demand.

backend="host" runs the same what-ifs on the numpy twin
(ops/hostwave.py `schedule_wave_host` / `schedule_gang_host`) over the
shadow's host planes: the autoscaler takes it while the scheduler's
device-path breaker is open, so a tripped card is never dispatched to
and the what-ifs keep producing verdicts, equal to the device branch's.
Both entries fire the `autoscaler.simulate` fault point first, as the
JAX entries do.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..api import types as api
from ..state.node_info import NodeInfo
from ..state.snapshot import Snapshot
from ..utils import faultpoints, tracing
from . import encoding as enc

class SimulationVerdict(NamedTuple):
    """One scale-up what-if: per-pod placement over real+virtual rows
    plus the static all-predicate feasibility matrix."""

    chosen: np.ndarray  # i32 [P]  row index (>= n_real: virtual), -1 = none
    feasible: np.ndarray  # bool [P, N]  AND over the predicate mask stack
    n_real: int  # rows below this index are real nodes


def virtual_node_infos(group, count: int, prefix: str = "~ca") -> List[NodeInfo]:
    """`count` NodeInfos featurized from a NodeGroup's template — the
    virtual rows of the scale-up shadow. The "~" name prefix can never
    collide with a registered node (DNS-1123 forbids it) and the names
    exist only inside the scratch snapshot."""
    from ..cloud.provider import node_from_template

    return [NodeInfo(node_from_template(group, f"{prefix}/{group.name}/{i}"))
            for i in range(count)]


def shadow_snapshot(cache, live: Snapshot, exclude=(),
                    virtual: List[NodeInfo] = ()) -> Tuple[Snapshot, int]:
    """Scratch snapshot re-featurized from the host cache, sharing the
    live vocabularies but owning copied caps. Real nodes (minus
    `exclude`) land first WITH their resident pods — the what-if must
    see current usage, ports, and the live pod matrix for anti-affinity
    — then `virtual` NodeInfos append after them.
    Returns (snapshot, n_real)."""
    scratch = Snapshot(vocabs=live.vocabs,
                       caps=dataclasses.replace(live.caps))
    for name, ni in cache.node_infos.items():
        if ni.node is None or name in exclude:
            continue
        scratch.set_node(ni)
        for pod in ni.pods:
            scratch.add_pod(pod)
    n_real = len(scratch.node_names)
    for vni in virtual:
        scratch.set_node(vni)
    return scratch, n_real


def _upload(snapshot: Snapshot, pb: enc.PodBatch, device):
    """The shadow's tensors and the batch on `device`, the all-true host
    mask [P, caps.N] and rr_start 0 (i32)."""
    dev = enc.resolve_device(device)
    nt, pm, tt = snapshot.to_device(dev)
    pbt = enc.to_torch(None, None, None, pb, dev)[3]
    extra = torch.ones((pb.req.shape[0], snapshot.caps.N), dtype=torch.bool,
                       device=dev)
    rr = torch.zeros((), dtype=torch.int32, device=dev)
    return dev, nt, pm, tt, pbt, extra, rr


def simulate_placements(snapshot: Snapshot, pb: enc.PodBatch, *, weights,
                        num_zones: int, num_label_values: int,
                        has_ipa: bool = False, backend: str = "device",
                        device=None) -> SimulationVerdict:
    """Scale-up what-if: the wave over (pending pods x real+virtual
    rows) on `device`, or on the numpy twin with backend="host". The
    loop's greedy commit carries usage across the batch, so multiple
    pods packing onto one virtual node — and the point where it fills
    and a second one is needed — fall out of the existing wave. n_real
    is filled in by the caller (the snapshot doesn't know which rows are
    virtual). `pb` is the numpy batch."""
    faultpoints.fire("autoscaler.simulate")
    P = pb.req.shape[0]
    with tracing.span("autoscaler_simulate",
                      cat="host" if backend == "host" else "device",
                      what="scale_up", pods=P, backend=backend):
        if backend == "host":
            from .hostwave import schedule_wave_host

            nt, pm, tt = snapshot.host_tensors()
            extra = np.ones((P, snapshot.caps.N), bool)
            res, _usage = schedule_wave_host(
                nt, pm, tt, pb, extra, 0, None, weights=weights,
                num_zones=num_zones, num_label_values=num_label_values,
                has_ipa=has_ipa)
            return SimulationVerdict(chosen=np.asarray(res.chosen),
                                     feasible=np.asarray(res.masks).all(
                                         axis=0),
                                     n_real=-1)
        from .kernel import schedule_wave

        _, nt, pm, tt, pbt, extra, rr = _upload(snapshot, pb, device)
        res = schedule_wave(nt, pm, tt, pbt, extra, rr, None,
                            weights=weights, num_zones=num_zones,
                            num_label_values=num_label_values,
                            has_ipa=has_ipa,
                            has_ts=bool(pb.ts_valid.any()))
        # the one fetch: chosen i32 [P] and the [P, N] AND over the mask
        # stack, as bytes of one buffer
        feasible = res.masks.all(dim=0)
        buf = torch.cat([res.chosen.contiguous().view(torch.uint8),
                         feasible.view(torch.uint8).reshape(-1)]).cpu()
        host = buf.numpy()
        chosen = host[:4 * P].view(np.int32).copy()
        feasible = host[4 * P:].view(bool).reshape(P, -1).copy()
    return SimulationVerdict(chosen=chosen, feasible=feasible, n_real=-1)


def simulate_refit(snapshot: Snapshot, pb: enc.PodBatch, need: int, *,
                   weights, num_zones: int, num_label_values: int,
                   has_ipa: bool = False, backend: str = "device",
                   device=None) -> Tuple[bool, np.ndarray]:
    """Scale-down what-if: joint re-placement of a drain candidate's
    residents on the remaining cluster, through the gang all-or-nothing
    plane (ops/gang.py; the twin's with backend="host") with need ==
    number of residents — the verdict is True only when EVERY resident
    holds capacity simultaneously in one pass, i.e. the drain cannot
    strand a pod Pending. Returns (ok, chosen rows)."""
    faultpoints.fire("autoscaler.simulate")
    P = pb.req.shape[0]
    with tracing.span("autoscaler_simulate",
                      cat="host" if backend == "host" else "device",
                      what="scale_down", pods=P, need=need, backend=backend):
        if backend == "host":
            from .hostwave import schedule_gang_host

            nt, pm, tt = snapshot.host_tensors()
            extra = np.ones((P, snapshot.caps.N), bool)
            res = schedule_gang_host(
                nt, pm, tt, pb, extra, 0, None, need, weights=weights,
                num_zones=num_zones, num_label_values=num_label_values,
                has_ipa=has_ipa)
            return bool(res.ok), np.asarray(res.chosen)
        from .gang import schedule_gang

        dev, nt, pm, tt, pbt, extra, rr = _upload(snapshot, pb, device)
        res = schedule_gang(nt, pm, tt, pbt, extra, rr, None,
                            torch.tensor(need, dtype=torch.int32, device=dev),
                            weights=weights, num_zones=num_zones,
                            num_label_values=num_label_values,
                            has_ipa=has_ipa, ts_valid_host=pb.ts_valid)
        # the one fetch: chosen i32 [P], then ok as one i32
        host = torch.cat([res.chosen, res.ok.to(torch.int32).reshape(1)]
                         ).cpu().numpy()
    return bool(host[P]), host[:P].copy()


def strip_node_name(pod: api.Pod) -> api.Pod:
    """Copy of a bound pod with its placement cleared — residents of a
    drain candidate must featurize as if pending, or their host_idx
    would pin them to the very row the shadow omitted (-2: matches no
    node) and every refit proof would fail vacuously."""
    import copy

    out = copy.deepcopy(pod)
    out.spec.node_name = ""
    return out
