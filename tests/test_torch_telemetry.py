"""The cluster telemetry of kubernetes_tpu_torch (ops/telemetry.py)
against the JAX package's `cluster_telemetry` and its numpy twin
`cluster_telemetry_host`, on the same node tensors, with no tolerance:
the packed f32 vectors equal as bit patterns.

The node tensors come from three seeds of `ipa_world` (several zones),
with random non-integer requests over a wide range so that the order of
the f32 additions shows (the halving tree, not torch.sum), a node count
that is not a power of two, a column with allocatable 0, invalid and
unready nodes. The parsed view (`ClusterTelemetry`) ties the zone sums
out to the totals.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import encoding as jenc
from kubernetes_tpu.ops import hostwave
from kubernetes_tpu.ops import telemetry as jtele
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import telemetry as ttele

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import CAPS
from torch_worlds import ipa_world


def _node_tensors(seed, n=None, zero_col=False, rough=True):
    """A seeded world's numpy node tensors, cut to n rows when given;
    rough: random requests of 1e-3..1e9 (non-integer), some nodes
    invalid or not ready."""
    snap, _, _ = ipa_world("kubernetes_tpu", seed, caps=jenc.Caps(**CAPS),
                           featurize=False)
    nt, _, _ = snap.host_tensors()
    nt = nt._replace(**{f: np.array(getattr(nt, f)) for f in nt._fields})
    if n is not None:
        nt = nt._replace(**{f: getattr(nt, f)[:n] for f in nt._fields})
    rng = np.random.RandomState(seed)
    N, R = nt.alloc.shape
    if rough:
        scale = 10.0 ** rng.uniform(-3, 9, size=(N, R))
        nt.requested[:] = (rng.rand(N, R) * scale).astype(np.float32)
        nt.alloc[:] = (nt.requested * rng.uniform(0.5, 3.0, size=(N, R))
                       ).astype(np.float32)
        nt.valid[rng.rand(N) < 0.15] = False
        nt.cond[rng.rand(N) < 0.2, jenc.COND_NOT_READY] = True
    if zero_col:
        nt.alloc[:, R - 1] = 0.0
    return snap, nt


def _all_three(nt, Z):
    want = np.asarray(jtele.cluster_telemetry(nt, num_zones=Z))
    twin = hostwave.cluster_telemetry_host(nt, num_zones=Z)
    ntt = tenc.to_torch(nt, None, None, None, "cpu")[0]
    got = ttele.cluster_telemetry(ntt, num_zones=Z).numpy()
    return want, twin, got


@pytest.mark.parametrize("case", ["world", "rough", "odd_n", "zero_col"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_vector_equals_both_jax_forms(seed, case):
    n = 13 if case == "odd_n" else None
    snap, nt = _node_tensors(seed, n=n, zero_col=case == "zero_col",
                             rough=case != "world")
    Z = snap.caps.Z
    want, twin, got = _all_three(nt, Z)
    R = nt.alloc.shape[1]
    assert got.dtype == np.float32
    assert got.shape == (ttele.packed_len(R, Z),) == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), twin.view(np.int32))
    ct = ttele.ClusterTelemetry(got, R, Z)
    assert ct.nodes_valid == int(nt.valid.sum())
    assert int(ct.free_hist.sum()) == R * ct.nodes_valid
    # several zones hold nodes, and their sums tie out to the totals
    assert (ct.zone_alloc.sum(axis=1) > 0).sum() >= 2
    np.testing.assert_allclose(ct.zone_req.sum(axis=0, dtype=np.float64),
                               ct.req_total, rtol=1e-5)
    if case == "zero_col":
        assert ct.alloc_total[R - 1] == 0
        assert ct.free_hist[R - 1, 0] == ct.nodes_valid


def test_halving_tree_is_not_torch_sum():
    """The rough world's requests sum to other bits by torch.sum on at
    least one seed: the tree is what holds the vectors equal."""
    differs = False
    for seed in range(3):
        _, nt = _node_tensors(seed)
        req = torch.from_numpy(np.where(nt.valid[:, None], nt.requested,
                                        np.float32(0)))
        tree = ttele._pairwise_sum(req)
        differs |= not torch.equal(tree, req.sum(dim=0))
    assert differs


def test_constants_and_layout_match_jax():
    assert ttele.CANONICAL_SHAPES == jtele.CANONICAL_SHAPES
    assert ttele.CORE_RESOURCE_NAMES == jtele.CORE_RESOURCE_NAMES
    assert ttele.TELEMETRY_BINS == jtele.TELEMETRY_BINS
    for R, Z in ((3, 1), (5, 16)):
        assert ttele.packed_len(R, Z) == jtele.packed_len(R, Z)
        np.testing.assert_array_equal(ttele.shape_requests(R),
                                      jtele.shape_requests(R))
