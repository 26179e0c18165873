"""The taint/host-port kernel of kubernetes_tpu_torch (ops/taint_ports.py).

On the CPU the wrapper runs its plain PyTorch version; it must be
bit-equal to the JAX package's Pallas kernel (interpret mode) and to
its XLA formulation (filters.tolerates_taints / host_ports) on seeded
worlds with ragged pod and node counts, for both effect sets. The CUDA
kernel itself is held to the plain version in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import encoding as jenc
from kubernetes_tpu.ops.filters import host_ports as jax_host_ports
from kubernetes_tpu.ops.filters import tolerates_taints as jax_tolerates
from kubernetes_tpu.ops.pallas_kernels import taint_ports_masks as jax_masks
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import taint_ports as ttp

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_worlds import op_world

EFFECT_SETS = {
    "noschedule+noexecute": (jenc.EFFECT_NO_SCHEDULE, jenc.EFFECT_NO_EXECUTE),
    "noexecute": (jenc.EFFECT_NO_EXECUTE,),
}
# ragged node and pod counts (neither a multiple of the kernel's blocks)
SHAPES = [(0, 23, 11), (1, 37, 29), (2, 5, 3), (3, 61, 45)]


def _world(seed, n_nodes, n_pending):
    snap, pb, _ = op_world("kubernetes_tpu", seed, n_nodes=n_nodes,
                           n_pending=n_pending)
    nt, _, _ = snap.host_tensors()
    return nt, pb


@pytest.mark.parametrize("effects", sorted(EFFECT_SETS))
@pytest.mark.parametrize("seed,n_nodes,n_pending", SHAPES)
def test_plain_matches_pallas_and_xla(seed, n_nodes, n_pending, effects):
    eff = EFFECT_SETS[effects]
    nt, pb = _world(seed, n_nodes, n_pending)
    want_t, want_p = jax_masks(nt, pb, effects=eff, interpret=True)
    want_t, want_p = np.asarray(want_t), np.asarray(want_p)
    np.testing.assert_array_equal(want_t, np.asarray(jax_tolerates(nt, pb, eff)))
    np.testing.assert_array_equal(want_p, np.asarray(jax_host_ports(nt, pb)))
    ntt, _, _, pbt = tenc.to_torch(nt, None, None, pb, "cpu")
    got_t, got_p = ttp.taint_ports_masks(ntt, pbt, effects=eff)
    assert got_t.dtype == torch.bool and got_p.dtype == torch.bool
    assert tuple(got_t.shape) == want_t.shape == (pb.req.shape[0],
                                                  nt.valid.shape[0])
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    # the worlds exercise both outcomes of both masks
    assert want_t.any() and not want_t.all()


@pytest.mark.parametrize("effects", sorted(EFFECT_SETS))
@pytest.mark.parametrize("edge", range(len(ttp.EDGE_TABLES)))
def test_plain_matches_pallas_on_edge_tables(edge, effects):
    """The seeded feature tables that hold the CUDA kernel to its plain
    version at its edges (test_torch_cuda.py, chip_smoke.py): there the
    plain version equals the Pallas kernel too."""
    P, N, kw = ttp.EDGE_TABLES[edge]
    eff = EFFECT_SETS[effects]
    nt, pb = ttp.random_tables(P, N, seed=P + N, device="cpu", **kw)
    np_nt = jenc.NodeTensors(*[None if t is None else t.numpy()
                               for t in nt])
    np_pb = jenc.PodBatch(*[None if t is None else t.numpy() for t in pb])
    want_t, want_p = jax_masks(np_nt, np_pb, effects=eff, interpret=True)
    got_t, got_p = ttp.taint_ports_masks(nt, pb, effects=eff)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert tuple(got_t.shape) == (P, N)


def test_cpu_tensors_take_the_plain_version_uncounted():
    nt, pb = _world(4, 17, 9)
    ntt, _, _, pbt = tenc.to_torch(nt, None, None, pb, "cpu")
    before = ttp.taint_ports_masks.launches
    got = ttp.taint_ports_masks(ntt, pbt)
    want = ttp.taint_ports_plain(ntt, pbt)
    assert ttp.taint_ports_masks.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ports_conflict_only_on_live_pod_ports():
    """A pod port 0 (pad) never conflicts, even with a node's 0 pads."""
    nt, pb = _world(5, 9, 7)
    ntt, _, _, pbt = tenc.to_torch(nt, None, None, pb, "cpu")
    pbt = pbt._replace(ports=torch.zeros_like(pbt.ports))
    _, ports = ttp.taint_ports_masks(ntt, pbt)
    assert bool(ports.all())
