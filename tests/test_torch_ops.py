"""Selector programs, the static predicate stack, the score planes and
the device mirror of kubernetes_tpu_torch against the JAX package.

Every comparison is bit-equal: masks are booleans and every score plane
is an integer-valued f32 built in the JAX op order. Inputs are seeded
worlds built once in the JAX package's numpy mirror and carried across
with to_torch; the mirror itself is checked equal between the packages.
"""

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import encoding as jenc
from kubernetes_tpu.ops import filters as jf
from kubernetes_tpu.ops import hostwave
from kubernetes_tpu.ops.kernel import Weights
from kubernetes_tpu.ops import scores as js
from kubernetes_tpu.ops import selectors as jsel
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import filters as tf
from kubernetes_tpu_torch.ops import scores as ts
from kubernetes_tpu_torch.ops import selectors as tsel

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_worlds import make_pod, op_world

SEEDS = [0, 1, 2]


def _eq(jax_out, torch_out):
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _both(seed, **kw):
    snap, pb, pods = op_world("kubernetes_tpu", seed, **kw)
    nt, pm, tt = snap.host_tensors()
    return (nt, pm, tt, pb), tenc.to_torch(nt, pm, tt, pb, "cpu"), snap


@pytest.mark.parametrize("seed", SEEDS)
def test_mirror_and_batch_equal_between_packages(seed):
    """The copied host layers (api, state, featurize) build the same
    numpy mirror and the same PodBatch from the same world."""
    snap_j, pb_j, _ = op_world("kubernetes_tpu", seed)
    snap_t, pb_t, _ = op_world("kubernetes_tpu_torch", seed)
    for a, b, name in zip(pb_j, pb_t, pb_j._fields):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for tj, tt_ in zip(snap_j.host_tensors(), snap_t.host_tensors()):
        for a, b, name in zip(tj, tt_, tj._fields):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_to_torch_keeps_dtypes_and_never_aliases():
    (nt, pm, tt, pb), (ntt, pmt, ttt, pbt), _ = _both(0)
    for np_tup, t_tup in ((nt, ntt), (pm, pmt), (tt, ttt), (pb, pbt)):
        for a, b in zip(np_tup, t_tup):
            assert torch.from_numpy(np.zeros(1, a.dtype)).dtype == b.dtype
            assert b.dtype != torch.int64
            np.testing.assert_array_equal(a, b.numpy())
    nt.alloc[0, 0] += 1.0
    assert ntt.alloc[0, 0] != torch.from_numpy(nt.alloc)[0, 0]
    vec = js.stack_weights(Weights())
    wv = tenc.weight_vec_to_torch(vec, "cpu")
    np.testing.assert_array_equal(wv.numpy(), vec)
    assert wv.dtype == torch.float32 and wv.shape == (len(ts.SCORE_STACK),)


@pytest.mark.parametrize("seed", SEEDS)
def test_eval_and_program(seed):
    (nt, pm, tt, pb), (ntt, pmt, ttt, pbt), _ = _both(seed)
    N = nt.labels.shape[0]
    ids = np.arange(N, dtype=np.int32)
    for key, op, vals, num in ((pb.at_key, pb.at_op, pb.at_vals, pb.at_num),
                               (pb.pt_key, pb.pt_op, pb.pt_vals, pb.pt_num)):
        want = jsel.eval_and_program(nt.labels, nt.label_nums, key, op, vals,
                                     num, ids)
        got = tsel.eval_and_program(
            ntt.labels, ntt.label_nums, torch.from_numpy(key),
            torch.from_numpy(op), torch.from_numpy(vals),
            torch.from_numpy(num), torch.from_numpy(ids))
        _eq(want, got)
        twin = hostwave.eval_and_program(nt.labels, nt.label_nums, key, op,
                                         vals, num, ids)
        np.testing.assert_array_equal(twin, got.numpy())
    # pod-label space, no numeric column (the spreading programs)
    M = pm.labels.shape[0]
    mids = np.arange(M, dtype=np.int32)
    want = jsel.eval_and_program(pm.labels, None, pb.sg_key, pb.sg_op,
                                 pb.sg_vals, pb.sg_num, mids)
    got = tsel.eval_and_program(pmt.labels, None, pbt.sg_key, pbt.sg_op,
                                pbt.sg_vals, pbt.sg_num,
                                torch.from_numpy(mids))
    _eq(want, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_static_predicate_masks(seed):
    (nt, pm, tt, pb), (ntt, pmt, ttt, pbt), _ = _both(seed)
    R = nt.alloc.shape[1]
    is_core = np.arange(R) < jenc.RES_FIXED
    want = jf.static_predicate_masks(nt, pb, is_core)
    got = tf.static_predicate_masks(ntt, pbt, torch.from_numpy(is_core))
    _eq(want, got)
    assert got.shape[0] == len(jenc.DEVICE_PREDICATES) - 2
    # every predicate row rejects something somewhere in these worlds
    # except the rarely-set pressure rows
    assert not bool(got[:7].all())


@pytest.mark.parametrize("seed", SEEDS)
def test_static_score_planes(seed):
    (nt, pm, tt, pb), (ntt, pmt, ttt, pbt), _ = _both(seed)
    N = nt.valid.shape[0]
    _eq(js.node_affinity_raw(nt, pb), ts.node_affinity_raw(ntt, pbt))
    _eq(js.taint_intolerable_raw(nt, pb), ts.taint_intolerable_raw(ntt, pbt))
    _eq(js.spread_counts(pm, pb, N), ts.spread_counts(pmt, pbt, N))
    _eq(js.image_locality(nt, pb), ts.image_locality(ntt, pbt))
    _eq(js.prefer_avoid(nt, pb), ts.prefer_avoid(ntt, pbt))
    assert int(ts.spread_counts(pmt, pbt, N).sum()) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_usage_score_planes(seed):
    (nt, pm, tt, pb), (ntt, pmt, ttt, pbt), _ = _both(seed)
    alloc2, alloc2_t = nt.alloc[:, :2], ntt.alloc[:, :2]
    for i in range(pb.req.shape[0]):
        for fj, ft in ((js.least_requested, ts.least_requested),
                       (js.most_requested, ts.most_requested),
                       (js.balanced_allocation, ts.balanced_allocation)):
            _eq(fj(nt.nonzero, alloc2, pb.nonzero[i]),
                ft(ntt.nonzero, alloc2_t, pbt.nonzero[i]))


@pytest.mark.parametrize("seed", SEEDS)
def test_reduce_planes(seed):
    (nt, pm, tt, pb), (ntt, pmt, ttt, pbt), snap = _both(seed)
    N = nt.valid.shape[0]
    R = nt.alloc.shape[1]
    is_core = np.arange(R) < jenc.RES_FIXED
    feas = np.array(jf.static_predicate_masks(nt, pb, is_core)).all(axis=0)
    aff = np.array(js.node_affinity_raw(nt, pb))
    taint = np.array(js.taint_intolerable_raw(nt, pb))
    cnt = np.array(js.spread_counts(pm, pb, N))
    Z = snap.caps.Z
    for i in range(pb.req.shape[0]):
        f, ft_ = feas[i], torch.from_numpy(feas[i])
        for raw, rev in ((aff[i], False), (taint[i], True)):
            _eq(js.normalize_reduce(raw, f, rev),
                ts.normalize_reduce(torch.from_numpy(raw), ft_, rev))
        _eq(js.spread_reduce(cnt[i], f, nt.zone_id, Z),
            ts.spread_reduce(torch.from_numpy(cnt[i]), ft_, ntt.zone_id, Z))


def test_spread_reduce_thirds_are_exact():
    """The zone-weighted branch divides by 3: an f32 x / 3 and x * (1/3)
    differ in the last bit for some x, so the port divides by a tensor.
    Sweep every count pattern a small cluster can produce."""
    rng = np.random.RandomState(0)
    zone = np.asarray([0, 1, 1, 2, 2, 3, 3, 3], np.int32)
    for _ in range(200):
        cnt = rng.randint(0, 50, size=8).astype(np.int32)
        feas = rng.rand(8) < 0.8
        _eq(js.spread_reduce(cnt, feas, zone, 4),
            ts.spread_reduce(torch.from_numpy(cnt), torch.from_numpy(feas),
                             torch.from_numpy(zone), 4))


def test_snapshot_upload_equals_host_tensors():
    snap, _, _ = op_world("kubernetes_tpu_torch", 3)
    nt, pm, tt = snap.to_device("cpu")
    for host, dev in zip(snap.host_tensors(), (nt, pm, tt)):
        for a, b, name in zip(host, dev, host._fields):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
            assert a.dtype == b.numpy().dtype, name
    assert snap.upload_bytes_total > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_delta_upload_equals_full_reupload(seed):
    """Churn (binds, evictions, node relabels) against a warm device
    cache: the row-delta upload must leave the cache equal to a fresh
    full upload, and move fewer bytes than one."""
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.snapshot import Snapshot

    from torch_worlds import make_nodes

    rng = np.random.RandomState(seed)
    pyr = random.Random(seed)
    # pre-sized: a growth step is a legitimate full upload
    cache, snap = SchedulerCache(), Snapshot(caps=tenc.Caps(M=256))
    nodes = make_nodes("kubernetes_tpu_torch", rng, 40)
    for node in nodes:
        cache.add_node(node)
        snap.set_node(cache.node_infos[node.name])
    bound = []
    for i in range(60):
        p = make_pod("kubernetes_tpu_torch", rng, f"e{i}", 40,
                     node_name=f"n{rng.randint(40)}", rich=False)
        cache.add_pod(p)
        snap.refresh_node_resources(cache.node_infos[p.spec.node_name])
        snap.add_pod(p)
        bound.append(p)
    snap.to_device("cpu")
    for step in range(4):
        for _ in range(3):
            p = make_pod("kubernetes_tpu_torch", rng, f"c{step}-{_}", 40,
                         node_name=f"n{rng.randint(40)}", rich=False)
            cache.add_pod(p)
            snap.refresh_node_resources(cache.node_infos[p.spec.node_name])
            snap.add_pod(p)
            bound.append(p)
        victim = bound.pop(pyr.randrange(len(bound)))
        cache.remove_pod(victim)
        snap.refresh_node_resources(cache.node_infos[victim.spec.node_name])
        snap.remove_pod(victim)
        node = nodes[pyr.randrange(len(nodes))]
        node.metadata.labels["disk"] = "ssd" if step % 2 else "hdd"
        cache.add_node(node)
        snap.set_node(cache.node_infos[node.name])
        before = snap.upload_bytes_total
        got = snap.to_device("cpu")
        moved = snap.upload_bytes_total - before
        full = sum(int(a.nbytes) for tup in snap.host_tensors() for a in tup)
        assert 0 < moved < full // 2, (moved, full)
        for host, dev in zip(snap.host_tensors(), got):
            for a, b, name in zip(host, dev, host._fields):
                np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.resolve_device("cuda")
    snap, _, _ = op_world("kubernetes_tpu_torch", 0, n_nodes=4,
                          n_pending=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        snap.to_device()
    assert tenc.resolve_device("cpu") == torch.device("cpu")
