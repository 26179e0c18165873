"""The CUDA source of the what-if kernels (csrc/preempt_whatif.cu),
compiled for the CPU with a C++20 host compiler against the host
stand-in of the CUDA runtime (tests/cuda_host/cuda_runtime.h: one thread
per CUDA thread, blocks one after another, IEEE single-precision
arithmetic with FMA contraction off) and driven through the wrapper's own
steps (ops/preempt.py `whatif_prepare` / `whatif_launch` with the host
library): the row keys and bounds against the plain kept-row lists
(`live_rows`), the threshold slots against their plain version, and the
packed result bit-equal to the plain what-if on the kernels' edge
worlds: P = 1, 16 and 128, N not a multiple of 32, P * N not a multiple
of 4, sums that round, both priority-max sentinels and victims at
INT32_MIN, non-finite values in non-live rows, the dense world with
L + P - 1 thresholds, with and without gang weights (a null pointer).
This checks the kernels' logic where there is no card;
test_torch_cuda.py holds the nvcc build to the same worlds on the card.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import preempt as tpre

SHIM = Path(__file__).resolve().parent / "cuda_host"


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel for the host")
    text = tpre.SOURCE.read_text()
    src, n = re.subn(r"(\w+)<<<([^>]*)>>>\(", r"host_launch(\2, \1, ", text)
    assert n == len(re.findall(r"__global__", text)) == 5, \
        "each of the five kernels has one launch"
    out = tmp_path_factory.mktemp("host_whatif")
    (out / "preempt_whatif.cpp").write_text(src)
    lib = out / "libpreempt_whatif_host.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(SHIM), "-o", str(lib), str(out / "preempt_whatif.cpp"),
         "-lpthread"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return tpre.bind(ctypes.CDLL(str(lib)))


def _world(edge):
    P, N, M, kw = tpre.EDGE_WORLDS[edge]
    return tpre.random_whatif(P, N, M, seed=P + N, device="cpu", **kw)


@pytest.mark.parametrize("edge", range(len(tpre.EDGE_WORLDS)))
def test_host_built_kernel_matches_plain(host_kernel, edge):
    w = _world(edge)
    P, N = w.static_ok.shape
    want = tpre.whatif_plain(w)
    prep = tpre.whatif_prepare(w, lib=host_kernel)
    buf = torch.full((5 * P * N + 8,), 7, dtype=torch.int32)
    got = tpre.whatif_launch(prep._replace(out=buf[:5 * P * N].view(5, P, N)))
    assert torch.equal(got, want)
    assert bool((buf[5 * P * N:] == 7).all())  # nothing written past it


# (ep_node, live, rows given an odd value, N, row_ptr, kept rows in
# order): every row live keeps every row of a node in increasing row
# index, free and pad rows (node 0, ids below 0) included, ids at or past
# N in no node; non-live rows are left out unless a request of theirs is
# not finite (row 2: -inf; row 5: NaN, but in no node). A non-finite gang
# weight (row 7: inf) keeps no row: the gang sum is a select
ROW_CASES = {
    "every_row_live": ([3, 0, -1, 3, 5, 9, 0, 3], [1] * 8, [], 6,
                       [0, 3, 3, 3, 6, 6, 7], [1, 2, 6, 0, 3, 7, 4]),
    "live_only": ([3, 0, -1, 3, 5, 9, 0, 3], [0, 1, 0, 1, 1, 1, 0, 0], [],
                  6, [0, 1, 1, 1, 2, 2, 3], [1, 3, 4]),
    "non_finite_request_kept": ([3, 0, -1, 3, 5, 9, 0, 3],
                                [0, 1, 0, 1, 1, 1, 0, 0], [2, 7, 5], 6,
                                [0, 2, 2, 2, 3, 3, 4], [1, 2, 3, 4]),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
@pytest.mark.parametrize("route", ["plain", "host_kernel"])
def test_live_rows_keep_live_rows_in_order(host_kernel, case, route):
    node, live, odd, N, want_ptr, want_rows = ROW_CASES[case]
    M = len(node)
    ep_req = torch.ones((M, 3), dtype=torch.float32)
    gang_w = torch.zeros((M,), dtype=torch.float32)
    for k, m in enumerate(odd):  # -inf request, inf gang weight, NaN request
        if k % 2:
            gang_w[m] = float("inf")
        else:
            ep_req[m, k % 3] = float("nan") if k else -float("inf")
    lib = host_kernel if route == "host_kernel" else None
    ep_node = torch.tensor(node, dtype=torch.int32)
    live = torch.tensor(live, dtype=torch.bool)
    row_ptr, rows, dropped = tpre.live_rows(ep_node, live, ep_req, N, lib=lib)
    assert row_ptr.tolist() == want_ptr
    assert rows[:want_ptr[-1]].tolist() == want_rows
    left_out = {max(n, 0) for m, n in enumerate(node)
                if max(n, 0) < N and m not in want_rows}
    assert dropped.tolist() == [int(n in left_out) for n in range(N)]
    # and the what-if's sums over these lists equal the plain version's
    # over every row, the gang weight included
    w = tpre.WhatIf(
        alloc=torch.full((N, 3), 4.0), requested=torch.full((N, 3), 4.0),
        pod_count=torch.full((N,), 3, dtype=torch.int32),
        allowed_pods=torch.full((N,), 3, dtype=torch.int32),
        ep_node=ep_node, live=live, ep_req=ep_req,
        ep_prio=torch.arange(M, dtype=torch.int32), gang_w=gang_w,
        levels=torch.tensor([3, 9], dtype=torch.int32),
        pb_req=torch.ones((2, 3)), pb_prio=torch.tensor([9, 5],
                                                        dtype=torch.int32),
        static_ok=torch.ones((2, N), dtype=torch.bool))
    if lib is not None:
        got = tpre.whatif_launch(tpre.whatif_prepare(w, lib=lib))
        assert torch.equal(got, tpre.whatif_plain(w))


@pytest.mark.parametrize("edge", range(len(tpre.EDGE_WORLDS)))
def test_host_built_rows_and_slots_match_plain(host_kernel, edge):
    w = _world(edge)
    N = w.alloc.shape[0]
    want = tpre.live_rows(w.ep_node, w.live, w.ep_req, N)
    got = tpre.live_rows(w.ep_node, w.live, w.ep_req, N, lib=host_kernel)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    values, slot_of, n_slots = tpre.threshold_slots(w.levels, w.pb_prio)
    hv, hs, hn = tpre.threshold_slots(w.levels, w.pb_prio, lib=host_kernel)
    S = int(n_slots)
    assert int(hn) == S and torch.equal(hs, slot_of)
    assert torch.equal(hv[:S], values[:S])
    P, L = slot_of.shape
    assert S <= L + P - 1
    if tpre.EDGE_WORLDS[edge][3].get("dense"):
        assert S == L + P - 1  # the most any chunk can have


@pytest.mark.parametrize("edge", range(len(tpre.EDGE_WORLDS)))
def test_host_built_class_stats_match_plain(host_kernel, edge):
    """Every (threshold, node) entry of the class-stats table, whichever
    level the pick takes: the kept-row lists and their staging hold every
    row of a class, in order. Bit-equal, except that a NaN sum (a
    non-finite request of a kept row; such a class never fits) may carry
    another sign and payload: its position must be the same."""
    w = _world(edge)
    prep = tpre.whatif_prepare(w, lib=host_kernel)
    tpre.whatif_launch(prep)
    args = prep.tensors
    S = int(args.n_slots)
    got = args.stats[:S]
    want = tpre.class_stats_plain(w, args.slot_values[:S])
    floats = slice(0, w.alloc.shape[1] + 3)
    nan = torch.isnan(got[:, floats].view(torch.float32))
    assert torch.equal(nan, torch.isnan(want[:, floats].view(torch.float32)))
    same = got == want
    same[:, floats] |= nan
    assert bool(same.all())


def test_host_built_kernel_rejects_wide_resources(host_kernel):
    w = tpre.random_whatif(4, 5, 16, seed=3, R=17, device="cpu")
    with pytest.raises(ValueError):
        tpre.whatif_prepare(w, lib=host_kernel)
    out = torch.zeros((5, 4, 5), dtype=torch.int32)
    ins = [w.alloc, w.requested, w.pod_count, w.allowed_pods, w.ep_req,
           w.ep_prio, w.live, w.gang_w] + [w.ep_node] * 5 + [w.pb_req,
                                                             w.static_ok]
    stats = torch.zeros((64,), dtype=torch.int32)
    assert host_kernel.kpw_class_stats_and_pick(
        *[t.data_ptr() for t in ins], 4, 5, 17, 8, tenc.RES_FIXED, 1,
        stats.data_ptr(), out.data_ptr(), None) != 0
