"""The CUDA source of the what-if kernel (csrc/preempt_whatif.cu),
compiled for the CPU with a C++20 host compiler against the host
stand-in of the CUDA runtime (tests/cuda_host/cuda_runtime.h: one thread
per CUDA thread, blocks one after another, IEEE single-precision
arithmetic with FMA contraction off) and held bit-equal to the plain
version on the kernel's edge worlds: P = 1, 16 and 128, N not a
multiple of 32, sums that round, both priority-max sentinels, with and
without gang weights (a null pointer). Its rows come from the wrapper's
own CSR (ops/preempt.py node_rows). This checks the kernel's logic where
there is no card; test_torch_cuda.py holds the kernel built by nvcc to
the same worlds on the card.
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
    src, n = re.subn(r"(\w+)<<<([^>]*)>>>\(", r"host_launch(\2, \1, ",
                     tpre.SOURCE.read_text())
    assert n == 1, "the kernel source has one launch"
    out = tmp_path_factory.mktemp("host_whatif")
    (out / "preempt_whatif.cpp").write_text(src)
    lib = out / "libpreempt_whatif_host.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", str(SHIM), "-o", str(lib), str(out / "preempt_whatif.cpp"),
         "-lpthread"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(lib))
    ptr = ctypes.c_void_p
    lib.kpw_preempt_whatif.argtypes = ([ptr] * 14 + [ctypes.c_int] * 5
                                       + [ptr, ptr])
    return lib


def _launch(lib, w, out):
    P, N = w.static_ok.shape
    R = w.alloc.shape[1]
    row_ptr, rows = tpre.node_rows(w.ep_node, N)
    ins = [w.alloc, w.requested, w.pod_count, w.allowed_pods, w.ep_req,
           w.ep_prio, w.live]
    return lib.kpw_preempt_whatif(
        *[t.data_ptr() for t in ins],
        None if w.gang_w is None else w.gang_w.data_ptr(),
        row_ptr.data_ptr(), rows.data_ptr(), w.levels.data_ptr(),
        w.pb_req.data_ptr(), w.pb_prio.data_ptr(), w.static_ok.data_ptr(),
        P, N, R, w.levels.shape[0], tenc.RES_FIXED, out.data_ptr(), None)


@pytest.mark.parametrize("edge", range(len(tpre.EDGE_WORLDS)))
def test_host_built_kernel_matches_plain(host_kernel, edge):
    P, N, M, kw = tpre.EDGE_WORLDS[edge]
    w = tpre.random_whatif(P, N, M, seed=P + N, device="cpu", **kw)
    want = tpre.whatif_plain(w)
    out = torch.full((5 * P * N + 8,), 7, dtype=torch.int32)
    assert _launch(host_kernel, w, out) == 0
    assert torch.equal(out[:5 * P * N].view(5, P, N), want)
    assert bool((out[5 * P * N:] == 7).all())  # nothing written past it


def test_node_rows_hold_every_row_in_order():
    """The CSR: each node's rows in increasing row index, free and pad
    rows (node 0, and ids below 0) and removed rows included, ids at or
    past N in no node."""
    node = torch.tensor([3, 0, -1, 3, 5, 9, 0, 3], dtype=torch.int32)
    row_ptr, rows = tpre.node_rows(node, 6)
    assert row_ptr.tolist() == [0, 3, 3, 3, 6, 6, 7]
    assert rows[:7].tolist() == [1, 2, 6, 0, 3, 7, 4]


def test_host_built_kernel_rejects_wide_resources(host_kernel):
    w = tpre.random_whatif(4, 5, 16, seed=3, R=17, device="cpu")
    out = torch.zeros((5, 4, 5), dtype=torch.int32)
    assert _launch(host_kernel, w, out) != 0
