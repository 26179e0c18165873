"""The CUDA source of the taint/host-port kernel (csrc/taint_ports.cu),
compiled for the CPU with a C++20 host compiler against a host stand-in
of the CUDA runtime (tests/cuda_host/cuda_runtime.h: one thread per CUDA
thread, a barrier for __syncthreads, blocks one after another) and held
bit-equal to the plain version on the kernel's edge tables, for both
effect sets, into aligned and unaligned outputs. This checks the
kernel's logic where there is no card; test_torch_cuda.py holds the
kernel built by nvcc to the same tables on the card.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import taint_ports as ttp

SHIM = Path(__file__).resolve().parent / "cuda_host"
EFFECT_SETS = {
    "noschedule+noexecute": (tenc.EFFECT_NO_SCHEDULE,
                             tenc.EFFECT_NO_EXECUTE),
    "noexecute": (tenc.EFFECT_NO_EXECUTE,),
}


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel for the host")
    src, n = re.subn(r"(\w+)<<<([^>]*)>>>\(", r"host_launch(\2, \1, ",
                     ttp.SOURCE.read_text())
    assert n == 1, "the kernel source has one launch"
    out = tmp_path_factory.mktemp("host_kernel")
    (out / "taint_ports.cpp").write_text(src)
    lib = out / "libtaint_ports_host.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-I", str(SHIM),
         "-o", str(lib), str(out / "taint_ports.cpp"), "-lpthread"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(lib))
    ptr = ctypes.c_void_p
    lib.ktt_taint_ports.argtypes = ([ptr] * 11 + [ctypes.c_int] * 6
                                    + [ctypes.c_uint, ptr])
    lib.ktt_block_width.argtypes = [ctypes.c_int] * 4
    lib.ktt_launch_plan.argtypes = [ctypes.c_int] * 6 + [ptr]
    return lib


@pytest.mark.parametrize("effects", sorted(EFFECT_SETS))
@pytest.mark.parametrize("edge", range(len(ttp.EDGE_TABLES)))
def test_host_built_kernel_matches_plain(host_kernel, edge, effects):
    P, N, kw = ttp.EDGE_TABLES[edge]
    eff = EFFECT_SETS[effects]
    nt, pb = ttp.random_tables(P, N, seed=P + N, device="cpu", **kw)
    T, PP = nt.taint_key.shape[1], nt.ports.shape[1]
    TL, PQ = pb.tol_key.shape[1], pb.ports.shape[1]
    tx = host_kernel.ktt_block_width(T, PP, TL, PQ)
    assert tx == (16 if T == ttp.MAX_TAINTS else 32)
    plan = (ctypes.c_int * 6)()
    assert host_kernel.ktt_launch_plan(P, N, T, TL, PP, PQ, plan) == 0
    assert (plan[2], plan[2] * plan[3]) == (tx, 256)
    # one node tile of 16 nodes a thread across x; on the stand-in's card
    # of one block, one block walks all the pod chunks of its tile
    assert (plan[0], plan[1]) == (-(-N // (16 * tx)), 1)
    want = ttp.taint_ports_plain(nt, pb, eff)
    ins = [nt.taint_key, nt.taint_val, nt.taint_effect, nt.ports,
           pb.tol_key, pb.tol_val, pb.tol_op, pb.tol_effect, pb.ports]
    mask = sum(1 << e for e in eff)
    for offset in (0, 3):  # 3: no output row is 4-byte aligned at its start
        bufs = [torch.full((P * N + 16,), 7, dtype=torch.uint8)
                for _ in range(2)]
        err = host_kernel.ktt_taint_ports(
            *[t.data_ptr() for t in ins], bufs[0].data_ptr() + offset,
            bufs[1].data_ptr() + offset, P, N, T, TL, PP, PQ, mask, None)
        assert err == 0
        for buf, w in zip(bufs, want):
            got = buf[offset:offset + P * N]
            assert int(got.max()) <= 1
            assert torch.equal(got.view(P, N).bool(), w)
            # nothing written outside the output
            assert bool((buf[:offset] == 7).all())
            assert bool((buf[offset + P * N:] == 7).all())
