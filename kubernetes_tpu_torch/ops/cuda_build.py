"""Builds a CUDA source of csrc/ into a shared library for sm_90a.

Each hand-written kernel of the port has a plain C entry in its .cu file
and is loaded with ctypes by its wrapper module (ops/taint_ports.py,
ops/preempt.py). The library is compiled with nvcc on first use, from the
sources in the package only, into kubernetes_tpu_torch/_build/, named by
the hash of its source so an edited source is rebuilt. A failed build
raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def compile_shared(source: Path, stem: str):
    """Compile `source` for sm_90a into _build/lib{stem}-{hash}.so unless
    it is there already. Returns (library path, nvcc's output, seconds)."""
    src = source.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{stem}-{tag}.so"
    t0 = time.monotonic()
    log = ""
    if not out.exists():
        tmp = BUILD_DIR / f".lib{stem}-{tag}-{os.getpid()}.so"
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source.name} "
                f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return out, log, time.monotonic() - t0
