"""Builds a CUDA source of csrc/ into a shared library for sm_90a.

Each hand-written kernel of the port has a plain C entry in its .cu file
and is loaded with ctypes by its wrapper module (ops/taint_ports.py,
ops/preempt.py). The library is compiled with nvcc on first use, from the
sources in the package only, into kubernetes_tpu_torch/_build/, named by
the hash of its source so an edited source is rebuilt. A failed build or
load raises KernelBuildError (with nvcc's output); nothing falls back.
A wrapper that refuses inputs its built kernel cannot take raises
KernelInputError, a KernelBuildError. The scheduler never counts either
as a device fault: a kernel that cannot be built, or cannot run these
tables, says nothing about the card, so it must not open the breaker and
send a healthy card's work to the host twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"


class KernelBuildError(RuntimeError):
    """A kernel of csrc/ could not be built (no nvcc, or nvcc failed) or
    its library could not be loaded."""


class KernelInputError(KernelBuildError, ValueError, TypeError):
    """A kernel's wrapper refuses its inputs: a tensor on another device,
    of another dtype or shape, more slots or columns than the kernel is
    built for, more shared memory than a block has, or no launch for the
    tables. Raised where the wrapper checks, before any launch."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")


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
            raise KernelBuildError(
                f"nvcc failed to build {source.name} "
                f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return out, log, time.monotonic() - t0


def load_library(path: Path) -> ctypes.CDLL:
    """ctypes.CDLL(path), a failure raised as KernelBuildError."""
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {Path(path).name}: {e}") from e
