"""PodToleratesNodeTaints + PodFitsHostPorts as one hand-written CUDA
kernel, with its plain PyTorch version beside it.

Replaces the Pallas TPU kernel `taint_ports_masks` /
`_taint_ports_kernel` (kubernetes_tpu/ops/pallas_kernels.py:98, :41).
The semantics are those of the reference's predicates.go:1504
(taints, restricted to an effect set) and :991 (host ports), as the
plain versions below spell them out.

The kernel source is csrc/taint_ports.cu. It is compiled on first use
with nvcc for sm_90a into kubernetes_tpu_torch/_build/ (ops/cuda_build.py:
a shared library with a plain C entry, loaded with ctypes) — from the
sources in the package only. A failed build raises with nvcc's output.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import encoding as enc
from .cuda_build import PKG, compile_shared
from .encoding import NodeTensors, PodBatch

DEFAULT_EFFECTS = (enc.EFFECT_NO_SCHEDULE, enc.EFFECT_NO_EXECUTE)

SOURCE = PKG / "csrc" / "taint_ports.cu"
# the largest taint and port slot counts per node the kernel is held to
# its plain version at (its per-node counts are 8-bit fields)
MAX_TAINTS = 16
MAX_NODE_PORTS = 64


# --- plain versions (reference: kubernetes_tpu/ops/filters.py :46, :102) ----


def host_ports(nt: NodeTensors, pb: PodBatch) -> torch.Tensor:
    """[P, N] — reference predicates.go:991 PodFitsHostPorts. Interned
    (proto, port) ids; the rare hostIP-wildcard distinction is resolved by
    the exact host-side recheck at commit (state/node_info.py)."""
    P, PQ = pb.ports.shape
    N = nt.ports.shape[0]
    conflict = torch.zeros((P, N), dtype=torch.bool, device=pb.ports.device)
    for q in range(PQ):
        pq = pb.ports[:, q]  # [P]
        hit = (pq[:, None, None] == nt.ports[None, :, :]).any(dim=-1)
        conflict |= (pq > 0)[:, None] & hit
    return ~conflict


def _tolerated(nt: NodeTensors, pb: PodBatch, t: int) -> torch.Tensor:
    """[P, N] whether taint slot t is tolerated by any of the pod's
    tolerations. Reference: staging api/core/v1/toleration.go:37
    ToleratesTaint."""
    tk = nt.taint_key[:, t]  # [N]
    tv = nt.taint_val[:, t]
    te = nt.taint_effect[:, t]
    key_ok = ((pb.tol_key == 0)[:, :, None]
              | (pb.tol_key[:, :, None] == tk[None, None, :]))
    val_ok = ((pb.tol_op == enc.TOL_EXISTS)[:, :, None]
              | (pb.tol_val[:, :, None] == tv[None, None, :]))
    eff_ok = ((pb.tol_effect == 0)[:, :, None]
              | (pb.tol_effect[:, :, None] == te[None, None, :]))
    live = (pb.tol_op != enc.TOL_PAD)[:, :, None]
    return (live & key_ok & val_ok & eff_ok).any(dim=1)  # [P, N]


def tolerates_taints(nt: NodeTensors, pb: PodBatch, effects) -> torch.Tensor:
    """[P, N] — reference predicates.go:1504 PodToleratesNodeTaints with an
    effect filter (NoSchedule+NoExecute; or NoExecute only for the
    NoExecute variant)."""
    P = pb.tol_key.shape[0]
    N = nt.taint_key.shape[0]
    dev = nt.taint_key.device
    untol = torch.zeros((P, N), dtype=torch.bool, device=dev)
    for t in range(nt.taint_key.shape[1]):
        te = nt.taint_effect[:, t]  # [N]
        relevant = torch.zeros((N,), dtype=torch.bool, device=dev)
        for e in effects:
            relevant |= te == e
        untol |= relevant[None, :] & ~_tolerated(nt, pb, t)
    return ~untol


def taint_ports_plain(nt: NodeTensors, pb: PodBatch,
                      effects=DEFAULT_EFFECTS):
    """The plain PyTorch version of the kernel: (taints_ok, ports_ok),
    both bool [P, N]."""
    return tolerates_taints(nt, pb, effects), host_ports(nt, pb)


# Seeded feature tables at the kernel's edges, as (P pod rows, N nodes,
# random_tables keyword arguments): N < 16 and N not a multiple of 16
# (unaligned rows, ragged node edge), P not a multiple of the 64-row pod
# chunk and several chunks to a node tile, the largest taint and port
# slot counts, every toleration dead, every toleration live with more
# live entries than a row keeps in registers, and no pod port.
EDGE_TABLES = (
    (45, 7, {}),
    (77, 37, {}),
    (300, 48, {}),
    (33, 1000, dict(T=MAX_TAINTS, PP=MAX_NODE_PORTS)),
    (70, 531, dict(tolerations="none")),
    (70, 531, dict(tolerations="all", TL=8, PQ=8, port_rate=0.9)),
    (64, 200, dict(port_rate=0.0)),
)


def random_tables(P: int, N: int, seed: int, *, T: int = 4, TL: int = 4,
                  PP: int = 8, PQ: int = 4, tolerations: str = "mixed",
                  port_rate: float = 0.2, device="cuda"):
    """Seeded feature tables for holding the kernel to its plain version:
    (NodeTensors, PodBatch) with only the taint, toleration and port
    fields set. Ids come from small vocabularies so both outcomes of
    every compare occur; pad slots sit anywhere in a row.

    tolerations: "mixed" (about 2/3 of the slots live), "none" (every
    slot a pad) or "all" (every slot live). port_rate: the share of a
    pod's port slots that ask for a port (0: none do)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    nt = dict(
        taint_key=rng.randint(0, 5, (N, T)),
        taint_val=rng.randint(0, 4, (N, T)),
        taint_effect=rng.randint(0, 4, (N, T)),
        ports=np.where(rng.rand(N, PP) < 0.3, rng.randint(1, 12, (N, PP)),
                       0))
    pb = dict(
        tol_key=rng.randint(-2, 5, (P, TL)),
        tol_val=rng.randint(-1, 4, (P, TL)),
        tol_op=rng.randint(enc.TOL_PAD, enc.TOL_EXISTS + 1, (P, TL)),
        tol_effect=rng.randint(0, 4, (P, TL)),
        ports=np.where(rng.rand(P, PQ) < port_rate,
                       rng.randint(1, 12, (P, PQ)), 0))
    if tolerations == "none":
        pb["tol_op"][:] = enc.TOL_PAD
    elif tolerations == "all":
        pb["tol_op"][pb["tol_op"] == enc.TOL_PAD] = enc.TOL_EQUAL
    elif tolerations != "mixed":
        raise ValueError(f"tolerations={tolerations!r}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return (NodeTensors(*[t(nt[f]) if f in nt else None
                          for f in NodeTensors._fields]),
            PodBatch(*[t(pb[f]) if f in pb else None
                       for f in PodBatch._fields]))


# --- build -----------------------------------------------------------------

_LOCK = threading.Lock()
_LIB = None
build_info: dict = {}


def build() -> ctypes.CDLL:
    """Compile csrc/taint_ports.cu for sm_90a (once per process; the
    library is cached under _build/ by the source's hash) and load it.
    Fills `build_info` with the seconds it took and ptxas's report."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out, log, seconds = compile_shared(SOURCE, "taint_ports")
        lib = ctypes.CDLL(str(out))
        ptr = ctypes.c_void_p
        lib.ktt_taint_ports.argtypes = (
            [ptr] * 11 + [ctypes.c_int] * 6 + [ctypes.c_uint, ptr])
        lib.ktt_taint_ports.restype = ctypes.c_int
        lib.ktt_block_width.argtypes = [ctypes.c_int] * 4
        lib.ktt_block_width.restype = ctypes.c_int
        lib.ktt_launch_plan.argtypes = [ctypes.c_int] * 6 + [ptr]
        lib.ktt_launch_plan.restype = ctypes.c_int
        lib.ktt_error_string.argtypes = [ctypes.c_int]
        lib.ktt_error_string.restype = ctypes.c_char_p
        build_info.update(seconds=seconds, log=log, library=out.name)
        _LIB = lib
        return lib


# --- the wrapper -----------------------------------------------------------


def launch_plan(nt: NodeTensors, pb: PodBatch) -> dict:
    """The launch taint_ports_masks makes for these tables: grid and
    block shape, shared memory a block and blocks an SM. Builds the
    kernel and needs a card."""
    N, T = nt.taint_key.shape
    P, TL = pb.tol_key.shape
    out = (ctypes.c_int * 6)()
    err = build().ktt_launch_plan(P, N, T, TL, nt.ports.shape[1],
                                  pb.ports.shape[1], out)
    if err != 0:
        raise RuntimeError("taint_ports kernel has no launch for these "
                           f"tables: {build().ktt_error_string(err).decode()}")
    return dict(grid=(out[0], out[1]), block=(out[2], out[3]),
                shared_bytes=out[4], blocks_per_sm=out[5])


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def taint_ports_masks(nt: NodeTensors, pb: PodBatch, *,
                      effects=DEFAULT_EFFECTS):
    """Fused PodToleratesNodeTaints + PodFitsHostPorts -> (taints_ok,
    ports_ok), both bool [P, N]. Drop-in for filters.tolerates_taints /
    filters.host_ports, with the JAX function's signature.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `taint_ports_masks.launches`) or raise."""
    device = nt.taint_key.device
    if device.type == "cpu":
        return taint_ports_plain(nt, pb, effects)
    if device.type != "cuda":
        raise ValueError(f"taint_ports_masks: unsupported device {device}")
    named = (("nt.taint_key", nt.taint_key), ("nt.taint_val", nt.taint_val),
             ("nt.taint_effect", nt.taint_effect), ("nt.ports", nt.ports),
             ("pb.tol_key", pb.tol_key), ("pb.tol_val", pb.tol_val),
             ("pb.tol_op", pb.tol_op), ("pb.tol_effect", pb.tol_effect),
             ("pb.ports", pb.ports))
    for name, t in named:
        _check(name, t, device)
    N, T = nt.taint_key.shape
    PP = nt.ports.shape[1]
    P, TL = pb.tol_key.shape
    PQ = pb.ports.shape[1]
    for name, t, shape in (("nt.taint_val", nt.taint_val, (N, T)),
                           ("nt.taint_effect", nt.taint_effect, (N, T)),
                           ("nt.ports", nt.ports, (N, PP)),
                           ("pb.tol_val", pb.tol_val, (P, TL)),
                           ("pb.tol_op", pb.tol_op, (P, TL)),
                           ("pb.tol_effect", pb.tol_effect, (P, TL)),
                           ("pb.ports", pb.ports, (P, PQ))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if T > MAX_TAINTS or PP > MAX_NODE_PORTS:
        raise ValueError(
            f"taint_ports kernel is built for at most {MAX_TAINTS} taint "
            f"and {MAX_NODE_PORTS} port slots per node, got T={T}, PP={PP}")
    if max(P, N) >= 2**31:
        raise ValueError(f"taint_ports kernel: P={P}, N={N} exceed int32")
    eff_mask = 0
    for e in effects:
        if not 0 <= int(e) < 32:
            raise ValueError(f"taint effect id {e} out of range")
        eff_mask |= 1 << int(e)
    taints = torch.empty((P, N), dtype=torch.bool, device=device)
    ports = torch.empty((P, N), dtype=torch.bool, device=device)
    if P == 0 or N == 0:
        return taints, ports
    lib = build()
    if lib.ktt_block_width(T, PP, TL, PQ) == 0:
        raise ValueError(f"taint_ports kernel: T={T}, PP={PP}, TL={TL}, "
                         f"PQ={PQ} need more shared memory than a block "
                         "can have")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ktt_taint_ports(
        *[t.data_ptr() for _, t in named], taints.data_ptr(),
        ports.data_ptr(), P, N, T, TL, PP, PQ, eff_mask, stream)
    if err != 0:
        raise RuntimeError(
            "taint_ports kernel launch failed: "
            f"{lib.ktt_error_string(err).decode()} (cudaError {err})")
    taint_ports_masks.launches += 1
    return taints, ports


taint_ports_masks.launches = 0
