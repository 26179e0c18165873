"""kubernetes_tpu_torch — the scheduling framework of kubernetes_tpu,
ported to PyTorch and CUDA for an NVIDIA H100.

The JAX package (kubernetes_tpu/) is the reference: the same numpy
inputs go into both and the outputs must be bit-equal. This package
imports nothing of it, and never JAX.

Layout (each module sits under the same path as its counterpart):
  api/      -- object model: Pod, Node, labels/selectors, quantities
  runtime/  -- in-process object store with watch fan-out
  state/    -- scheduler cache, NodeInfo, vocab interning, featurizer,
               the tensor snapshot and its device upload
  ops/      -- the device path: selector programs, filters, scores, the
               wave/round, the gang dispatch, the preemption what-if, and
               the build of the CUDA kernels
  csrc/     -- CUDA C++ sources (taint/host-port, preemption what-if),
               built at first use into _build/
  plugins/  -- the golden host predicates (preemption's victim checks)
  utils/    -- per-pod exponential backoff
  sched/    -- the scheduler: queue, rounds, gangs, preemption, commit

Entry points run on the CUDA card unless asked for the CPU
(device="cpu"); without a card they raise.
"""

__version__ = "0.1.0"
