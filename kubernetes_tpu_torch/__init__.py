"""kubernetes_tpu_torch — the scheduling framework of kubernetes_tpu,
ported to PyTorch and CUDA for an NVIDIA H100.

The JAX package (kubernetes_tpu/) is the reference: the same numpy
inputs go into both and the outputs must be bit-equal. This package
imports nothing of it, and never JAX.

Layout (each module sits under the same path as its counterpart):
  api/      -- object model: Pod, Node, labels/selectors, quantities
  runtime/  -- in-process object store with watch fan-out, informers
  state/    -- scheduler cache, NodeInfo, vocab interning, featurizer,
               the tensor snapshot and its device upload
  ops/      -- the device path: selector programs, filters, scores, the
               wave/round, the gang dispatch, the preemption what-if, the
               telemetry, the zone tally, the autoscaler's simulation,
               the build of the CUDA kernels, and the numpy twin of the
               wave, gang, what-if and telemetry (hostwave.py)
  csrc/     -- CUDA C++ sources (taint/host-port, preemption what-if),
               built at first use into _build/
  plugins/  -- the golden host predicates and priorities, the volume
               predicates, and the profiles and Policy-file registry
  utils/    -- per-pod exponential backoff, metrics, feature gates,
               tracing, the token bucket, fault points, the dispatch
               watchdog
  sched/    -- the scheduler: queue, rounds, gangs, preemption, host
               plugins, the equivalence cache, claim binding, commit;
               the device-path breaker and its ladder (the twin rung,
               poison quarantine); the component configuration
  client/   -- the REST client, the reflectors and their RemoteStore,
               leader election, work queues and event recording
  server/   -- the API server (HTTP REST and watch over the object
               store, admission, authentication and RBAC)
  cli/      -- the kube-scheduler binary (the scheduling loop, leader
               election, the HealthServer's /metrics and /debug/*) and
               the autopilot's train and replay commands
  autopilot/ -- the scheduler autopilot: the round-ledger dataset, the
               ridge trainer, the replay CI and the promotion controller
               (shadow gate, replay, promote, regression watch)
  chaos/    -- the cluster-invariant checker the scheduler runs after
               each round when armed
  cloud/    -- node groups and the fake cloud the autoscaler sizes
  controllers/ -- the node-lifecycle controller (zone tally on the
               device) and the cluster autoscaler (what-ifs through the
               wave and the gang on a shadow snapshot)

Entry points run on the CUDA card unless asked for the CPU
(device="cpu"); without a card they raise.
"""

__version__ = "0.1.0"
