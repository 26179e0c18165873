"""Node agent — the reference's pkg/kubelet at capability level.

A copy of kubernetes_tpu/kubelet/__init__.py; its relative imports
resolve in this package.

Kubelet runs one node: it admits pods the scheduler binds to it
(re-running the scheduler's GeneralPredicates, pkg/kubelet/lifecycle/
predicate.go), drives them to Running against a container runtime
(fake/hollow by default — pkg/kubemark/hollow_kubelet.go), relays
runtime lifecycle events (PLEG), probes containers, evicts under
resource pressure, and heartbeats node status for the nodelifecycle
controller's failure detection.
"""

from .runtime import ContainerState, FakeRuntime
from .kubelet import Kubelet
