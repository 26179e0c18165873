"""Control loops: the informer + workqueue reconciliation base and the
two cluster-lifecycle controllers the port carries, the node-lifecycle
controller (zone-aware failure detection and eviction storm control,
its zone tally on the device) and the cluster autoscaler (scale-up and
scale-down what-ifs through the port's wave and gang). The rest of
kubernetes_tpu/controllers/ is not ported.
"""

from .base import Controller, is_pod_active, is_pod_ready, pod_owned_by  # noqa: F401
from .clusterautoscaler import ClusterAutoscaler  # noqa: F401
from .nodelifecycle import NodeLifecycleController  # noqa: F401
