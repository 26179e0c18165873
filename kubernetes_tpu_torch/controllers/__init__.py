"""Control loops — the reference's pkg/controller/ layer.

Each controller is an informer+workqueue reconciliation loop
(controller pattern: SharedInformer handlers enqueue keys, workers pop
and sync to desired state; pkg/controller/*). The set mirrors the
kube-controller-manager's roster at the capability level: workloads
(ReplicaSet/RC, Deployment, StatefulSet, DaemonSet, Job, CronJob),
services (Endpoints), node failure detection (NodeLifecycle), disruption
budgets, namespace lifecycle, garbage collection (owner references +
terminated-pod GC), resource quota accounting, service accounts, and
PV/PVC binding.

A copy of kubernetes_tpu/controllers/__init__.py: it exports what the
reference's does. The node-lifecycle controller's zone tally and the
cluster autoscaler's what-ifs run on the port's device.
"""

from .base import Controller, is_pod_active, is_pod_ready, pod_owned_by
from .replicaset import ReplicaSetController, ReplicationControllerController
from .deployment import DeploymentController
from .statefulset import StatefulSetController
from .daemonset import DaemonSetController
from .job import JobController
from .cronjob import CronJobController
from .endpoints import EndpointsController
from .nodelifecycle import NodeLifecycleController
from .disruption import DisruptionController
from .namespace import NamespaceController
from .podgc import PodGCController
from .garbagecollector import GarbageCollector
from .resourcequota import ResourceQuotaController
from .serviceaccount import ServiceAccountController
from .expand import ExpandController
from .volumebinding import PersistentVolumeController
from .attachdetach import AttachDetachController
from .podautoscaler import HorizontalPodAutoscalerController
from .ttl import TTLController
from .certificates import CSRApprovingController, CSRSigningController
from .nodeipam import NodeIpamController
from .route import RouteController
from .service_lb import ServiceLBController
from .cloud_node import CloudNodeController
from .clusterautoscaler import ClusterAutoscaler
from .manager import ControllerManager
