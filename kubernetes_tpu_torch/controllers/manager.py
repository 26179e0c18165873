"""Controller manager: wire and run the full controller roster.

A copy of kubernetes_tpu/controllers/manager.py; its relative imports
resolve in this package. The one change is `device=`: the controllers
whose work runs on a device (ON_DEVICE, today the node-lifecycle
controller's zone tally) run on it. None means the CUDA card, as
everywhere in the port, and raises where there is none; tests pass
"cpu".

Reference: cmd/kube-controller-manager/app/controllermanager.go
(StartControllers:346 — instantiate every enabled controller against the
shared informer factory, start each with its worker count, optionally
behind leader election).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..client.leaderelection import LeaderElector
from .base import Controller
from .cronjob import CronJobController
from .daemonset import DaemonSetController
from .deployment import DeploymentController
from .disruption import DisruptionController
from .endpoints import EndpointsController
from .garbagecollector import GarbageCollector
from .job import JobController
from .namespace import NamespaceController
from .nodelifecycle import NodeLifecycleController
from .podgc import PodGCController
from .replicaset import ReplicaSetController, ReplicationControllerController
from .resourcequota import ResourceQuotaController
from .serviceaccount import ServiceAccountController
from .attachdetach import AttachDetachController
from .certificates import CSRApprovingController, CSRSigningController
from .podautoscaler import HorizontalPodAutoscalerController
from .statefulset import StatefulSetController
from .ttl import TTLController
from .expand import ExpandController
from .volumebinding import PersistentVolumeController
from .bootstrap import BootstrapSignerController, TokenCleanerController
from .clusterroleaggregation import ClusterRoleAggregationController
from .storageprotection import (PVCProtectionController,
                                PVProtectionController)

DEFAULT_CONTROLLERS = [
    ReplicaSetController, ReplicationControllerController,
    DeploymentController, StatefulSetController, DaemonSetController,
    JobController, CronJobController, EndpointsController,
    NodeLifecycleController, DisruptionController, NamespaceController,
    PodGCController, GarbageCollector, ResourceQuotaController,
    ServiceAccountController, PersistentVolumeController,
    AttachDetachController, HorizontalPodAutoscalerController,
    TTLController, CSRApprovingController, CSRSigningController,
    BootstrapSignerController, TokenCleanerController,
    ClusterRoleAggregationController, PVCProtectionController,
    PVProtectionController, ExpandController,
]

# the roster's controllers that take the manager's device
ON_DEVICE = (NodeLifecycleController,)


def default_controllers() -> List[type]:
    """DEFAULT_CONTROLLERS + server-side loops whose modules import the
    controller base (lazy to break the package import cycle)."""
    from ..server.aggregator import APIServiceAvailabilityController

    return DEFAULT_CONTROLLERS + [APIServiceAvailabilityController]


class ControllerManager:
    def __init__(self, store, controllers: Optional[List[type]] = None,
                 identity: str = "controller-manager",
                 leader_elect: bool = False, cloud=None,
                 cluster_cidr: str = "", metrics_scraper: bool = False,
                 kubelet_client_ctx=None, scheduler=None,
                 node_eviction_rate: Optional[float] = None,
                 secondary_node_eviction_rate: Optional[float] = None,
                 large_cluster_size_threshold: Optional[int] = None,
                 unhealthy_zone_threshold: Optional[float] = None,
                 device=None):
        self.store = store
        self.controllers: Dict[str, Controller] = {}
        for cls in (controllers if controllers is not None
                    else default_controllers()):
            c = (cls(store, device=device) if issubclass(cls, ON_DEVICE)
                 else cls(store))
            self.controllers[c.name] = c
        # eviction storm-control knobs (kube-controller-manager
        # --node-eviction-rate / --secondary-node-eviction-rate /
        # --large-cluster-size-threshold / --unhealthy-zone-threshold)
        nlc = self.controllers.get("nodelifecycle")
        if nlc is not None and hasattr(nlc, "configure"):
            nlc.configure(
                eviction_rate_qps=node_eviction_rate,
                secondary_eviction_rate_qps=secondary_node_eviction_rate,
                large_cluster_threshold=large_cluster_size_threshold,
                unhealthy_zone_threshold=unhealthy_zone_threshold)
        if metrics_scraper:
            # the metrics-server runs OUTSIDE kube-controller-manager in
            # the reference (a separate deployment scraping
            # /stats/summary); opt-in here so embedded clusters can get
            # the full kubelet-stats -> PodMetrics -> HPA/top pipeline
            # from one constructor. TLS kubelets need the apiserver's
            # kubelet-client credential as kubelet_client_ctx.
            from .metricsserver import MetricsServerController
            c = MetricsServerController(store,
                                        ssl_context=kubelet_client_ctx)
            self.controllers[c.name] = c
        # cloud-dependent loops start only when a provider is configured
        # (controllermanager.go gates these on --cloud-provider)
        if cluster_cidr:
            from .nodeipam import NodeIpamController
            c = NodeIpamController(store, cluster_cidr)
            self.controllers[c.name] = c
        if cloud is not None:
            from .cloud_node import CloudNodeController
            from .route import RouteController
            from .service_lb import ServiceLBController
            for c in (ServiceLBController(store, cloud),
                      CloudNodeController(store, cloud)):
                self.controllers[c.name] = c
            if cloud.routes() is not None:
                c = RouteController(store, cloud)
                self.controllers[c.name] = c
            # the cluster autoscaler needs BOTH a sizable cloud (node
            # groups) and the scheduler's simulation hooks — it runs off
            # the live snapshot/queue, so a bare store isn't enough
            # (the reference ships it as a separate binary for the same
            # reason: it is a scheduler-shaped consumer of cluster state)
            if scheduler is not None and cloud.node_groups() is not None:
                from .clusterautoscaler import ClusterAutoscaler
                c = ClusterAutoscaler(store, cloud, scheduler)
                self.controllers[c.name] = c
        self.elector = LeaderElector(
            store, identity, lock_name="kube-controller-manager",
            on_started_leading=self._start_all) if leader_elect else None
        self._gc_timer: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def __getitem__(self, name: str) -> Controller:
        return self.controllers[name]

    # -- synchronous drive (tests / deterministic mode) ------------------------

    def sync_all(self, rounds: int = 3) -> int:
        """Drain every controller queue repeatedly (controllers feed each
        other: deployment -> replicaset -> pods -> endpoints...)."""
        n = 0
        for _ in range(rounds):
            for c in self.controllers.values():
                n += c.sync_all()
            gc = self.controllers.get("garbagecollector")
            if gc is not None:
                gc.sweep()
            podgc = self.controllers.get("podgc")
            if podgc is not None:
                podgc.gc()
            time.sleep(0.02)  # let rate-limited requeues land for next round
        return n

    # -- background mode -------------------------------------------------------

    def start(self, workers: int = 2, sweep_period: float = 20.0):
        if self.elector is not None:
            self.elector.start()
        else:
            self._start_all(workers=workers, sweep_period=sweep_period)
        return self

    def _start_all(self, workers: int = 2, sweep_period: float = 20.0):
        for c in self.controllers.values():
            c.run(workers)

        def sweeper():
            while not self._stop.is_set():
                gc = self.controllers.get("garbagecollector")
                if gc is not None:
                    gc.sweep()
                podgc = self.controllers.get("podgc")
                if podgc is not None:
                    podgc.gc()
                self._stop.wait(sweep_period)

        self._gc_timer = threading.Thread(target=sweeper, daemon=True,
                                          name="gc-sweeper")
        self._gc_timer.start()

    def stop(self):
        self._stop.set()
        if self.elector is not None:
            self.elector.stop()
        for c in self.controllers.values():
            c.stop()
