"""Hollow nodes + cluster harness.

A copy of kubernetes_tpu/kubemark/hollow.py; its relative imports
resolve in this package.

HollowNode = real Kubelet over FakeRuntime (+ optionally the real
Proxier): the kubemark recipe (pkg/kubemark/hollow_kubelet.go runs real
kubelet logic against a fake Docker client). HollowCluster boots N of
them against one store/apiserver and offers the load-generation
strategies of test/utils/runners.go (steady pod creation at a target
QPS, random deletion churn).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..api import types as api
from ..kubelet import FakeRuntime, Kubelet
from ..proxy import Proxier


class HollowNode:
    def __init__(self, store, name: str,
                 allocatable: Optional[Dict[str, int]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 with_proxy: bool = False,
                 start_latency: float = 0.0,
                 heartbeat_period: float = 10.0,
                 serve: bool = False, tls=None, clock=None):
        """serve=True starts the kubelet HTTP(S) server (logs/exec
        plane) — what `kubectl logs` reaches through the apiserver
        proxy; tls (a pki.ClusterCA) makes it mTLS-only."""
        self.name = name
        self.runtime = FakeRuntime(start_latency=start_latency)
        kw = {"clock": clock} if clock is not None else {}
        self.kubelet = Kubelet(store, name, allocatable=allocatable,
                               labels=labels, runtime=self.runtime,
                               heartbeat_period=heartbeat_period, **kw)
        if serve:
            self.kubelet.serve(tls=tls)
        self.proxy = Proxier(store, node_name=name) if with_proxy else None

    def run(self, period: float = 1.0) -> "HollowNode":
        self.kubelet.run(period=period)
        if self.proxy is not None:
            self.proxy.run(period=period)
        return self

    def sync_once(self, now: Optional[float] = None):
        self.kubelet.sync_once(now)
        if self.proxy is not None:
            self.proxy.sync_proxy_rules()

    def stop(self):
        self.kubelet.stop()
        if self.proxy is not None:
            self.proxy.stop()


class HollowCluster:
    """N hollow nodes + load generation over one store."""

    def __init__(self, store, n_nodes: int,
                 zones: int = 3,
                 racks: int = 0,
                 generations: int = 0,
                 allocatable: Optional[Dict[str, int]] = None,
                 with_proxy: bool = False,
                 heartbeat_period: float = 10.0, clock=None):
        """racks>0 stamps each node with rack/superpod topology labels
        (rack-{i%racks} nested under a superpod per racks-pair);
        generations>0 stamps accelerator-generation labels cycling
        gen 1..generations — both feed the dense topology columns
        (state/snapshot.py rack_id/superpod_id/accel_gen)."""
        self.store = store
        alloc = allocatable or api.resource_list(cpu="16", memory="32Gi",
                                                 pods=110,
                                                 ephemeral_storage="200Gi")
        self.nodes: List[HollowNode] = []
        for i in range(n_nodes):
            labels = {
                api.LABEL_HOSTNAME: f"hollow-{i}",
                api.LABEL_ZONE: f"zone-{i % zones}",
            }
            if racks > 0:
                labels[api.LABEL_RACK] = f"rack-{i % racks}"
                labels[api.LABEL_SUPERPOD] = f"sp-{(i % racks) // 2}"
            if generations > 0:
                labels[api.LABEL_ACCEL_GEN] = str(1 + i % generations)
            self.nodes.append(HollowNode(
                store, f"hollow-{i}", allocatable=dict(alloc), labels=labels,
                with_proxy=with_proxy and i == 0,
                heartbeat_period=heartbeat_period, clock=clock))
        self._stop = threading.Event()

    def run(self, period: float = 1.0) -> "HollowCluster":
        for n in self.nodes:
            n.run(period=period)
        return self

    def sync_once(self):
        for n in self.nodes:
            n.sync_once()

    def stop(self):
        self._stop.set()
        for n in self.nodes:
            n.stop()

    # -- network partition (zone disruption chaos helper) ----------------------

    def partition(self, zone: Optional[str] = None, fraction: float = 1.0,
                  names: Optional[List[str]] = None) -> List[str]:
        """Sever a fraction of a zone (or an explicit node list): the
        chosen kubelets freeze entirely — no heartbeats, no status
        writes — modeling a rack switch flap / network partition. The
        nodelifecycle controller's zone disruption machinery is the
        thing under test: 100% of a zone severed must SUSPEND eviction
        (FullDisruption), a minority severed must drain at the
        configured rate. Returns the severed node names (pass them to
        heal())."""
        if names is not None:
            targets = [n for n in self.nodes if n.name in set(names)]
        elif zone is not None:
            targets = [n for n in self.nodes
                       if n.kubelet.labels.get(api.LABEL_ZONE) == zone]
        else:
            targets = list(self.nodes)
        k = min(len(targets), max(0, int(round(len(targets) * fraction))))
        cut = targets[:k]  # deterministic prefix: tests know the victims
        for n in cut:
            n.kubelet.partitioned = True
        return [n.name for n in cut]

    def heal(self, names: Optional[List[str]] = None) -> None:
        """Undo partition(): heartbeats resume on the next sync."""
        wanted = None if names is None else set(names)
        for n in self.nodes:
            if wanted is None or n.name in wanted:
                n.kubelet.partitioned = False

    # -- load generation (test/utils/runners.go strategies) --------------------

    def create_pods(self, n: int, prefix: str = "load",
                    qps: Optional[float] = None,
                    pod_factory=None) -> int:
        """Create n pods, optionally paced at qps (LOAD_TEST_THROUGHPUT
        pacing, test/e2e/scalability/load.go:124)."""
        created = 0
        interval = (1.0 / qps) if qps else 0.0
        for i in range(n):
            if self._stop.is_set():
                break
            pod = (pod_factory(i) if pod_factory else api.Pod(
                metadata=api.ObjectMeta(name=f"{prefix}-{i}",
                                        labels={"type": prefix}),
                spec=api.PodSpec(containers=[api.Container(
                    resources=api.ResourceRequirements(
                        requests=api.resource_list(cpu="100m",
                                                   memory="128Mi")))])))
            self.store.create("pods", pod)
            created += 1
            if interval:
                time.sleep(interval)
        return created

    def churn(self, deletions: int, rng) -> int:
        """Random bound-pod deletion (chaos/load mix)."""
        pods = [p for p in self.store.list("pods") if p.spec.node_name]
        rng.shuffle(pods)
        n = 0
        for p in pods[:deletions]:
            try:
                self.store.delete("pods", p.metadata.namespace,
                                  p.metadata.name)
                n += 1
            except KeyError:
                pass
        return n

    def wait_running(self, want: int, timeout: float = 60.0) -> int:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            running = sum(1 for p in self.store.list("pods")
                          if p.status.phase == "Running")
            if running >= want:
                return running
            time.sleep(0.1)
        return sum(1 for p in self.store.list("pods")
                   if p.status.phase == "Running")
