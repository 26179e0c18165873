"""Metrics server: kubelet /stats/summary -> PodMetrics API objects.

A copy of kubernetes_tpu/controllers/metricsserver.py; its relative imports
resolve in this package.

Reference: the metrics pipeline the 1.11 tree consumes — kubelets
aggregate cgroup stats into the Summary API (pkg/kubelet/server/stats/
summary.go, apis/stats/v1alpha1) and the out-of-tree metrics-server
scrapes every node's /stats/summary, publishing PodMetrics under
metrics.k8s.io for the HPA's REST metrics client
(pkg/controller/podautoscaler/metrics/) and kubectl top. This
controller is that scraper: per node key, GET the kubelet's summary
and upsert one PodMetrics per pod (usage: cpu millicores, memory
bytes — the units podautoscaler.py and cli/kubectl.py cmd_top read).

Nodes without a published daemon endpoint (no kubelet server) are
skipped. TLS clusters pass the scraper a client SSL context holding
the apiserver's kubelet-client identity, the same credential the
apiserver's exec/log proxy presents.
"""

from __future__ import annotations

import json
import urllib.request

from ..api import resources as res
from ..api import types as api
from .base import Controller


class MetricsServerController(Controller):
    name = "metrics-server"

    def __init__(self, store, ssl_context=None, timeout: float = 5.0):
        super().__init__(store)
        self.ssl_context = ssl_context
        self.timeout = timeout
        self.informer("nodes")
        # metrics follow their pod's lifetime: a deleted pod's
        # PodMetrics goes with it (the GC skips podmetrics — they have
        # no ownerReferences — so this controller owns the cleanup).
        # Event handlers only enqueue; the mutation happens in sync()
        # like every other controller (no store writes during dispatch).
        self.informer("pods", on_add=lambda o: None,
                      on_update=lambda o, n: None,
                      on_delete=lambda p: self.enqueue(
                          f"pod-deleted:{p.metadata.namespace}"
                          f"/{p.metadata.name}"))

    def resync(self):
        for node in self.store.list("nodes"):
            self.enqueue(node)
        # one GLOBAL orphan sweep per resync period (not per node):
        # metrics whose pod vanished while this controller wasn't
        # watching (restart, missed event) go through the same
        # pod-deleted sync path the informer uses
        for pm in self.store.list("podmetrics"):
            ns, pm_name = pm.metadata.namespace, pm.metadata.name
            if self.store.get("pods", ns, pm_name) is None:
                self.enqueue(f"pod-deleted:{ns}/{pm_name}")

    def _scrape(self, host: str, port: int) -> dict:
        scheme_ = "https" if self.ssl_context is not None else "http"
        url = f"{scheme_}://{host}:{port}/stats/summary"
        with urllib.request.urlopen(url, timeout=self.timeout,
                                    context=self.ssl_context) as resp:
            return json.loads(resp.read())

    def sync(self, key: str):
        if key.startswith("pod-deleted:"):
            ns, pod_name = key[len("pod-deleted:"):].split("/", 1)
            if self.store.get("podmetrics", ns, pod_name) is not None:
                self.store.delete("podmetrics", ns, pod_name)
            return
        from ..utils.net import node_daemon_endpoint

        _, name = key.split("/", 1)
        ep = node_daemon_endpoint(self.store, name)
        if ep is None:
            return
        summary = self._scrape(*ep)
        scraped = set()
        for pod_doc in summary.get("pods", []):
            ref = pod_doc.get("podRef", {})
            ns, pod_name = ref.get("namespace", "default"), ref.get("name")
            if not pod_name:
                continue
            scraped.add((ns, pod_name))
            usage = {
                res.CPU: int(pod_doc.get("cpu", {})
                             .get("usageNanoCores", 0)) // 1_000_000,
                res.MEMORY: int(pod_doc.get("memory", {})
                                .get("workingSetBytes", 0)),
            }
            cur = self.store.get("podmetrics", ns, pod_name)
            if cur is None:
                self.store.create("podmetrics", api.PodMetrics(
                    metadata=api.ObjectMeta(name=pod_name, namespace=ns),
                    usage=usage))
            elif cur.usage != usage:
                cur.usage = usage
                self.store.update("podmetrics", cur)
        # No per-node stale sweep: the summary reports EVERY pod bound
        # to the node (stopped containers scrape as zero usage), so
        # `scraped` covers this node's pods; deleted pods are cleaned by
        # the pod-delete informer and the resync orphan sweep. Scanning
        # cluster-wide podmetrics here would cost O(nodes x podmetrics)
        # store reads per resync round at kubemark scale.
        del scraped
