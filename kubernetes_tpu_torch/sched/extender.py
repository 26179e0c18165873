"""Out-of-process scheduler extender over HTTP/JSON.

Behavioral analog of the reference's HTTPExtender
(pkg/scheduler/core/extender.go:42): Filter / Prioritize / Bind /
ProcessPreemption webhooks called from the host side of a wave. The wire
schema mirrors pkg/scheduler/api/types.go (ExtenderArgs,
ExtenderFilterResult, HostPriorityList, ExtenderBindingArgs,
ExtenderPreemptionArgs) in snake-free JSON.

A copy of kubernetes_tpu/sched/extender.py: the request bodies are the
JAX package's key for key and in the same order, so an extender sees the
same bytes from either scheduler. The calls run on the host between
featurize and the dispatch: Filter tightens the wave's host mask,
Prioritize adds into the kernel's extra_scores plane (`HostExtra`), and
Bind runs inside the bind reconciler's attempt.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import types as api


def _pod_ref(pod: api.Pod) -> dict:
    return {"name": pod.metadata.name, "namespace": pod.namespace,
            "uid": pod.uid}


class ExtenderError(Exception):
    pass


class HTTPExtender:
    """One extender endpoint (reference core/extender.go:42 HTTPExtender;
    config schema pkg/scheduler/api/types.go ExtenderConfig)."""

    def __init__(self, url_prefix: str, filter_verb: str = "",
                 prioritize_verb: str = "", bind_verb: str = "",
                 preempt_verb: str = "", weight: int = 1,
                 enable_https: bool = False, http_timeout: float = 5.0,
                 node_cache_capable: bool = False, ignorable: bool = False):
        self.url_prefix = url_prefix.rstrip("/")
        self.filter_verb = filter_verb
        self.prioritize_verb = prioritize_verb
        self.bind_verb = bind_verb
        self.preempt_verb = preempt_verb
        self.weight = weight
        self.http_timeout = http_timeout
        self.node_cache_capable = node_cache_capable
        # an ignorable extender must not fail scheduling when unreachable
        self.ignorable = ignorable

    @classmethod
    def from_config(cls, cfg: dict) -> "HTTPExtender":
        """cfg: ExtenderConfig JSON map (pkg/scheduler/api/types.go)."""
        return cls(
            url_prefix=cfg["urlPrefix"],
            filter_verb=cfg.get("filterVerb", ""),
            prioritize_verb=cfg.get("prioritizeVerb", ""),
            bind_verb=cfg.get("bindVerb", ""),
            preempt_verb=cfg.get("preemptVerb", ""),
            weight=cfg.get("weight", 1),
            http_timeout=cfg.get("httpTimeout", 5.0),
            node_cache_capable=cfg.get("nodeCacheCapable", False),
            ignorable=cfg.get("ignorable", False),
        )

    # -- transport (reference: extender.go:375 send) --------------------------

    def _send(self, verb: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.url_prefix}/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.http_timeout) as resp:
            if resp.status != 200:
                raise ExtenderError(f"{verb}: HTTP {resp.status}")
            return json.loads(resp.read().decode())

    # -- verbs ----------------------------------------------------------------

    def filter(self, pod: api.Pod, node_names: Sequence[str],
               node_labels: Optional[Dict[str, Dict[str, str]]] = None
               ) -> Tuple[List[str], Dict[str, str]]:
        """reference extender.go:246 Filter. Returns (feasible node names,
        failed node -> reason). Both wire modes: a nodeCacheCapable
        extender exchanges node names; a legacy one also gets Node
        objects (name and labels) and may answer with a `nodes` item list
        instead of `nodenames` (reference extender.go:268-297). An
        `error` in the answer raises even when the extender is
        ignorable."""
        if not self.filter_verb:
            return list(node_names), {}
        args = {"pod": _pod_ref(pod), "nodenames": list(node_names)}
        if not self.node_cache_capable:
            args["nodes"] = {"items": [
                {"metadata": {"name": n,
                              "labels": (node_labels or {}).get(n, {})}}
                for n in node_names]}
        try:
            result = self._send(self.filter_verb, args)
        except ExtenderError:
            raise
        except Exception as e:
            if self.ignorable:
                return list(node_names), {}
            raise ExtenderError(f"extender {self.url_prefix} filter: {e}")
        if result.get("error"):
            raise ExtenderError(result["error"])
        if result.get("nodenames") is not None:
            feasible = list(result["nodenames"])
        elif result.get("nodes") is not None:
            feasible = [item["metadata"]["name"]
                        for item in result["nodes"].get("items", [])]
        else:
            feasible = []
        return feasible, dict(result.get("failedNodes", {}))

    def prioritize(self, pod: api.Pod, node_names: Sequence[str]
                   ) -> Dict[str, float]:
        """reference extender.go:306 Prioritize. Returns node -> weighted
        score contribution (a Python float, already multiplied by this
        extender's weight, as generic_scheduler.go:660 does)."""
        if not self.prioritize_verb:
            return {}
        args = {"pod": _pod_ref(pod), "nodenames": list(node_names)}
        try:
            result = self._send(self.prioritize_verb, args)
        except Exception as e:
            if self.ignorable:
                return {}
            raise ExtenderError(f"extender {self.url_prefix} prioritize: {e}")
        return {hp["host"]: float(hp["score"]) * self.weight
                for hp in result or []}

    def bind(self, pod: api.Pod, node_name: str) -> None:
        """reference extender.go:348 Bind: delegates the binding POST.
        Never ignorable: a transport error (an HTTP error status too)
        raises to the bind reconciler, which retries it."""
        result = self._send(self.bind_verb, {
            "podName": pod.metadata.name, "podNamespace": pod.namespace,
            "podUID": pod.uid, "node": node_name})
        if result and result.get("error"):
            raise ExtenderError(result["error"])

    def supports_preemption(self) -> bool:
        return bool(self.preempt_verb)

    def process_preemption(self, pod: api.Pod,
                           victims_by_node: Dict[str, List[api.Pod]]
                           ) -> Dict[str, List[str]]:
        """reference extender.go ProcessPreemption: the extender may trim
        the candidate node -> victims map. Returns node -> victim uids."""
        args = {"pod": _pod_ref(pod),
                "nodeNameToVictims": {
                    n: {"pods": [_pod_ref(v) for v in vs]}
                    for n, vs in victims_by_node.items()}}
        result = self._send(self.preempt_verb, args)
        out: Dict[str, List[str]] = {}
        for n, v in (result.get("nodeNameToVictims") or {}).items():
            out[n] = [p["uid"] for p in v.get("pods", [])]
        return out
