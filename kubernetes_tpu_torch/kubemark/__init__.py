"""kubemark: hollow nodes for scale testing without machines.

A copy of kubernetes_tpu/kubemark/__init__.py; its relative imports
resolve in this package.

Reference: pkg/kubemark + cmd/kubemark (hollow_kubelet.go:50 — the REAL
kubelet code against a fake container runtime; hollow_proxy.go:48 — the
proxier with a no-op dataplane) and test/kubemark/start-kubemark.sh
which boots hundreds of them. Here a HollowNode is the framework's real
Kubelet + Proxier over FakeRuntime; HollowCluster manages N of them plus
a churn generator (test/utils/runners.go load strategies).
"""

from .hollow import HollowCluster, HollowNode
