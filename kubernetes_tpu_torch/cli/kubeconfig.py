"""kubeconfig files — the client configuration format every kubectl
user carries.

A copy of kubernetes_tpu/cli/kubeconfig.py; its relative imports
resolve in this package.

Reference: client-go tools/clientcmd (api/types.go Config: clusters,
users (AuthInfo), contexts, current-context; loader.go precedence rules;
inline *-data fields are base64). kubeadm writes admin.conf from the
cluster CA + admin credential (cmd/kubeadm/app/phases/kubeconfig);
kubectl loads $KUBECONFIG (else ~/.kube/config) when --server is absent,
with flags overriding file values — the same precedence clientcmd's
DeferredLoadingClientConfig implements.
"""

from __future__ import annotations

import base64
import os
from typing import Optional


def _b64(s: Optional[str]) -> Optional[str]:
    return base64.b64encode(s.encode()).decode() if s else None


def _unb64(s: Optional[str]) -> Optional[str]:
    return base64.b64decode(s).decode() if s else None


def new(cluster: str, server: str, ca_pem: Optional[str] = None,
        user: str = "kubernetes-admin", token: Optional[str] = None,
        client_cert_pem: Optional[str] = None,
        client_key_pem: Optional[str] = None,
        namespace: str = "") -> dict:
    """A single-context Config (what `kubeadm init` emits as
    admin.conf)."""
    ctx = f"{user}@{cluster}"
    user_entry = {}
    if token:
        user_entry["token"] = token
    if client_cert_pem:
        user_entry["client-certificate-data"] = _b64(client_cert_pem)
    if client_key_pem:
        user_entry["client-key-data"] = _b64(client_key_pem)
    cluster_entry = {"server": server}
    if ca_pem:
        cluster_entry["certificate-authority-data"] = _b64(ca_pem)
    context_entry = {"cluster": cluster, "user": user}
    if namespace:
        context_entry["namespace"] = namespace
    return {"apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": cluster, "cluster": cluster_entry}],
            "users": [{"name": user, "user": user_entry}],
            "contexts": [{"name": ctx, "context": context_entry}],
            "current-context": ctx}


def load(path: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if cfg.get("kind", "Config") != "Config":
        raise ValueError(f"{path} is not a kubeconfig (kind "
                         f"{cfg.get('kind')!r})")
    for key in ("clusters", "users", "contexts"):
        cfg.setdefault(key, [])
    return cfg


def save(path: str, cfg: dict) -> None:
    import yaml

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


def default_path() -> str:
    """$KUBECONFIG else ~/.kube/config (loader.go defaults; the
    multi-file KUBECONFIG merge collapses to first-path-wins here)."""
    env = os.environ.get("KUBECONFIG")
    if env:
        return env.split(os.pathsep)[0]
    return os.path.join(os.path.expanduser("~"), ".kube", "config")


def _by_name(entries, name):
    return next((e for e in entries if e.get("name") == name), None)


def resolve(cfg: dict, context: Optional[str] = None) -> dict:
    """Config (+ optional context override) -> connection parameters:
    {server, ca_pem, client_cert_pem, client_key_pem, token, namespace}.
    Raises ValueError when the context graph dangles."""
    ctx_name = context or cfg.get("current-context")
    if not ctx_name:
        raise ValueError("kubeconfig has no current-context")
    ctx = _by_name(cfg.get("contexts", []), ctx_name)
    if ctx is None:
        raise ValueError(f"context {ctx_name!r} not found")
    c = ctx.get("context", {})
    cl = _by_name(cfg.get("clusters", []), c.get("cluster"))
    if cl is None:
        raise ValueError(f"cluster {c.get('cluster')!r} not found")
    u = _by_name(cfg.get("users", []), c.get("user")) or {"user": {}}
    cluster = cl.get("cluster", {})
    user = u.get("user", {})
    return {"server": cluster.get("server"),
            "ca_pem": _unb64(cluster.get("certificate-authority-data")),
            "client_cert_pem": _unb64(user.get("client-certificate-data")),
            "client_key_pem": _unb64(user.get("client-key-data")),
            "token": user.get("token"),
            "namespace": c.get("namespace", "")}
