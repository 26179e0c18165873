"""ServiceAccount controller: ensure 'default' SA per namespace.

A copy of kubernetes_tpu/controllers/serviceaccount.py; its relative imports
resolve in this package.

Reference: pkg/controller/serviceaccount/serviceaccounts_controller.go
(syncNamespace:178 — every active namespace gets the default
ServiceAccount; the tokens controller pairs each SA with a token
Secret, tokens_controller.go).
"""

from __future__ import annotations

from ..api import types as api
from ..runtime.store import Conflict
from .base import Controller


class ServiceAccountController(Controller):
    name = "serviceaccount"

    def __init__(self, store):
        super().__init__(store)
        self._ca = None
        self.informer("namespaces",
                      enqueue_fn=lambda o: self.queue.add(
                          f"ns:{o.metadata.name}"))
        # tokens controller half (tokens_controller.go): every SA gets a
        # signed token Secret, including user-created SAs
        self.informer("serviceaccounts",
                      enqueue_fn=lambda o: self.queue.add(
                          f"sa:{o.metadata.namespace}/{o.metadata.name}"))

    def _sa_key(self) -> str:
        if self._ca is None:
            from ..server import pki

            self._ca = pki.ensure_cluster_ca(self.store)
        return self._ca.sa_signing_key

    def _ensure_token(self, sa: api.ServiceAccount):
        """Mint a real SA JWT (pkg/serviceaccount/jwt.go) bound to the
        SA's uid and the Secret's name; the apiserver's authenticator
        verifies both liveness conditions."""
        from ..server import serviceaccount as sat

        secret_name = f"{sa.metadata.name}-token"
        ns = sa.metadata.namespace
        existing = self.store.get("secrets", ns, secret_name)
        if existing is not None:
            # a recreated SA (new uid) invalidates the old token — the
            # authenticator rejects the uid mismatch — so the Secret
            # must be re-minted, not kept (tokens_controller.go deletes
            # secrets of deleted SAs; this covers the recreate race too)
            claims = sat.claims_of(existing.data.get("token", ""))
            if claims is None or claims.get(
                    "kubernetes.io/serviceaccount/service-account.uid") \
                    != sa.metadata.uid:
                try:
                    self.store.delete("secrets", ns, secret_name)
                except KeyError:
                    pass
                existing = None
        if existing is None:
            token = sat.mint(self._sa_key(), ns, sa.metadata.name,
                             sa.metadata.uid, secret_name)
            try:
                self.store.create("secrets", api.Secret(
                    metadata=api.ObjectMeta(name=secret_name, namespace=ns),
                    type="kubernetes.io/service-account-token",
                    data={"token": token}))
            except Conflict:
                pass
        if secret_name not in sa.secrets:
            sa.secrets.append(secret_name)
            try:
                self.store.update("serviceaccounts", sa)
            except Conflict:
                pass

    def sync(self, key: str):
        kind, _, rest = key.partition(":")
        if kind == "sa":
            ns, _, name = rest.partition("/")
            sa = self.store.get("serviceaccounts", ns, name)
            if sa is not None:
                self._ensure_token(sa)
            return
        # namespace event: ensure the default SA exists
        name = rest or key  # bare keys tolerated (tests enqueue names)
        ns_obj = (self.store.get("namespaces", "", name)
                  or self.store.get("namespaces", "default", name))
        if ns_obj is None or ns_obj.status.phase != "Active":
            return
        if self.store.get("serviceaccounts", name, "default") is not None:
            return
        sa = api.ServiceAccount(
            metadata=api.ObjectMeta(name="default", namespace=name))
        try:
            self.store.create("serviceaccounts", sa)
        except Conflict:
            return
        self._ensure_token(sa)
