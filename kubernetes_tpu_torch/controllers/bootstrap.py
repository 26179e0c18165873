"""Bootstrap-token machinery: signer + cleaner + the token authenticator
helpers.

A copy of kubernetes_tpu/controllers/bootstrap.py; its relative imports
resolve in this package.

Reference: pkg/controller/bootstrap/ — BootstrapSigner (bootstrapsigner
.go) maintains detached JWS signatures over the kube-public cluster-info
ConfigMap, one per active bootstrap token, so a joiner holding only its
token can VERIFY the CA bundle it discovers instead of trusting first
use; TokenCleaner (tokencleaner.go) deletes expired bootstrap-token
Secrets. Tokens are kube-system Secrets of type
bootstrap.kubernetes.io/token with token-id/token-secret/expiration
(the "abcdef.0123456789abcdef" id.secret wire form), exactly the shape
the reference's bootstrap token authenticator consumes
(plugin/pkg/auth/authenticator/token/bootstrap/bootstrap.go).

The signature is HMAC-SHA256 over the ca.crt payload keyed by the
token's secret — the reference uses detached JWS with the same key
material; the HMAC form keeps the verify path dependency-free while
preserving the property that ONLY a real token holder can validate (or
forge) the discovery payload for that token.
"""

from __future__ import annotations

import hashlib
import hmac
import time
from typing import Optional, Tuple

from ..api import types as api
from .base import Controller

TOKEN_SECRET_TYPE = "bootstrap.kubernetes.io/token"
TOKEN_SECRET_PREFIX = "bootstrap-token-"
TOKEN_NAMESPACE = "kube-system"
JWS_KEY_PREFIX = "jws-kubeconfig-"


def new_bootstrap_token() -> Tuple[str, str, str]:
    """(token_id, token_secret, wire form id.secret) — kubeadm's
    GenerateBootstrapToken analog."""
    import secrets

    tid = secrets.token_hex(3)       # 6 hex chars, like abcdef
    tsec = secrets.token_hex(8)      # 16 hex chars
    return tid, tsec, f"{tid}.{tsec}"


def make_token_secret(token_id: str, token_secret: str,
                      ttl_seconds: Optional[float] = None) -> api.Secret:
    data = {"token-id": token_id, "token-secret": token_secret,
            "usage-bootstrap-authentication": "true",
            "usage-bootstrap-signing": "true"}
    if ttl_seconds is not None:
        data["expiration"] = str(time.time() + ttl_seconds)
    return api.Secret(
        metadata=api.ObjectMeta(name=TOKEN_SECRET_PREFIX + token_id,
                                namespace=TOKEN_NAMESPACE),
        type=TOKEN_SECRET_TYPE, data=data)


def parse_expiration(raw: Optional[str]) -> Optional[float]:
    """Expiration as unix seconds. Accepts both this module's numeric
    form and the reference's RFC3339 form ('2026-08-01T00:00:00Z').
    Unparseable values return 0.0 — i.e. ALREADY EXPIRED: a token whose
    expiry cannot be read must fail closed, and it must never crash the
    authenticator/signer/cleaner paths."""
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        pass
    try:
        from datetime import datetime, timezone

        dt = datetime.fromisoformat(raw.replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()
    except ValueError:
        return 0.0


def lookup_token(store, token: str) -> Optional[api.Secret]:
    """Resolve a live, unexpired bootstrap token ('id.secret') to its
    Secret; None if unknown/expired/malformed (bootstrap.go
    AuthenticateToken)."""
    tid, dot, tsec = token.partition(".")
    if not dot or not tid or not tsec:
        return None
    sec = store.get("secrets", TOKEN_NAMESPACE, TOKEN_SECRET_PREFIX + tid)
    if sec is None or sec.type != TOKEN_SECRET_TYPE:
        return None
    if not hmac.compare_digest(
            sec.data.get("token-secret", "").encode(),
            tsec.encode()):  # bytes: non-ASCII input must 401, not 500
        return None
    if sec.data.get("token-id") != tid:
        # reference bootstrap.go validates token-id against the secret
        # name; a mismatched/missing id must not authenticate
        return None
    exp = parse_expiration(sec.data.get("expiration"))
    if exp is not None and time.time() > exp:
        return None
    if sec.data.get("usage-bootstrap-authentication") != "true":
        return None
    return sec


def sign_payload(payload: str, token_secret: str) -> str:
    return hmac.new(token_secret.encode(), payload.encode(),
                    hashlib.sha256).hexdigest()


def compute_signatures(store, ca_pem: str) -> dict:
    """{jws-kubeconfig-<id>: signature} for every live signing-enabled
    bootstrap token — THE policy, shared by the BootstrapSigner
    controller and kubeadm's synchronous pre-signing (two hand-kept
    copies would drift on the expiry filter)."""
    want = {}
    for sec in store.list("secrets", TOKEN_NAMESPACE):
        if sec.type != TOKEN_SECRET_TYPE:
            continue
        if sec.data.get("usage-bootstrap-signing") != "true":
            continue
        exp = parse_expiration(sec.data.get("expiration"))
        if exp is not None and time.time() > exp:
            continue
        tid = sec.data.get("token-id")
        tsec = sec.data.get("token-secret")
        if tid and tsec:
            want[JWS_KEY_PREFIX + tid] = sign_payload(ca_pem, tsec)
    return want


def verify_cluster_info(info: api.ConfigMap, token: str) -> Optional[str]:
    """Authenticated CA discovery: returns the ca.crt iff the ConfigMap
    carries a valid signature under this token (the joiner-side half of
    BootstrapSigner; replaces trust-on-first-use)."""
    tid, _, tsec = token.partition(".")
    ca = info.data.get("ca.crt")
    sig = info.data.get(JWS_KEY_PREFIX + tid)
    if not ca or not sig:
        return None
    if not hmac.compare_digest(sig.encode(),
                               sign_payload(ca, tsec).encode()):
        return None
    return ca


class BootstrapSignerController(Controller):
    """bootstrapsigner.go: keep one signature per signing-enabled token
    on the kube-public cluster-info ConfigMap; drop signatures whose
    token is gone."""

    name = "bootstrapsigner"

    def __init__(self, store):
        super().__init__(store)
        self.informer("secrets",
                      enqueue_fn=lambda o=None, n=None: self.enqueue(
                          "kube-public/cluster-info"))
        self.informer("configmaps")

    def sync(self, key: str):
        if key != "kube-public/cluster-info":
            return
        info = self.store.get("configmaps", "kube-public", "cluster-info")
        if info is None or "ca.crt" not in info.data:
            return
        want = compute_signatures(self.store, info.data["ca.crt"])
        have = {k: v for k, v in info.data.items()
                if k.startswith(JWS_KEY_PREFIX)}
        if have == want:
            return
        info.data = {k: v for k, v in info.data.items()
                     if not k.startswith(JWS_KEY_PREFIX)}
        info.data.update(want)
        self.store.update("configmaps", info)

    def resync(self):
        self.enqueue("kube-public/cluster-info")


class TokenCleanerController(Controller):
    """tokencleaner.go: delete expired bootstrap-token Secrets; their
    holders stop authenticating and their cluster-info signatures are
    dropped by the signer's next pass."""

    name = "tokencleaner"

    def __init__(self, store, clock=time.time):
        super().__init__(store)
        self.clock = clock
        self.informer("secrets")

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        if ns != TOKEN_NAMESPACE or not name.startswith(
                TOKEN_SECRET_PREFIX):
            return
        sec = self.store.get("secrets", ns, name)
        if sec is None or sec.type != TOKEN_SECRET_TYPE:
            return
        exp = parse_expiration(sec.data.get("expiration"))
        if exp is not None and self.clock() > exp:
            try:
                self.store.delete("secrets", ns, name)
            except KeyError:
                pass

    def resync(self):
        for sec in self.store.list("secrets", TOKEN_NAMESPACE):
            if sec.type == TOKEN_SECRET_TYPE:
                self.enqueue(sec)
