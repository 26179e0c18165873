"""Service-account tokens: mint + verify JWTs.

A copy of kubernetes_tpu/server/serviceaccount.py; its relative imports
resolve in this package.

Reference: pkg/serviceaccount/jwt.go — the token is a JWT whose claims
carry the SA's namespace/name/uid and the backing Secret's name; the
authenticator validates the signature AND that the SA + Secret still
exist (jwt.go Validate), so deleting either revokes the token. The
reference signs RSA/ECDSA; this build signs HS256 with the cluster's
sa_signing_key (pki.ClusterCA) — same claims, same validation contract.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
from typing import List, Optional, Tuple

ISSUER = "kubernetes/serviceaccount"
GROUPS = ("system:serviceaccounts",)


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def username(namespace: str, name: str) -> str:
    return f"system:serviceaccount:{namespace}:{name}"


def mint(key: str, namespace: str, name: str, uid: str,
         secret_name: str) -> str:
    """jwt.go TokenGenerator.GenerateToken: claims bind the token to the
    SA identity and its Secret."""
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    claims = _b64(json.dumps({
        "iss": ISSUER,
        "sub": username(namespace, name),
        "kubernetes.io/serviceaccount/namespace": namespace,
        "kubernetes.io/serviceaccount/service-account.name": name,
        "kubernetes.io/serviceaccount/service-account.uid": uid,
        "kubernetes.io/serviceaccount/secret.name": secret_name,
    }).encode())
    signing_input = f"{header}.{claims}"
    sig = hmac.new(key.encode(), signing_input.encode(),
                   hashlib.sha256).digest()
    return f"{signing_input}.{_b64(sig)}"


def claims_of(token: str) -> Optional[dict]:
    """Unverified claims (for controllers deciding whether a stored
    token still matches its ServiceAccount — NOT for authentication)."""
    parts = token.split(".")
    if len(parts) != 3:
        return None
    try:
        return json.loads(_unb64(parts[1]))
    except Exception:
        return None


def verify(key: str, token: str, store=None
           ) -> Optional[Tuple[str, List[str], str]]:
    """jwt.go Validate: signature, issuer, and — when a store is given —
    that the ServiceAccount (same uid) and Secret still exist. Returns
    (username, groups, namespace) or None."""
    parts = token.split(".")
    if len(parts) != 3:
        return None
    signing_input = f"{parts[0]}.{parts[1]}"
    want = hmac.new(key.encode(), signing_input.encode(),
                    hashlib.sha256).digest()
    try:
        if not hmac.compare_digest(want, _unb64(parts[2])):
            return None
        claims = json.loads(_unb64(parts[1]))
    except Exception:
        return None
    if claims.get("iss") != ISSUER:
        return None
    ns = claims.get("kubernetes.io/serviceaccount/namespace", "")
    name = claims.get(
        "kubernetes.io/serviceaccount/service-account.name", "")
    uid = claims.get("kubernetes.io/serviceaccount/service-account.uid", "")
    secret = claims.get("kubernetes.io/serviceaccount/secret.name", "")
    if not ns or not name:
        return None
    if store is not None:
        sa = store.get("serviceaccounts", ns, name)
        if sa is None or (uid and sa.metadata.uid != uid):
            return None  # SA deleted/recreated: token revoked
        if secret and store.get("secrets", ns, secret) is None:
            return None  # backing Secret deleted: token revoked
    return (username(ns, name),
            list(GROUPS) + [f"system:serviceaccounts:{ns}"], ns)
