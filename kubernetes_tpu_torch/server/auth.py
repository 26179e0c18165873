"""Authentication + RBAC authorization.

A copy of kubernetes_tpu/server/auth.py; its relative imports resolve in this
package.

Authentication (request chain, apiserver/pkg/authentication/):
  * bearer token file (plugin/pkg/auth/authenticator/token/tokenfile)
  * service-account JWTs (pkg/serviceaccount/jwt.go) — signature plus
    liveness of the SA and its Secret
  * x509 client certs (authentication/request/x509/x509.go:76
    CommonNameUserConversion) — CN=user, O=groups, verified against the
    cluster CA by the TLS handshake itself (server/pki.py
    server_ssl_context); the server hands the verified peer subject to
    the chain. There is no header-borne cert path: a cert only
    authenticates over a connection whose handshake proved possession
    of its key.

Authorization:
  * RBAC over SERVED API objects (plugin/pkg/auth/authorizer/rbac/
    rbac.go:74): Role/ClusterRole/RoleBinding/ClusterRoleBinding are
    watched from the store and evaluated per request with apiGroups,
    resourceNames, nonResourceURLs, and namespaced Role scoping —
    reconfigurable at runtime by writing RBAC objects.
  * static constructor bindings (the pre-round-4 collapsed form) keep
    working for embedded/test servers.
  * node authorizer (plugin/pkg/auth/authorizer/node/node_authorizer.go)
    for system:nodes subjects; write fencing to the node's OWN objects
    is NodeRestriction admission, as in the reference.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class UserInfo:
    name: str
    groups: Tuple[str, ...] = ()


ANONYMOUS = UserInfo("system:anonymous", ("system:unauthenticated",))


class TokenAuthenticator:
    """Bearer-token -> user mapping (token-file authenticator analog)."""

    def __init__(self, tokens: Dict[str, UserInfo],
                 allow_anonymous: bool = True):
        self.tokens = tokens
        self.allow_anonymous = allow_anonymous

    def authenticate(self, authorization_header: Optional[str]) -> Optional[UserInfo]:
        """Returns the user, or None to reject (401)."""
        if authorization_header and authorization_header.startswith("Bearer "):
            tok = authorization_header[len("Bearer "):].strip()
            user = self.tokens.get(tok)
            if user is not None:
                return user
            return None  # bad token is always a 401
        return ANONYMOUS if self.allow_anonymous else None


class AuthenticatorChain:
    """union.New analog: token file -> SA JWT -> TLS peer cert; the
    first authenticator that positively identifies the request wins, any
    presented-but-invalid credential is a 401."""

    def __init__(self, tokens: Optional[Dict[str, UserInfo]] = None,
                 store=None, ca=None, allow_anonymous: bool = True):
        self.tokens = tokens or {}
        self.store = store
        self.ca = ca  # pki.ClusterCA (x509 + SA signing key)
        self.allow_anonymous = allow_anonymous

    def authenticate(self, authorization_header: Optional[str]) -> Optional[UserInfo]:
        """Bearer-only entry point (back compat with TokenAuthenticator)."""
        return self._authenticate(authorization_header, None)

    def authenticate_request(self, headers, peer=None) -> Optional[UserInfo]:
        """peer: (CN, [O...]) read from the VERIFIED TLS peer chain by
        the serving socket (pki.peer_identity) — never from a header."""
        return self._authenticate(headers.get("Authorization"), peer)

    def _authenticate(self, auth_header, peer=None) -> Optional[UserInfo]:
        if auth_header and auth_header.startswith("Bearer "):
            tok = auth_header[len("Bearer "):].strip()
            user = self.tokens.get(tok)
            if user is not None:
                return user
            if self.ca is not None and tok.count(".") == 2:
                from . import serviceaccount as sat

                got = sat.verify(self.ca.sa_signing_key, tok, self.store)
                if got is not None:
                    name, groups, _ns = got
                    return UserInfo(name, ("system:authenticated",
                                           *groups))
            if self.store is not None and tok.count(".") == 1:
                # bootstrap tokens (id.secret) resolve through their
                # kube-system Secret — expiry/deletion revokes live
                # (authenticator/token/bootstrap/bootstrap.go)
                from ..controllers.bootstrap import lookup_token

                sec = lookup_token(self.store, tok)
                if sec is not None:
                    tid = tok.partition(".")[0]
                    return UserInfo(f"system:bootstrap:{tid}",
                                    ("system:bootstrappers",
                                     "system:authenticated"))
            return None  # presented token matched nothing: 401
        if peer is not None:
            cn, orgs = peer
            return UserInfo(cn, ("system:authenticated", *orgs))
        return ANONYMOUS if self.allow_anonymous else None


def _match_nonresource(patterns, path: str) -> bool:
    """NonResourceURLMatches: exact, or trailing-* prefix wildcard."""
    for pat in patterns:
        if pat == "*" or pat == path or (
                pat.endswith("*") and path.startswith(pat[:-1])):
            return True
    return False


def _group_of(resource: str) -> str:
    """API group a plural is served under ('' = core) — needed to
    evaluate RBACPolicyRule.api_groups against a request. Subresource
    attributes ("deployments/scale") resolve through their base."""
    from ..api import scheme

    kind = scheme.kind_for_plural(resource.split("/")[0])
    if kind is None:
        return ""
    gv = scheme.api_version_for(kind)
    return gv.split("/")[0] if "/" in gv else ""


@dataclass
class PolicyRule:
    """One RBAC rule. The static/collapsed form used by embedded
    servers; rbac/v1 semantics (VerbMatches/ResourceMatches/
    ResourceNameMatches/NonResourceURLMatches in rbac/v1/evaluation
    helpers)."""

    verbs: Sequence[str]
    resources: Sequence[str] = ()
    resource_names: Sequence[str] = ()
    non_resource_urls: Sequence[str] = ()

    def allows(self, verb: str, resource: str,
               name: Optional[str] = None) -> bool:
        if "*" not in self.verbs and verb not in self.verbs:
            return False
        if resource.startswith("/"):
            # nonResourceURL request. The collapsed static form also
            # lets a full wildcard resources rule cover paths —
            # cluster_admin_bindings() predates the nonResourceURL field
            # and must keep meaning "everything" (the reference's
            # cluster-admin ClusterRole carries both a resources:* and a
            # nonResourceURLs:* rule)
            return (_match_nonresource(self.non_resource_urls, resource)
                    or "*" in self.resources)
        if "*" not in self.resources and resource not in self.resources:
            return False
        if self.resource_names:
            # resourceNames never match collection requests (rbac.go:
            # a list has no name to match)
            return name is not None and name in self.resource_names
        return True


@dataclass
class RoleBinding:
    """Static subject -> rules binding (collapses the reference's
    ClusterRole + ClusterRoleBinding pair); embedded/test servers."""

    subject: str  # user name or group name
    rules: List[PolicyRule] = field(default_factory=list)


NODE_READ_RESOURCES = frozenset({
    "services", "endpoints", "nodes", "pods", "persistentvolumes",
    "persistentvolumeclaims"})
# get-by-name only: the reference's node authorizer walks its graph to
# allow exactly the secrets/configmaps referenced by pods bound to the
# node (node_authorizer.go authorizeReadNamespacedObject) — no graph
# here, so the fence is: named gets only (no list/watch sweeps), and
# never in kube-system, whose Secrets hold the cluster CA + SA signing
# keys (a kubelet reading those would be a cluster-admin escalation)
NODE_GET_ONLY_RESOURCES = frozenset({
    "secrets", "configmaps",
    # named-get for polling its own rotation CSR's signed certificate
    "certificatesigningrequests"})
# writes are whitelisted as EXACT (resource, subresource) attributes —
# the reference node authorizer never grants pods/exec, pods/attach,
# pods/portforward, pods/log or any proxy subresource to node
# identities (node_authorizer.go enumerates the rules explicitly);
# matching on the base resource would hand every kubelet an exec
# capability on every pod (round-4 advisor finding)
NODE_WRITE_RESOURCES = frozenset({
    "nodes", "nodes/status", "pods", "pods/status", "pods/eviction",
    "events"})


def _node_authorize(user: UserInfo, verb: str, resource: str,
                    namespace: Optional[str],
                    name: Optional[str]) -> bool:
    """node_authorizer.go: kubelets (system:nodes group, system:node:<x>
    name) read the resources kubelets need and write node/pod state.
    Which specific node/pod a kubelet may write is enforced by
    NodeRestriction admission, as in the reference."""
    if "system:nodes" not in user.groups or \
            not user.name.startswith("system:node:"):
        return False
    if verb in ("get", "list", "watch"):
        if resource in NODE_READ_RESOURCES:  # plain resources only —
            # no read subresource (pods/log, nodes/proxy) is granted
            return True
        if resource in NODE_GET_ONLY_RESOURCES:
            return (verb == "get" and name is not None
                    and namespace != "kube-system")
        return False
    if resource == "certificatesigningrequests":
        # certificate rotation (selfnodeclient ClusterRole): CREATE
        # only — update/patch would let a node write its own Approved
        # condition and self-sign arbitrary identities (the approval
        # decision belongs to the approver controller alone)
        return verb == "create"
    return resource in NODE_WRITE_RESOURCES


class RBACAuthorizer:
    """visitRulesFor analog (rbac.go:74 Authorize): union of static
    constructor bindings, the node authorizer, and rules resolved from
    served RBAC API objects when a store is attached."""

    def __init__(self, bindings: Sequence[RoleBinding] = (),
                 store=None, node_authorizer: bool = True):
        self.bindings = list(bindings)
        self.node_authorizer = node_authorizer
        self._store = None
        self._lock = threading.Lock()
        self._dirty = True
        # resolved: [(subjects, rules, namespace-or-None)]
        self._resolved: List[Tuple[list, list, Optional[str]]] = []
        if store is not None:
            self.watch_store(store)

    # -- API-object source ------------------------------------------------------

    def watch_store(self, store):
        """Watch the four RBAC kinds; any change invalidates the
        resolved index (rebuilt lazily on the next authorize)."""
        from ..runtime.store import Event  # noqa: F401 (signature doc)

        self._store = store
        for plural in ("roles", "clusterroles", "rolebindings",
                       "clusterrolebindings"):
            store.watch(plural, self._on_event)
        self._dirty = True

    def _on_event(self, ev):
        self._dirty = True

    def _rebuild(self):
        store = self._store
        resolved: List[Tuple[list, list, Optional[str]]] = []
        cluster_roles = {r.metadata.name: r
                         for r in store.list("clusterroles")}
        roles = {(r.metadata.namespace, r.metadata.name): r
                 for r in store.list("roles")}
        for b in store.list("clusterrolebindings"):
            role = cluster_roles.get(b.role_ref.name)
            if role is not None:
                resolved.append((list(b.subjects), list(role.rules), None))
        for b in store.list("rolebindings"):
            ns = b.metadata.namespace
            if b.role_ref.kind == "ClusterRole":
                role = cluster_roles.get(b.role_ref.name)
            else:
                role = roles.get((ns, b.role_ref.name))
            if role is not None:
                # a RoleBinding grants only within its own namespace
                resolved.append((list(b.subjects), list(role.rules), ns))
        self._resolved = resolved

    @staticmethod
    def _subject_matches(subj, user: UserInfo) -> bool:
        if subj.kind == "User":
            return subj.name == user.name
        if subj.kind == "Group":
            return subj.name in user.groups
        if subj.kind == "ServiceAccount":
            return user.name == \
                f"system:serviceaccount:{subj.namespace}:{subj.name}"
        return False

    @staticmethod
    def _obj_rule_allows(rule, verb, resource, name) -> bool:
        verbs = rule.verbs or []
        if "*" not in verbs and verb not in verbs:
            return False
        if resource.startswith("/"):
            return _match_nonresource(rule.non_resource_urls or [],
                                      resource)
        resources = rule.resources or []
        if "*" not in resources and resource not in resources:
            return False
        # apiGroups scope the rule (rbac.go APIGroupMatches): an empty
        # list matches NOTHING, exactly like the reference — a rule must
        # name its groups ([""] for core). Treating empty as "any" would
        # make a hand-built Role grant strictly more here than the
        # identical object grants in the reference (round-4 advisor
        # finding).
        groups = rule.api_groups or []
        if "*" not in groups and _group_of(resource) not in groups:
            return False
        if rule.resource_names:
            return name is not None and name in rule.resource_names
        return True

    # -- entry point ------------------------------------------------------------

    def authorize(self, user: UserInfo, verb: str, resource: str,
                  namespace: Optional[str] = None,
                  name: Optional[str] = None) -> bool:
        # system:basic-user bootstrap grant: every authenticated subject
        # may ask about its OWN permissions (the review evaluates as the
        # requestor, so this grants no transitive access;
        # plugin/pkg/auth/authorizer/rbac/bootstrappolicy/policy.go
        # "system:basic-user" -> create selfsubjectaccessreviews)
        if resource == "selfsubjectaccessreviews" and verb == "create":
            return True
        if self.node_authorizer and _node_authorize(user, verb, resource,
                                                    namespace, name):
            return True
        names = {user.name, *user.groups}
        for b in self.bindings:
            if b.subject in names:
                if any(r.allows(verb, resource, name) for r in b.rules):
                    return True
        if self._store is not None:
            if self._dirty:
                with self._lock:
                    if self._dirty:
                        # clear BEFORE rebuilding: an event landing
                        # mid-rebuild re-dirties, so the next authorize
                        # rebuilds again instead of serving the stale
                        # snapshot forever
                        self._dirty = False
                        self._rebuild()
            for subjects, rules, bind_ns in self._resolved:
                if bind_ns is not None and namespace != bind_ns:
                    continue
                if not any(self._subject_matches(s, user)
                           for s in subjects):
                    continue
                if any(self._obj_rule_allows(r, verb, resource, name)
                       for r in rules):
                    return True
        return False


def cluster_admin_bindings(subjects: Sequence[str]) -> List[RoleBinding]:
    return [RoleBinding(s, [PolicyRule(["*"], ["*"])]) for s in subjects]
