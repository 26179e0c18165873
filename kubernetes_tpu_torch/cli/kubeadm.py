"""kubeadm-lite: one-command cluster bootstrap.

A copy of kubernetes_tpu/cli/kubeadm.py on the port's scheduler and
controllers; its relative imports resolve in this package. It differs
from the reference in four ways:

  * `device=`: the device the control plane's scheduler, controller
    manager and cluster autoscaler run on. None means the CUDA card,
    as everywhere in the port, and raises where there is none; tests
    pass "cpu".
  * preflight checks that torch imports and, unless the caller asks
    for another device, that a CUDA card is present (the reference
    checks that jax imports).
  * every path that needs the durable native store, that is
    `Cluster(data_dir=...)`, `init --data-dir`, `phase <name>
    --data-dir` and the offline `upgrade`, raises NotImplementedError:
    that store is not ported yet (ROADMAP.md queue 1 item 2b). `reset`
    needs no store and is the reference's.
  * the Cluster's scheduler loop pauses after every pass, not only after
    an empty one (see `Cluster.start`).

Reference: cmd/kubeadm/app/cmd/init.go (phases: preflight -> control
plane -> wait -> post-init) and join.go. `init` stands up the full
control plane in one process — apiserver (the in-memory store; the
reference's durable native store is --data-dir), controller manager,
scheduler, and
optionally N hollow nodes — then prints how to connect kubectl.
`join` registers a hollow kubelet against a running server.

Run as: python -m kubernetes_tpu_torch.cli.kubeadm init [--secure]
        [--hollow-nodes N] [--port P] [--once]
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from typing import List, Optional

from ..api import types as api
from ..controllers.manager import ControllerManager
from ..ops.encoding import resolve_device
from ..runtime.store import ObjectStore
from ..sched.scheduler import Scheduler
from ..server.admission import AdmissionChain
from ..server.apiserver import APIServer


def refuse_native_store(what: str):
    """The durable native store (the reference's runtime/nativestore.py
    over native/kvstore.cpp) is not ported: refuse, never fall back to
    the in-memory store."""
    raise NotImplementedError(
        f"{what}: the durable native store is not ported yet "
        "(ROADMAP.md queue 1 item 2b)")


class Cluster:
    """A running control plane (the object form of `kubeadm init`)."""

    def __init__(self, data_dir: Optional[str] = None, port: int = 0,
                 hollow_nodes: int = 0, reconcile_endpoints: bool = True,
                 secure: bool = False, cluster_autoscaler: bool = False,
                 node_eviction_rate: Optional[float] = None,
                 secondary_node_eviction_rate: Optional[float] = None,
                 large_cluster_size_threshold: Optional[int] = None,
                 unhealthy_zone_threshold: Optional[float] = None,
                 device=None):
        if data_dir:
            refuse_native_store(f"Cluster(data_dir={data_dir!r})")
        # the control plane's device: None is the CUDA card, and raises
        # before anything is built where there is none
        self.device = resolve_device(device)
        self.store = ObjectStore()
        authenticator = authorizer = None
        self.admin_token = self.bootstrap_token = None
        self.ca = None
        if secure:
            # init.go's certs + bootstrap-token + RBAC phases: cluster
            # CA, an HTTPS serving cert from it, admin + join
            # credentials, RBAC evaluated from served API objects
            # (runtime-reconfigurable). x509 identity comes from the TLS
            # handshake's verified peer chain.
            import secrets as _secrets

            from ..server import pki
            from ..server.auth import (AuthenticatorChain, RBACAuthorizer,
                                       UserInfo, cluster_admin_bindings)

            from ..controllers.bootstrap import (make_token_secret,
                                                 new_bootstrap_token)
            from ..runtime.store import Conflict

            self.ca = ca = pki.ensure_cluster_ca(self.store)
            self.admin_token = f"admin-{_secrets.token_hex(8)}"
            # bootstrap token lives as a kube-system Secret (id.secret
            # wire form): expiry/deletion revokes it live, and the
            # BootstrapSigner keys cluster-info signatures off it
            tid, tsec, self.bootstrap_token = new_bootstrap_token()
            tok_secret = make_token_secret(tid, tsec, ttl_seconds=86400.0)
            try:
                self.store.create("secrets", tok_secret)
            except Conflict:
                # re-init over a durable store that already holds a
                # token with this id: REPLACE it — keeping the old
                # Secret would make the token this init prints dead.
                # (update is last-writer-wins here; if the old Secret
                # vanished in between, fall back to create)
                try:
                    self.store.update("secrets", tok_secret)
                except KeyError:
                    self.store.create("secrets", tok_secret)
            authenticator = AuthenticatorChain(
                tokens={
                    self.admin_token: UserInfo(
                        "kubernetes-admin", ("system:masters",
                                             "system:authenticated")),
                },
                store=self.store, ca=ca)
            authorizer = RBACAuthorizer(
                bindings=cluster_admin_bindings(["system:masters"]),
                store=self.store)
            self._seed_rbac()
            self._publish_cluster_info()
        self.apiserver = APIServer(
            self.store, admission=AdmissionChain.default(), port=port,
            authenticator=authenticator, authorizer=authorizer,
            reconcile_endpoints=reconcile_endpoints, tls=self.ca)
        self.manager = ControllerManager(
            self.store,
            node_eviction_rate=node_eviction_rate,
            secondary_node_eviction_rate=secondary_node_eviction_rate,
            large_cluster_size_threshold=large_cluster_size_threshold,
            unhealthy_zone_threshold=unhealthy_zone_threshold,
            device=self.device)
        # the scheduler runs as an API CLIENT over a loopback watch
        # mirror — the reference's deployment shape (kube-scheduler
        # connects via client-go, cmd/kube-scheduler). Running it on the
        # raw shared store would invert Scheduler._mu against the store
        # lock: an apiserver handler thread mutating the store dispatches
        # informer events UNDER the store lock into scheduler handlers
        # that take _mu, while a scheduling wave holds _mu and writes the
        # store (observed deadlock under kubelet heartbeat load).
        from ..client.reflector import RemoteStore
        from ..client.rest import RESTClient

        self._sched_client = RESTClient(
            self.apiserver.url, token=self.admin_token,
            ca_cert_pem=self.ca.ca_cert_pem if self.ca else None)
        self._sched_store = RemoteStore(self._sched_client)
        self.scheduler = Scheduler(self._sched_store, device=self.device)
        self.cloud = None
        if cluster_autoscaler:
            # elastic NodeGroups behind the fake cloud seam: the
            # autoscaler controller watches the scheduler's
            # unschedulable map and resizes these groups through
            # on-device what-ifs (controllers/clusterautoscaler.py);
            # booted instances register as hollow-style ready nodes
            from ..cloud.provider import FakeCloud, node_from_template
            from ..controllers.clusterautoscaler import ClusterAutoscaler

            cloud = FakeCloud()
            cloud.joiner = lambda g, name: self.store.create(
                "nodes", node_from_template(g, name))
            for gname, cpu, mem, price in (
                    ("tpu-small", "16", "64Gi", 1.0),
                    ("tpu-large", "32", "128Gi", 2.3)):
                tmpl = api.Node(
                    metadata=api.ObjectMeta(name=f"template-{gname}"),
                    status=api.NodeStatus(allocatable=api.resource_list(
                        cpu=cpu, memory=mem, pods=110,
                        ephemeral_storage="200Gi")))
                cloud.add_node_group(gname, tmpl, min_size=0, max_size=32,
                                     price=price)
            self.cloud = cloud
            ca = ClusterAutoscaler(self.store, cloud, self.scheduler)
            self.manager.controllers[ca.name] = ca
        self.hollow = None
        self._hollow_nodes = hollow_nodes
        self._stop = threading.Event()
        self._sched_thread: Optional[threading.Thread] = None

    def write_admin_kubeconfig(self, path: str) -> None:
        """kubeadm's admin.conf (cmd/kubeadm/app/phases/kubeconfig):
        cluster CA bundle + the admin credential, ready for
        `kubectl --kubeconfig path` (or ~/.kube/config)."""
        from . import kubeconfig as kc

        kc.save(path, kc.new(
            cluster="kubernetes", server=self.apiserver.url,
            ca_pem=self.ca.ca_cert_pem if self.ca else None,
            user="kubernetes-admin", token=self.admin_token))

    def _seed_rbac(self):
        """Bootstrap RBAC objects (cmd/kubeadm/app/phases/bootstraptoken/
        clusterinfo + the reference's bootstrap policy): joiners may
        create and read CSRs, nothing else; node identity then comes
        from the signed cert + the node authorizer."""
        from ..runtime.store import Conflict

        # each create gets its OWN conflict guard: a crash between the
        # two must not leave the seed half-applied forever on re-init
        try:
            self.store.create("clusterroles", api.ClusterRole(
                metadata=api.ObjectMeta(name="system:node-bootstrapper"),
                rules=[api.RBACPolicyRule(
                    # create + named get only: a joiner polls its OWN
                    # CSR; list/watch would let any bootstrap-token
                    # holder enumerate other nodes' signed certs
                    verbs=["create", "get"],
                    api_groups=["certificates.k8s.io"],
                    resources=["certificatesigningrequests"])]))
        except Conflict:
            pass
        try:
            self.store.create("clusterrolebindings", api.ClusterRoleBinding(
                metadata=api.ObjectMeta(
                    name="kubeadm:kubelet-bootstrap"),
                subjects=[api.RBACSubject(kind="Group",
                                          name="system:bootstrappers")],
                role_ref=api.RoleRef(kind="ClusterRole",
                                     name="system:node-bootstrapper")))
        except Conflict:
            pass

    def _signed_cluster_info(self) -> api.ConfigMap:
        """cluster-info pre-signed for every live bootstrap token, so a
        join racing the controller's first pass still verifies; the
        BootstrapSigner controller maintains the signatures thereafter
        (token rotation/expiry)."""
        from ..controllers.bootstrap import compute_signatures

        data = {"ca.crt": self.ca.ca_cert_pem}
        data.update(compute_signatures(self.store, self.ca.ca_cert_pem))
        return api.ConfigMap(
            metadata=api.ObjectMeta(name="cluster-info",
                                    namespace="kube-public"),
            data=data)

    def _publish_cluster_info(self):
        """The cluster-info ConfigMap in kube-public, readable
        anonymously — how a joiner learns the CA bundle before it can
        authenticate (reference: clusterinfo phase). The BootstrapSigner
        machinery signs it per bootstrap token, so a token-holding
        joiner VERIFIES the CA instead of trusting first use; tokenless
        discovery remains TOFU."""
        from ..runtime.store import Conflict

        for obj_kind, obj in (
            ("namespaces", api.Namespace(
                metadata=api.ObjectMeta(name="kube-public"),
                status=api.NamespaceStatus(phase="Active"))),
            ("configmaps", self._signed_cluster_info()),
            ("roles", api.Role(
                metadata=api.ObjectMeta(name="kubeadm:bootstrap-signer",
                                        namespace="kube-public"),
                rules=[api.RBACPolicyRule(
                    verbs=["get"], api_groups=[""],
                    resources=["configmaps"],
                    resource_names=["cluster-info"])])),
            ("rolebindings", api.RoleBinding(
                metadata=api.ObjectMeta(name="kubeadm:cluster-info",
                                        namespace="kube-public"),
                subjects=[
                    api.RBACSubject(kind="Group",
                                    name="system:unauthenticated"),
                    api.RBACSubject(kind="Group",
                                    name="system:authenticated")],
                role_ref=api.RoleRef(kind="Role",
                                     name="kubeadm:bootstrap-signer"))),
        ):
            try:
                self.store.create(obj_kind, obj)
            except Conflict:
                pass

    @property
    def url(self) -> str:
        return self.apiserver.url

    def start(self) -> "Cluster":
        # phase order mirrors init.go: serve the API first, then the
        # controllers that need it, then nodes
        self.apiserver.start()
        self.manager.start()

        def sched_loop():
            while not self._stop.is_set():
                self.scheduler.run_once(timeout=0.2)
                # a wave holds the scheduler's _mu, which the informer
                # threads take to deliver each event; this loop would
                # take it back at once, and they would add about one pod
                # between waves. The pause after every pass (the
                # reference pauses after an empty one only) lets them
                # deliver what arrived during the wave.
                self._stop.wait(0.02)
            self.scheduler.close()

        self._sched_thread = threading.Thread(target=sched_loop,
                                              name="scheduler", daemon=True)
        self._sched_thread.start()
        if self._hollow_nodes:
            from ..kubemark.hollow import HollowCluster

            self.hollow = HollowCluster(self.store, self._hollow_nodes).run()
        return self

    def stop(self):
        self._stop.set()
        if self._sched_thread is not None:
            self._sched_thread.join(timeout=5)
        if self.hollow is not None:
            self.hollow.stop()
        self._sched_store.stop()
        self.manager.stop()
        self.apiserver.stop()
        close = getattr(self.store, "close", None)
        if close is not None:
            close()

    def wait_ready(self, timeout: float = 10.0) -> bool:
        """Bootstrap settled: default namespace's service account exists
        (the init.go 'wait for control plane' phase analog)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.manager.sync_all(rounds=1)
            if self.store.get("serviceaccounts", "default",
                              "default") is not None:
                return True
            time.sleep(0.02)
        return False


def ensure_bootstrap_objects(store):
    """Seed objects every cluster needs (init.go uploadconfig +
    bootstrap-token phases analog): the default namespace object."""
    from ..runtime.store import Conflict

    for name in ("default", "kube-system"):
        try:
            store.create("namespaces", api.Namespace(
                metadata=api.ObjectMeta(name=name),
                status=api.NamespaceStatus(phase="Active")))
        except Conflict:
            pass


# -- phases architecture (cmd/kubeadm/app/phases/) ----------------------------
#
# init decomposes into named, IDEMPOTENT, individually re-runnable
# phases over the store — `kubeadm init phase <name>` re-runs one (e.g.
# after restoring a data-dir), `kubeadm init` runs them all in order.
# The serving processes (apiserver/controllers/scheduler) start after
# the store-level phases, like the reference's control-plane phase
# writing manifests the kubelet then runs.

CLUSTER_VERSION = "v1.11-tpu.5"
CLUSTER_CONFIG_NAME = "kubeadm-config"


def phase_preflight(store=None, data_dir=None, port=0, device=None):
    """preflight checks (cmd/kubeadm/app/preflight/checks.go): the
    environment problems that would make later phases fail confusingly.
    `device` is the control plane's (None: the CUDA card). Returns a
    list of error strings (empty = pass)."""
    import os
    import socket

    errors = []
    if data_dir:
        # NativeObjectStore makedirs() the whole path, so probe by
        # doing exactly that (os.access lies under root); the dir is one
        # init would create anyway
        import tempfile

        try:
            os.makedirs(data_dir, exist_ok=True)
            with tempfile.TemporaryFile(dir=data_dir):
                pass
        except OSError as e:
            errors.append(f"data dir {data_dir!r} is not writable: {e}")
    if port:
        try:
            s = socket.socket()
            s.bind(("127.0.0.1", port))
            s.close()
        except OSError as e:
            errors.append(f"apiserver port {port} unavailable: {e}")
    try:
        import torch
    except ImportError as e:  # pragma: no cover - environment-dependent
        errors.append(f"torch unavailable: {e}")
    else:
        wants_card = device is None or torch.device(device).type == "cuda"
        if wants_card and not torch.cuda.is_available():
            errors.append("no CUDA device available (the scheduler runs "
                          "on the card; pass device='cpu' for the CPU)")
    return errors


def phase_certs(store):
    """certs phase: the cluster CA (+SA signing key) in kube-system."""
    from ..server import pki

    return pki.ensure_cluster_ca(store)


def phase_bootstrap_objects(store):
    ensure_bootstrap_objects(store)


def phase_upload_config(store):
    """uploadconfig phase: record the cluster version/config in a
    kube-system ConfigMap — what `kubeadm upgrade` reads and bumps."""
    from ..runtime.store import Conflict

    try:
        store.create("configmaps", api.ConfigMap(
            metadata=api.ObjectMeta(name=CLUSTER_CONFIG_NAME,
                                    namespace="kube-system"),
            data={"clusterVersion": CLUSTER_VERSION}))
    except Conflict:
        pass


def bump_cluster_version(store, to_version: str):
    """Record the new cluster version in kubeadm-config, creating it if
    absent; retried against the fresh object on CAS conflicts (a
    swallowed conflict would leave the upgrade unrecorded)."""
    from ..runtime.store import Conflict

    old_version = None
    for _ in range(8):
        cm = store.get("configmaps", "kube-system", CLUSTER_CONFIG_NAME)
        if cm is None:
            phase_upload_config(store)
            continue
        old_version = cm.data.get("clusterVersion")
        cm.data = dict(cm.data)
        cm.data["clusterVersion"] = to_version
        try:
            store.update("configmaps", cm)
            return old_version
        except Conflict:
            continue
    raise RuntimeError("could not record the new cluster version "
                       "(persistent write conflicts)")


# (name, description, fn(store)) — order matters; all idempotent
PHASES = [
    ("certs", "cluster CA + service-account signing key", phase_certs),
    ("bootstrap-objects", "default/kube-system namespaces",
     phase_bootstrap_objects),
    ("upload-config", "record cluster version in kubeadm-config",
     phase_upload_config),
]


def upgrade_cluster(cluster: "Cluster", to_version: str) -> "Cluster":
    """kubeadm upgrade apply: round-trip a LIVE cluster through an
    apiserver restart at a new version (cmd/kubeadm/app/cmd/upgrade/).
    The durable store (etcd analog) carries every object across; the
    replacement apiserver serves the same port so clients reconnect and
    relist; multi-version kinds keep serving through the conversion hub
    (api/conversion.py) — the part a real version skew exercises.
    Returns the same cluster object, upgraded in place."""
    from ..server.admission import AdmissionChain
    from ..server.apiserver import APIServer

    old = cluster.apiserver
    port = old.port
    reconcile = old.endpoint_reconciler is not None
    old.stop()
    # the new "binary" serves the SAME store (the etcd analog) on the
    # same port — object preservation is structural, not a copy; the
    # smoke check below proves the new server actually serves it
    cluster.apiserver = APIServer(
        cluster.store, admission=AdmissionChain.default(), port=port,
        authenticator=old.authenticator, authorizer=old.authorizer,
        reconcile_endpoints=reconcile, tls=cluster.ca).start()
    assert cluster.apiserver.store is cluster.store
    bump_cluster_version(cluster.store, to_version)
    return cluster


def cmd_phase(args) -> int:
    if args.phase == "list":
        print("preflight\t environment checks (run with init)")
        for name, desc, _ in PHASES:
            print(f"{name}\t {desc}")
        return 0
    if args.phase == "preflight":
        errors = phase_preflight(data_dir=args.data_dir, port=args.port,
                                 device=args.device)
        for e in errors:
            print(f"[preflight] ERROR: {e}", file=sys.stderr)
        print("preflight passed" if not errors else
              f"preflight failed ({len(errors)} errors)")
        return 1 if errors else 0
    fns = {name: fn for name, _, fn in PHASES}
    if args.phase not in fns:
        print(f"error: unknown phase {args.phase!r}", file=sys.stderr)
        return 1
    if args.data_dir:
        refuse_native_store(f"phase {args.phase} --data-dir")
    print("error: a store is required (--data-dir)", file=sys.stderr)
    return 1


def cmd_init(args) -> int:
    if args.data_dir:
        refuse_native_store("init --data-dir")
    if not getattr(args, "skip_preflight", False):
        errors = phase_preflight(port=args.port, device=args.device)
        if errors:
            for e in errors:
                print(f"[preflight] ERROR: {e}", file=sys.stderr)
            print("error: preflight failed (use --skip-preflight to "
                  "override)", file=sys.stderr)
            return 1
    cluster = Cluster(port=args.port,
                      hollow_nodes=args.hollow_nodes,
                      secure=getattr(args, "secure", False),
                      cluster_autoscaler=getattr(args, "cluster_autoscaler",
                                                 False),
                      node_eviction_rate=args.node_eviction_rate,
                      secondary_node_eviction_rate=(
                          args.secondary_node_eviction_rate),
                      large_cluster_size_threshold=(
                          args.large_cluster_size_threshold),
                      unhealthy_zone_threshold=args.unhealthy_zone_threshold,
                      device=args.device)
    for _name, _desc, fn in PHASES:  # store-level phases, in order
        fn(cluster.store)
    cluster.start()
    if not cluster.wait_ready():
        print("error: control plane did not become ready "
              "(default service account never appeared)", file=sys.stderr)
        cluster.stop()
        return 1
    print(f"control plane ready at {cluster.url}")
    if cluster.admin_token:
        print(f"  admin token:     {cluster.admin_token}")
        print(f"  bootstrap token: {cluster.bootstrap_token}")
    print(f"  export KUBECTL_SERVER={cluster.url}")
    print("  kubectl: this package has none yet; "
          "kubernetes_tpu.cli.kubectl speaks the same API")
    if args.once:
        cluster.stop()
        return 0
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        cluster.stop()
    return 0


def fetch_cluster_ca(server: str, token: Optional[str] = None) -> str:
    """CA discovery from the anonymous cluster-info ConfigMap
    (kube-public), fetched over an unverified TLS connection. With a
    bootstrap token the BootstrapSigner's signature for that token is
    VERIFIED (HMAC keyed by the token secret) — the reference discovery
    phase's JWS check, so a man-in-the-middle cannot substitute a CA
    without holding the token. Without a token this is trust-on-first-
    use (the reference's --discovery-token-unsafe-skip-ca-verification
    posture)."""
    from ..client.rest import RESTClient

    tofu = RESTClient(server, insecure_skip_verify=True)
    info = tofu.get("configmaps", "kube-public", "cluster-info")
    if token is not None:
        from ..controllers.bootstrap import verify_cluster_info

        ca = verify_cluster_info(info, token)
        if ca is None:
            raise RuntimeError(
                "cluster-info signature verification FAILED for this "
                "bootstrap token — possible man-in-the-middle, or the "
                "token expired")
        return ca
    return info.data["ca.crt"]


def join_with_csr(server: str, node_name: str, bootstrap_token: str,
                  timeout: float = 15.0, ca_cert_pem: Optional[str] = None):
    """kubeadm join's TLS-bootstrap phase: using only the bootstrap
    token, generate a key + CSR for system:node:<name>, submit it, wait
    for the approver+signer controllers, and return (key_pem, cert_pem,
    ca_cert_pem) — the kubelet mTLS credential + trust bundle every
    later request uses. Reference: cmd/kubeadm/app/phases/kubelet
    (bootstrap kubeconfig) + pkg/controller/certificates/."""
    import secrets as _secrets

    from ..client.rest import RESTClient
    from ..server import pki

    if ca_cert_pem is None and server.startswith("https"):
        # token in hand: discovery is VERIFIED, not TOFU
        ca_cert_pem = fetch_cluster_ca(server, token=bootstrap_token)
    boot = RESTClient(server, token=bootstrap_token,
                      ca_cert_pem=ca_cert_pem)
    key_pem, csr_pem = pki.make_csr(f"system:node:{node_name}",
                                    ("system:nodes",))
    # random suffix, like real kubeadm's node-csr-<rand>: a re-join
    # (restart, retry) must not 409 on the old object — and the old
    # cert would not match the freshly generated key anyway
    csr_name = f"node-csr-{node_name}-{_secrets.token_hex(4)}"
    csr = api.CertificateSigningRequest(
        metadata=api.ObjectMeta(name=csr_name, namespace=""),
        spec=api.CertificateSigningRequestSpec(
            request=csr_pem,
            usages=["digital signature", "key encipherment",
                    "client auth"]))
    boot.create("certificatesigningrequests", csr)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = boot.get("certificatesigningrequests", "", csr_name)
        if got.status.certificate:
            return key_pem, got.status.certificate, ca_cert_pem
        time.sleep(0.05)
    raise TimeoutError(f"CSR for {node_name} was not signed "
                       f"within {timeout}s")


def cmd_join(args) -> int:
    from ..client.reflector import RemoteStore
    from ..client.rest import RESTClient
    from ..kubemark.hollow import HollowNode

    cert_pem = key_pem = ca_pem = None
    if args.bootstrap_token:
        key_pem, cert_pem, ca_pem = join_with_csr(
            args.server, args.node_name, args.bootstrap_token)
        print(f"obtained kubelet client cert for "
              f"system:node:{args.node_name} via CSR (mTLS)")
    elif args.server.startswith("https"):
        # tokenless join against a secure server still needs the CA
        # bundle to talk TLS at all (anonymous-readable cluster-info)
        ca_pem = fetch_cluster_ca(args.server)
    store = RemoteStore(RESTClient(args.server, client_cert_pem=cert_pem,
                                   client_key_pem=key_pem,
                                   ca_cert_pem=ca_pem))
    for kind in ("pods", "nodes"):
        store.mirror(kind)
    store.wait_for_sync()
    node = HollowNode(store, args.node_name).run()
    print(f"node {args.node_name} joined {args.server}")
    if args.once:
        node.stop()
        store.stop()
        return 0
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        node.stop()
        store.stop()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="kubeadm")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_init = sub.add_parser("init", help="bootstrap a control plane")
    p_init.add_argument("--data-dir", default=None,
                        help="durable storage path (native WAL+snapshot "
                             "engine; not ported yet, refused); omit for "
                             "in-memory")
    p_init.add_argument("--port", type=int, default=0)
    p_init.add_argument("--hollow-nodes", type=int, default=0)
    p_init.add_argument("--once", action="store_true",
                        help="start, verify, and exit (smoke test)")
    p_init.add_argument("--secure", action="store_true",
                        help="enable authn (x509/SA-token/static) + "
                             "RBAC-from-API-objects")
    p_init.add_argument("--skip-preflight", action="store_true")
    p_init.add_argument("--cluster-autoscaler", action="store_true",
                        dest="cluster_autoscaler",
                        help="run the cluster autoscaler against two "
                             "fake-cloud NodeGroups (tpu-small/tpu-large): "
                             "unschedulable pods trigger simulated "
                             "scale-up, idle nodes drain and scale down")
    # eviction storm control (kube-controller-manager's node lifecycle
    # flags): zone disruption states + per-zone rate-limited eviction
    p_init.add_argument("--node-eviction-rate", type=float, default=None,
                        help="pod evictions/s per zone when the zone is "
                             "healthy (default 0.1)")
    p_init.add_argument("--secondary-node-eviction-rate", type=float,
                        default=None,
                        help="evictions/s in a PartialDisruption zone "
                             "larger than --large-cluster-size-threshold "
                             "(default 0.01); smaller disrupted zones "
                             "halt entirely")
    p_init.add_argument("--large-cluster-size-threshold", type=int,
                        default=None,
                        help="zones above this node count keep evicting "
                             "(at the secondary rate) under partial "
                             "disruption (default 50)")
    p_init.add_argument("--unhealthy-zone-threshold", type=float,
                        default=None,
                        help="fraction of a zone's nodes not-ready before "
                             "it is PartialDisruption (default 0.55); a "
                             "100%% not-ready zone is FullDisruption and "
                             "suspends eviction until heartbeats resume")
    p_phase = sub.add_parser("phase",
                             help="run one init phase (or 'list')")
    p_phase.add_argument("phase")
    p_phase.add_argument("--data-dir", default=None)
    p_phase.add_argument("--port", type=int, default=0)
    p_up = sub.add_parser(
        "upgrade", help="bump a data-dir cluster to a new version; "
                        "verifies every object round-trips through its "
                        "served versions' conversion hub first")
    p_up.add_argument("--data-dir", required=True)
    p_up.add_argument("--to-version", default=CLUSTER_VERSION)
    p_join = sub.add_parser("join", help="join a hollow node")
    p_join.add_argument("server")
    p_join.add_argument("--node-name", default="hollow-0")
    p_join.add_argument("--bootstrap-token", default=None,
                        help="TLS-bootstrap: obtain a kubelet client "
                             "cert via CSR before joining")
    p_join.add_argument("--once", action="store_true")
    p_tok = sub.add_parser("token",
                           help="manage bootstrap tokens on a running "
                                "cluster")
    p_tok.add_argument("action", choices=["create", "list", "delete"])
    p_tok.add_argument("target", nargs="?", default="",
                       help="delete: token or token-id")
    p_tok.add_argument("--server", required=True)
    p_tok.add_argument("--token", default=None,
                       help="admin credential for the API")
    p_tok.add_argument("--ttl", type=float, default=86400.0,
                       help="seconds until expiry (0 = never)")
    p_reset = sub.add_parser("reset",
                             help="wipe a cluster data-dir")
    p_reset.add_argument("--data-dir", required=True)
    p_reset.add_argument("--force", action="store_true")
    sub.add_parser("version")
    return ap


def cmd_upgrade(args) -> int:
    """Offline upgrade of a durable data-dir (the reference verifies
    that the conversion hub round-trips every stored object at every
    served version, then bumps the recorded cluster version). It needs
    the native store, which is not ported; the live form is
    upgrade_cluster()."""
    refuse_native_store(f"upgrade --data-dir {args.data_dir}")


def cmd_token(args) -> int:
    """kubeadm token create/list/delete (cmd/kubeadm/app/cmd/token.go)
    against a RUNNING cluster's API — bootstrap tokens are kube-system
    Secrets (phases/bootstraptoken/node/token.go), so every subcommand
    is ordinary Secret CRUD the BootstrapSigner/TokenCleaner observe."""
    from ..client.rest import APIStatusError, RESTClient
    from ..controllers import bootstrap as bt

    client = RESTClient(args.server, token=args.token)
    try:
        if args.action == "create":
            tid, tsec, wire = bt.new_bootstrap_token()
            sec = bt.make_token_secret(
                tid, tsec, ttl_seconds=args.ttl if args.ttl > 0 else None)
            client.create("secrets", sec, namespace=bt.TOKEN_NAMESPACE)
            print(wire)
            return 0
        if args.action == "list":
            secs, _ = client.list("secrets", bt.TOKEN_NAMESPACE)
            now = time.time()
            print("TOKEN\t\t\tTTL\tUSAGES")
            for s in secs:
                if s.type != bt.TOKEN_SECRET_TYPE:
                    continue
                tid = s.data.get("token-id", "?")
                exp = bt.parse_expiration(s.data.get("expiration"))
                ttl = ("<forever>" if exp is None else
                       f"{max(0, int(exp - now))}s")
                usages = ",".join(sorted(
                    k[len("usage-bootstrap-"):] for k, v in s.data.items()
                    if k.startswith("usage-bootstrap-") and v == "true"))
                print(f"{tid}.{'*' * 16}\t{ttl}\t{usages}")
            return 0
        # delete
        if not args.target:
            print("error: token delete needs a token or token-id",
                  file=sys.stderr)
            return 1
        tid = args.target.split(".")[0]
        name = (tid if tid.startswith(bt.TOKEN_SECRET_PREFIX)
                else bt.TOKEN_SECRET_PREFIX + tid)
        client.delete("secrets", bt.TOKEN_NAMESPACE, name)
        print(f"bootstrap token {tid!r} deleted")
        return 0
    except APIStatusError as e:
        if e.code == 404:
            print(f"error: token {args.target!r} not found",
                  file=sys.stderr)
        else:
            print(f"error from server: {e}", file=sys.stderr)
        return 1


def cmd_reset(args) -> int:
    """kubeadm reset (cmd/kubeadm/app/cmd/reset.go): wipe the local
    control-plane state this binary created — here, the durable
    data-dir (WAL + snapshots). Refuses without --force, like the
    reference's interactive confirmation."""
    import shutil

    if not os.path.isdir(args.data_dir):
        print(f"error: {args.data_dir!r} is not a directory",
              file=sys.stderr)
        return 1
    marker = [f for f in os.listdir(args.data_dir)
              if f.startswith(("wal", "snapshot"))]
    if not marker:
        print(f"error: {args.data_dir!r} does not look like a cluster "
              f"data-dir (no wal/snapshot files); not removing",
              file=sys.stderr)
        return 1
    if not args.force:
        print("error: pass --force to wipe the cluster state",
              file=sys.stderr)
        return 1
    shutil.rmtree(args.data_dir)
    print(f"cluster state at {args.data_dir} removed")
    return 0


def main(argv: Optional[List[str]] = None, *, device=None) -> int:
    """`device` is the control plane's for init, and preflight's check
    (None: the CUDA card)."""
    args = build_parser().parse_args(argv)
    args.device = device
    if args.cmd == "version":
        print(f"kubeadm version: {CLUSTER_VERSION}")
        return 0
    return {"init": cmd_init, "join": cmd_join, "phase": cmd_phase,
            "upgrade": cmd_upgrade, "token": cmd_token,
            "reset": cmd_reset}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
