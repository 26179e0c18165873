"""Cluster PKI: a self-signed CA, CSR issuance, and cert verification.

A copy of kubernetes_tpu/server/pki.py; its relative imports resolve in this
package.

Reference: the kubeadm certs phase (cmd/kubeadm/app/phases/certs) creates
a self-signed cluster CA; the CSR signer (pkg/controller/certificates/
signer/signer.go) issues client certs from it; x509 request authn
(staging/src/k8s.io/apiserver/pkg/authentication/request/x509/x509.go:76)
maps a verified client cert to a user via CommonName (user) and
Organization (groups) — CommonNameUserConversion.

EC P-256 keys throughout (small, fast). The CA material lives in a
kube-system Secret so every component — apiserver authn, the CSR
signer, kubeadm join — shares one trust root through the store, and a
durable store carries it across restarts (the reference's equivalent is
the /etc/kubernetes/pki directory).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

from ..api import types as api

CA_SECRET_NAMESPACE = "kube-system"
CA_SECRET_NAME = "cluster-ca"

_ONE_DAY = datetime.timedelta(days=1)


def _name(common_name: str, organizations: Tuple[str, ...] = ()) -> x509.Name:
    attrs = [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    attrs += [x509.NameAttribute(NameOID.ORGANIZATION_NAME, o)
              for o in organizations]
    return x509.Name(attrs)


@dataclass
class ClusterCA:
    """The cluster trust root + the service-account signing secret."""

    ca_cert_pem: str
    ca_key_pem: str
    sa_signing_key: str  # HMAC secret for SA JWTs (jwt.go's key analog)

    @property
    def ca_cert(self) -> x509.Certificate:
        return x509.load_pem_x509_certificate(self.ca_cert_pem.encode())

    def _ca_key(self):
        return serialization.load_pem_private_key(
            self.ca_key_pem.encode(), password=None)

    def sign_csr(self, csr_pem: str, days: int = 365) -> str:
        """signer.go Sign: issue a client cert for a PEM CSR, preserving
        its subject (CN = user, O = groups)."""
        csr = x509.load_pem_x509_csr(csr_pem.encode())
        if not csr.is_signature_valid:
            raise ValueError("CSR signature invalid")
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (x509.CertificateBuilder()
                .subject_name(csr.subject)
                .issuer_name(self.ca_cert.subject)
                .public_key(csr.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - _ONE_DAY)
                .not_valid_after(now + days * _ONE_DAY)
                .add_extension(x509.ExtendedKeyUsage(
                    [x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]),
                    critical=False)
                .sign(self._ca_key(), hashes.SHA256()))
        return cert.public_bytes(serialization.Encoding.PEM).decode()

    def verify_client_cert(self, cert_pem: str
                           ) -> Optional[Tuple[str, List[str]]]:
        """x509.go:76 CommonNameUserConversion: validate the cert chains
        to this CA and is in its validity window; return (CN, [O...]),
        or None if untrusted/expired."""
        try:
            cert = x509.load_pem_x509_certificate(cert_pem.encode())
            cert.verify_directly_issued_by(self.ca_cert)
        except Exception:
            return None
        now = datetime.datetime.now(datetime.timezone.utc)
        if not (cert.not_valid_before_utc <= now <= cert.not_valid_after_utc):
            return None
        cn = cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
        orgs = cert.subject.get_attributes_for_oid(NameOID.ORGANIZATION_NAME)
        if not cn:
            return None
        return cn[0].value, [o.value for o in orgs]


def new_cluster_ca(name: str = "kubernetes-tpu-ca") -> ClusterCA:
    """kubeadm certs phase: generate the self-signed CA."""
    import secrets

    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    subject = _name(name)
    cert = (x509.CertificateBuilder()
            .subject_name(subject).issuer_name(subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + 3650 * _ONE_DAY)
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    return ClusterCA(
        ca_cert_pem=cert.public_bytes(serialization.Encoding.PEM).decode(),
        ca_key_pem=key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()).decode(),
        sa_signing_key=secrets.token_hex(32))


def make_csr(common_name: str, organizations: Tuple[str, ...] = ()
             ) -> Tuple[str, str]:
    """Client-side key + CSR (kubeadm join's kubelet-client flow).
    Returns (private_key_pem, csr_pem)."""
    key = ec.generate_private_key(ec.SECP256R1())
    csr = (x509.CertificateSigningRequestBuilder()
           .subject_name(_name(common_name, tuple(organizations)))
           .sign(key, hashes.SHA256()))
    return (key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()).decode(),
            csr.public_bytes(serialization.Encoding.PEM).decode())


def issue_server_cert(ca: ClusterCA, common_name: str,
                      dns_sans: Sequence[str] = ("localhost",),
                      ip_sans: Sequence[str] = ("127.0.0.1",),
                      days: int = 365) -> Tuple[str, str]:
    """Serving certificate signed by the cluster CA (kubeadm certs
    phase's apiserver.crt / the kubelet serving cert). Returns
    (key_pem, cert_pem)."""
    import ipaddress

    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    san = x509.SubjectAlternativeName(
        [x509.DNSName(d) for d in dns_sans]
        + [x509.IPAddress(ipaddress.ip_address(i)) for i in ip_sans])
    cert = (x509.CertificateBuilder()
            .subject_name(_name(common_name))
            .issuer_name(ca.ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + days * _ONE_DAY)
            .add_extension(san, critical=False)
            .add_extension(x509.ExtendedKeyUsage(
                [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH]),
                critical=False)
            .sign(ca._ca_key(), hashes.SHA256()))
    return (key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()).decode(),
            cert.public_bytes(serialization.Encoding.PEM).decode())


def _load_cert_chain(ctx, cert_pem: str, key_pem: str) -> None:
    """ssl.SSLContext.load_cert_chain only reads files; stage the PEMs
    in a private tmpdir for the duration of the load."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cert_path = os.path.join(d, "tls.crt")
        key_path = os.path.join(d, "tls.key")
        with open(cert_path, "w") as f:
            f.write(cert_pem)
        fd = os.open(key_path, os.O_WRONLY | os.O_CREAT, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(key_pem)
        ctx.load_cert_chain(cert_path, key_path)


def server_ssl_context(ca_cert_pem: str, cert_pem: str, key_pem: str,
                       require_client_cert: bool = False):
    """TLS serving context trusting the cluster CA for client certs.
    CERT_OPTIONAL by default: bearer-token clients connect without a
    client cert, x509 clients are verified in the handshake (the real
    form of x509.go:76's 'verified peer chain'). The kubelet server
    uses require_client_cert=True — its only legitimate clients are
    cluster components holding CA-issued certs."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    _load_cert_chain(ctx, cert_pem, key_pem)
    ctx.load_verify_locations(cadata=ca_cert_pem)
    ctx.verify_mode = (ssl.CERT_REQUIRED if require_client_cert
                       else ssl.CERT_OPTIONAL)
    return ctx


def wrap_http_server(httpd, ctx, handshake_timeout: float = 10.0) -> None:
    """Serve `httpd` (a ThreadingHTTPServer) over TLS with the handshake
    performed in the PER-CONNECTION handler thread, not the accept loop.
    Wrapping the listener naively makes accept() run the blocking
    handshake inside serve_forever — one idle TCP connection (a port
    scan, a TCP health probe) would hang the whole server for every
    client. A handshake that stalls past handshake_timeout or fails is
    closed without touching the accept loop."""
    httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True,
                                   do_handshake_on_connect=False)
    orig_finish = httpd.finish_request

    def finish_request(request, client_address):
        try:
            request.settimeout(handshake_timeout)
            request.do_handshake()
            request.settimeout(None)
        except Exception:
            try:
                request.close()
            except OSError:
                pass
            return
        orig_finish(request, client_address)

    httpd.finish_request = finish_request


def client_ssl_context(ca_cert_pem: str,
                       client_cert_pem: Optional[str] = None,
                       client_key_pem: Optional[str] = None):
    """TLS client context: verify the server against the cluster CA
    bundle (the kubeconfig certificate-authority-data analog); present
    an x509 client credential when given (mTLS)."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cadata=ca_cert_pem)
    ctx.check_hostname = False  # identity = the CA-verified chain; nodes
    # serve on ephemeral host:port pairs the cert's SANs can't enumerate
    if client_cert_pem and client_key_pem:
        _load_cert_chain(ctx, client_cert_pem, client_key_pem)
    return ctx


def peer_identity(ssl_socket) -> Optional[Tuple[str, List[str]]]:
    """(CN, [O...]) of the VERIFIED TLS peer certificate, or None when
    the client sent none. The chain/validity checks already happened in
    the handshake against the context's CA — this only reads the
    subject (CommonNameUserConversion, x509.go:76)."""
    try:
        peer = ssl_socket.getpeercert()
    except (ValueError, AttributeError):
        return None
    if not peer:
        return None
    cn, orgs = None, []
    for rdn in peer.get("subject", ()):
        for key, value in rdn:
            if key == "commonName" and cn is None:
                cn = value
            elif key == "organizationName":
                orgs.append(value)
    if cn is None:
        return None
    return cn, orgs


def ensure_cluster_ca(store) -> ClusterCA:
    """Load the CA Secret, creating it (and kube-system) on first call —
    every component resolves the same trust root through the store."""
    from ..runtime.store import Conflict

    sec = store.get("secrets", CA_SECRET_NAMESPACE, CA_SECRET_NAME)
    if sec is None:
        ca = new_cluster_ca()
        try:
            store.create("namespaces", api.Namespace(
                metadata=api.ObjectMeta(name=CA_SECRET_NAMESPACE),
                status=api.NamespaceStatus(phase="Active")))
        except Conflict:
            pass
        try:
            store.create("secrets", api.Secret(
                metadata=api.ObjectMeta(name=CA_SECRET_NAME,
                                        namespace=CA_SECRET_NAMESPACE),
                type="kubernetes.io/cluster-ca",
                data={"ca.crt": ca.ca_cert_pem, "ca.key": ca.ca_key_pem,
                      "sa.key": ca.sa_signing_key}))
        except Conflict:
            sec = store.get("secrets", CA_SECRET_NAMESPACE, CA_SECRET_NAME)
        else:
            return ca
    return ClusterCA(ca_cert_pem=sec.data["ca.crt"],
                     ca_key_pem=sec.data["ca.key"],
                     sa_signing_key=sec.data["sa.key"])
