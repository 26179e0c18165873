"""Certificates controllers: CSR auto-approval and signing.

A copy of kubernetes_tpu/controllers/certificates.py; its relative imports
resolve in this package.

Reference: pkg/controller/certificates/ — the approver
(approver/sarapprove.go) auto-approves kubelet CSRs whose requestor is
the node itself (self-node client certs), and the signer
(signer/signer.go) issues the certificate for approved CSRs. The signer
is REAL x509: a PEM CSR in spec.request is signed by the cluster CA
(server/pki.py) and the resulting cert is accepted by the apiserver's
x509 authn path — kubeadm join bootstraps kubelet identity through it.
Non-PEM requests (legacy opaque payloads) still get the digest-token
certificate so old callers keep working.
"""

from __future__ import annotations

import hashlib

from ..api import types as api
from .base import Controller

KUBELET_USAGES = {"digital signature", "key encipherment", "client auth"}


def is_self_node_csr(csr: api.CertificateSigningRequest) -> bool:
    """approver/sarapprove.go isSelfNodeClientCert: requested by a node
    for ITS OWN identity, with exactly the kubelet client usages. The
    CSR subject must name the requestor (x509cr.Subject.CommonName ==
    csr.Spec.Username) — without that check any node could mint another
    node's certificate through auto-approval."""
    if not csr.spec.username.startswith("system:node:"):
        return False
    if "system:nodes" not in csr.spec.groups:
        return False
    if set(csr.spec.usages) != KUBELET_USAGES:
        return False
    subj = _pem_subject(csr.spec.request)
    if subj is None:
        # legacy opaque (non-PEM) payloads carry no subject to verify;
        # their digest-token certs never impersonate an x509 identity
        return True
    cn, orgs = subj
    return cn == csr.spec.username and orgs == ["system:nodes"]


def _pem_subject(csr_pem: str):
    """(CN, [O...]) of a PEM CSR, or None if unparseable."""
    try:
        from cryptography import x509
        from cryptography.x509.oid import NameOID

        req = x509.load_pem_x509_csr(csr_pem.encode())
        cn = req.subject.get_attributes_for_oid(NameOID.COMMON_NAME)
        orgs = req.subject.get_attributes_for_oid(
            NameOID.ORGANIZATION_NAME)
        if not cn:
            return None
        return cn[0].value, [o.value for o in orgs]
    except Exception:
        return None


def is_node_bootstrap_csr(csr: api.CertificateSigningRequest) -> bool:
    """approver sarapprove.go isNodeClientCert for the kubeadm join
    flow: a system:bootstrappers requestor asking for a node client
    identity (subject CN system:node:<x>, O [system:nodes]) with the
    kubelet usages."""
    if "system:bootstrappers" not in csr.spec.groups:
        return False
    if set(csr.spec.usages) != KUBELET_USAGES:
        return False
    subj = _pem_subject(csr.spec.request)
    if subj is None:
        return False
    cn, orgs = subj
    return cn.startswith("system:node:") and orgs == ["system:nodes"]


class CSRApprovingController(Controller):
    name = "csrapproving"

    def __init__(self, store):
        super().__init__(store)
        self.informer("certificatesigningrequests")

    def sync(self, key: str):
        name = key.split("/", 1)[-1]
        csr = self.store.get("certificatesigningrequests", "default", name) \
            or self.store.get("certificatesigningrequests", "", name)
        if csr is None or csr.approved or csr.denied:
            return
        if is_self_node_csr(csr):
            csr.status.conditions.append(
                ("Approved", "AutoApproved self node client cert"))
            self.store.update("certificatesigningrequests", csr)
        elif is_node_bootstrap_csr(csr):
            csr.status.conditions.append(
                ("Approved", "AutoApproved node bootstrap client cert"))
            self.store.update("certificatesigningrequests", csr)


class CSRSigningController(Controller):
    name = "csrsigning"

    def __init__(self, store, ca_name: str = "kubernetes-tpu-ca"):
        super().__init__(store)
        self.ca_name = ca_name
        self._ca = None
        self.informer("certificatesigningrequests")

    def _cluster_ca(self):
        if self._ca is None:
            from ..server import pki

            self._ca = pki.ensure_cluster_ca(self.store)
        return self._ca

    def sync(self, key: str):
        name = key.split("/", 1)[-1]
        csr = self.store.get("certificatesigningrequests", "default", name) \
            or self.store.get("certificatesigningrequests", "", name)
        if csr is None or not csr.approved or csr.status.certificate:
            return
        if "BEGIN CERTIFICATE REQUEST" in csr.spec.request:
            # real x509 path (signer.go Sign): issue from the cluster CA
            csr.status.certificate = self._cluster_ca().sign_csr(
                csr.spec.request)
        else:
            digest = hashlib.sha256(
                f"{self.ca_name}/{csr.spec.username}/{csr.spec.request}"
                .encode()).hexdigest()
            csr.status.certificate = f"cert:{csr.spec.username}:{digest[:32]}"
        self.store.update("certificatesigningrequests", csr)
