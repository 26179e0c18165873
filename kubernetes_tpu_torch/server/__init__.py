"""Generic API server: HTTP REST + watch over the object store.

A copy of kubernetes_tpu/server/__init__.py; its relative imports resolve in this
package.

Analog of the reference's kube-apiserver stack — generic server handler
chain (apiserver/pkg/server/config.go DefaultBuildHandlerChainFunc),
REST storage (registry/generic/registry/store.go), admission
(pkg/admission/ + plugin/pkg/admission/), RBAC authorization
(plugin/pkg/auth/authorizer/rbac/), audit (pkg/audit/).
"""

from .apiserver import APIServer
from .auth import RBACAuthorizer, TokenAuthenticator
from .admission import (AdmissionChain, AdmissionError, DefaultTolerationSeconds,
                        NamespaceLifecycle, NodeRestriction, PriorityAdmission,
                        ResourceQuotaAdmission)
