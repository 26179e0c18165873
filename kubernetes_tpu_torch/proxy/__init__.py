"""Service dataplane — pkg/proxy analog.

A copy of kubernetes_tpu/proxy/__init__.py; its relative imports
resolve in this package.
"""

from .proxier import Endpoint, HealthCheckServer, ProxyRule, Proxier
from .userspace import UserspaceProxier
