"""Cloud provider layer: the node groups the cluster autoscaler sizes
(a copy of the part of kubernetes_tpu/cloud/provider.py it uses)."""

from .provider import (LABEL_INSTANCE_TYPE, CloudProvider,  # noqa: F401
                       FakeCloud, NodeGroup, NodeGroups, node_from_template)
