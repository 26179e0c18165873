"""Volume plugin layer — pkg/volume analog.

A copy of kubernetes_tpu/volume/__init__.py; its relative imports
resolve in this package.
"""

from .plugin import (Attacher, Detacher, Mounter, Spec, Unmounter,
                     VolumePlugin, VolumePluginMgr, default_plugin_mgr)
from .mount import InMemoryMount, MountPoint
from .manager import VolumeManager
