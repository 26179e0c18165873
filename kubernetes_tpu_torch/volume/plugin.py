"""Volume plugin framework.

A copy of kubernetes_tpu/volume/plugin.py; its relative imports resolve in this
package.

Reference: pkg/volume/plugins.go (VolumePlugin interface :87,
VolumePluginMgr :318 FindPluginBySpec) and pkg/volume/volume.go
(Mounter/Unmounter :91-123, Attacher/Detacher in attacher.go). The
reference resolves a pod volume to exactly one plugin by probing every
registered plugin's CanSupport; attachable plugins additionally
participate in the attach/detach controller's flow before kubelet
mounts. The same seams are kept here so the kubelet volume manager
(manager.py), the attach/detach controller, and the scheduler's volume
predicates all speak plugin language rather than switch on source kinds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..api import types as api


@dataclass
class Spec:
    """What the reference calls volume.Spec: either a pod-inline volume
    or a PersistentVolume (plugins.go:58)."""

    volume: Optional[api.Volume] = None
    pv: Optional[api.PersistentVolume] = None

    @property
    def name(self) -> str:
        if self.volume is not None:
            return self.volume.name
        return self.pv.metadata.name if self.pv is not None else ""

    @property
    def source_kind(self) -> str:
        if self.volume is not None and self.volume.source_kind:
            return self.volume.source_kind
        if self.pv is not None:
            return self.pv.spec.source_kind
        return ""


class Mounter:
    """volume.go:100 Mounter — SetUp makes the volume available at the
    pod's mount point."""

    def __init__(self, plugin: "VolumePlugin", spec: Spec, pod: api.Pod,
                 mount_backend, store=None):
        self.plugin = plugin
        self.spec = spec
        self.pod = pod
        self.mount = mount_backend
        self.store = store

    def payload(self) -> Dict[str, str]:
        """Data materialized into the mount (configmap/secret/downward
        content; empty for block/fs volumes)."""
        return {}

    def set_up(self) -> None:
        self.mount.mount(self.pod.metadata.uid, self.spec.name,
                         kind=self.plugin.name, payload=self.payload(),
                         read_only=(self.spec.volume.read_only
                                    if self.spec.volume else False))


class Unmounter:
    def __init__(self, plugin: "VolumePlugin", volume_name: str,
                 pod_uid: str, mount_backend):
        self.plugin = plugin
        self.volume_name = volume_name
        self.pod_uid = pod_uid
        self.mount = mount_backend

    def tear_down(self) -> None:
        self.mount.unmount(self.pod_uid, self.volume_name)


class Attacher:
    """attacher.go Attacher: Attach returns once the volume is reachable
    from the node; the controller records it in node.status."""

    def attach(self, spec: Spec, node_name: str) -> str:
        raise NotImplementedError

    def wait_for_attach(self, spec: Spec, node) -> bool:
        attached = set(node.status.volumes_attached)
        return (spec.pv is not None
                and spec.pv.metadata.name in attached)


class Detacher:
    def detach(self, volume_name: str, node_name: str) -> None:
        raise NotImplementedError


class VolumePlugin:
    """plugins.go:87 VolumePlugin."""

    name = "abstract"
    attachable = False

    def can_support(self, spec: Spec) -> bool:
        raise NotImplementedError

    def new_mounter(self, spec: Spec, pod: api.Pod, mount_backend,
                    store=None, mgr: "Optional[VolumePluginMgr]" = None
                    ) -> Mounter:
        """mgr: the configured plugin manager, for plugins that resolve
        sub-sources (projected) — they must consult the SAME roster the
        volume manager was built with, not a fresh default."""
        return Mounter(self, spec, pod, mount_backend, store)

    def new_unmounter(self, volume_name: str, pod_uid: str,
                      mount_backend) -> Unmounter:
        return Unmounter(self, volume_name, pod_uid, mount_backend)


class GenericPVPlugin(VolumePlugin):
    """Fallback for PersistentVolumes without a recognized source kind
    (this model allows source-less PVs; the reference would reject them
    at validation). Attachable: the attach/detach controller manages
    every PV-backed volume here, so the kubelet still gates on
    node.status.volumesAttached."""

    name = "kubernetes.io/generic-pv"
    attachable = True

    def can_support(self, spec: Spec) -> bool:
        return False  # fallback only, never matched in the scan


class VolumePluginMgr:
    """plugins.go:318 — exactly-one-plugin resolution."""

    def __init__(self, plugins: List[VolumePlugin]):
        self.plugins = list(plugins)
        self._generic_pv = GenericPVPlugin()

    def find_plugin_by_spec(self, spec: Spec) -> VolumePlugin:
        matches = [p for p in self.plugins if p.can_support(spec)]
        if not matches:
            if spec.pv is not None:
                return self._generic_pv
            raise ValueError(f"no volume plugin supports {spec.name!r}")
        if len(matches) > 1:
            names = [p.name for p in matches]
            raise ValueError(f"multiple plugins match {spec.name!r}: {names}")
        return matches[0]

    def find_attachable_plugin_by_spec(self, spec: Spec
                                       ) -> Optional[VolumePlugin]:
        try:
            p = self.find_plugin_by_spec(spec)
        except ValueError:
            return None
        return p if p.attachable else None

    def find_plugin_by_name(self, name: str) -> Optional[VolumePlugin]:
        """Resolve a plugin from a mount record's kind — the teardown
        direction (the reference resolves the same way from the mount
        dir's vol_data.json)."""
        return next((p for p in self.plugins if p.name == name), None)


def default_plugin_mgr(store=None) -> VolumePluginMgr:
    """ProbeVolumePlugins analog (cmd/kube-controller-manager/app/
    plugins.go:56 + pkg/kubelet/volume_host.go): the in-tree roster plus
    the CSI shim (which needs the store to resolve driver endpoints)."""
    from . import plugins as pl
    from .csi import CSIPlugin

    return VolumePluginMgr([
        pl.EmptyDirPlugin(), pl.HostPathPlugin(), pl.ConfigMapPlugin(),
        pl.SecretPlugin(), pl.DownwardAPIPlugin(), pl.ProjectedPlugin(),
        pl.NFSPlugin(), pl.LocalPlugin(),
        pl.PDPlugin("GCEPersistentDisk"),
        pl.PDPlugin("AWSElasticBlockStore"),
        pl.PDPlugin("AzureDisk"), pl.PDPlugin("RBD"), pl.PDPlugin("ISCSI"),
        CSIPlugin(store),
    ])
