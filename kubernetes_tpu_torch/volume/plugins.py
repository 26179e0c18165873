"""In-tree volume plugins.

A copy of kubernetes_tpu/volume/plugins.py; its relative imports
resolve in this package.

Reference: pkg/volume/{empty_dir,host_path,configmap,secret,
downward_api,projected,nfs,local,gce_pd,aws_ebs,azure_dd,rbd,iscsi}/ —
each directory is one plugin implementing CanSupport + mounters. The
API-backed plugins (configmap/secret/downward/projected) materialize
store content into the mount payload, re-resolved at every SetUp the
same way the reference re-fetches on remount (configmap.go:191).
"""

from __future__ import annotations

from typing import Dict

from ..api import types as api
from .plugin import Attacher, Detacher, Mounter, Spec, VolumePlugin

PD_KINDS = ("GCEPersistentDisk", "AWSElasticBlockStore", "AzureDisk",
            "RBD", "ISCSI")


class EmptyDirPlugin(VolumePlugin):
    name = "kubernetes.io/empty-dir"

    def can_support(self, spec: Spec) -> bool:
        return spec.volume is not None and spec.volume.empty_dir


class HostPathPlugin(VolumePlugin):
    name = "kubernetes.io/host-path"

    def can_support(self, spec: Spec) -> bool:
        return spec.volume is not None and bool(spec.volume.host_path)

    def new_mounter(self, spec, pod, mount_backend, store=None,
                    mgr=None):
        class _M(Mounter):
            def payload(self):
                return {"hostPath": self.spec.volume.host_path}

        return _M(self, spec, pod, mount_backend, store)


class _APIBackedMounter(Mounter):
    kind = ""
    field = ""

    def payload(self) -> Dict[str, str]:
        name = getattr(self.spec.volume, self.field)
        obj = (self.store.get(self.kind, self.pod.namespace, name)
               if self.store is not None else None)
        if obj is None:
            # reference: missing optional sources mount empty; missing
            # required ones error — modeled as empty + marker
            return {"__missing__": name}
        return dict(obj.data)


class ConfigMapPlugin(VolumePlugin):
    name = "kubernetes.io/configmap"

    def can_support(self, spec: Spec) -> bool:
        return spec.volume is not None and bool(spec.volume.config_map)

    def new_mounter(self, spec, pod, mount_backend, store=None,
                    mgr=None):
        class _M(_APIBackedMounter):
            kind, field = "configmaps", "config_map"

        return _M(self, spec, pod, mount_backend, store)


class SecretPlugin(VolumePlugin):
    name = "kubernetes.io/secret"

    def can_support(self, spec: Spec) -> bool:
        return spec.volume is not None and bool(spec.volume.secret)

    def new_mounter(self, spec, pod, mount_backend, store=None,
                    mgr=None):
        class _M(_APIBackedMounter):
            kind, field = "secrets", "secret"

        return _M(self, spec, pod, mount_backend, store)


class DownwardAPIPlugin(VolumePlugin):
    name = "kubernetes.io/downward-api"

    def can_support(self, spec: Spec) -> bool:
        return spec.volume is not None and bool(spec.volume.downward_api)

    def new_mounter(self, spec, pod, mount_backend, store=None,
                    mgr=None):
        class _M(Mounter):
            def payload(self):
                out = {}
                meta = self.pod.metadata
                fields = {
                    "metadata.name": meta.name,
                    "metadata.namespace": meta.namespace,
                    "metadata.uid": meta.uid,
                    "spec.nodeName": self.pod.spec.node_name,
                }
                for path, ref in self.spec.volume.downward_api.items():
                    out[path] = fields.get(ref, "")
                return out

        return _M(self, spec, pod, mount_backend, store)


class ProjectedPlugin(VolumePlugin):
    """projected/projected.go — one mount fed by several sub-sources."""

    name = "kubernetes.io/projected"
    _default_mgr = None

    def can_support(self, spec: Spec) -> bool:
        return spec.volume is not None and bool(spec.volume.projected)

    def new_mounter(self, spec, pod, mount_backend, store=None,
                    mgr=None):
        outer = self
        if mgr is None:
            # fallback for direct plugin use; cached, not per-SetUp
            from .plugin import default_plugin_mgr

            if ProjectedPlugin._default_mgr is None:
                ProjectedPlugin._default_mgr = default_plugin_mgr()
            mgr = ProjectedPlugin._default_mgr

        class _M(Mounter):
            def payload(self):
                merged: Dict[str, str] = {}
                for sub in self.spec.volume.projected:
                    sub_spec = Spec(volume=sub)
                    p = mgr.find_plugin_by_spec(sub_spec)
                    if p.name == outer.name:
                        continue  # no recursive projection
                    m = p.new_mounter(sub_spec, self.pod, self.mount,
                                      self.store, mgr=mgr)
                    merged.update(m.payload())
                return merged

        return _M(self, spec, pod, mount_backend, store)


class NFSPlugin(VolumePlugin):
    name = "kubernetes.io/nfs"

    def can_support(self, spec: Spec) -> bool:
        return spec.volume is not None and bool(spec.volume.nfs_server)

    def new_mounter(self, spec, pod, mount_backend, store=None,
                    mgr=None):
        class _M(Mounter):
            def payload(self):
                v = self.spec.volume
                return {"server": v.nfs_server, "path": v.nfs_path}

        return _M(self, spec, pod, mount_backend, store)


class LocalPlugin(VolumePlugin):
    name = "kubernetes.io/local-volume"

    def can_support(self, spec: Spec) -> bool:
        return (spec.pv is not None
                and spec.pv.spec.source_kind == "Local")


class _PDAttacher(Attacher):
    def __init__(self, registry):
        self.registry = registry  # (volume, node) attachment set

    def attach(self, spec: Spec, node_name: str) -> str:
        self.registry.add((spec.name, node_name))
        return spec.name


class _PDDetacher(Detacher):
    def __init__(self, registry):
        self.registry = registry

    def detach(self, volume_name: str, node_name: str) -> None:
        self.registry.discard((volume_name, node_name))


class PDPlugin(VolumePlugin):
    """One attachable block-device plugin per cloud disk family
    (gce_pd/aws_ebs/azure_dd/rbd/iscsi directories in the reference;
    the per-cloud differences are provider API calls, which live behind
    the cloud seam here)."""

    attachable = True

    def __init__(self, kind: str):
        assert kind in PD_KINDS, kind
        self.kind = kind
        self.name = f"kubernetes.io/{kind.lower()}"
        self.attachments = set()

    def can_support(self, spec: Spec) -> bool:
        return spec.source_kind == self.kind

    def new_attacher(self) -> _PDAttacher:
        return _PDAttacher(self.attachments)

    def new_detacher(self) -> _PDDetacher:
        return _PDDetacher(self.attachments)
