"""Kubelet volume manager: desired/actual state reconciliation.

A copy of kubernetes_tpu/volume/manager.py; its relative imports
resolve in this package.

Reference: pkg/kubelet/volumemanager/ — DesiredStateOfWorld (what pods
need, populator populator.go), ActualStateOfWorld (what's mounted,
cache/actual_state_of_world.go), and the reconciler
(reconciler/reconciler.go:147): unmount orphans, wait for attachable
volumes to appear in node.status (the attach/detach controller's write),
then mount. WaitForAttachAndMount (volume_manager.go:371) is the
kubelet syncPod gate.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from ..api import types as api
from .mount import InMemoryMount
from .plugin import Spec, VolumePluginMgr, default_plugin_mgr


class VolumeManager:
    def __init__(self, store, node_name: str,
                 plugin_mgr: Optional[VolumePluginMgr] = None,
                 mount_backend: Optional[InMemoryMount] = None):
        self.store = store
        self.node_name = node_name
        self.plugins = plugin_mgr or default_plugin_mgr(store)
        self.mount = mount_backend or InMemoryMount()
        self._lock = threading.Lock()
        # desired: (pod uid, volume name) -> (pod, Spec)
        self._desired: Dict[Tuple[str, str], Tuple[api.Pod, Spec]] = {}
        # reconcile is called from the per-pod readiness gate, so it must
        # be a no-op unless desired state or the node's attach set changed
        self._dirty = True
        self._last_attached: Set[str] = set()

    # -- desired state populator (populator.go) ---------------------------

    def _resolve_spec(self, pod: api.Pod, v: api.Volume) -> Optional[Spec]:
        if v.pvc_name:
            pvc = self.store.get("persistentvolumeclaims", pod.namespace,
                                 v.pvc_name)
            if pvc is None or not pvc.spec.volume_name:
                return None  # unbound claim: not mountable yet
            pv = self.store.get("persistentvolumes", "", pvc.spec.volume_name) \
                or self.store.get("persistentvolumes", "default",
                                  pvc.spec.volume_name)
            if pv is None:
                return None
            # keep the pod's volume alongside the PV: mounts are keyed by
            # the POD volume name (what containers reference), while
            # plugin matching falls through to the PV's source kind
            return Spec(volume=v, pv=pv)
        return Spec(volume=v)

    def _mountable(self, pod: api.Pod, v: api.Volume) -> Optional[Spec]:
        """Spec for a volume this manager can mount; None for unbound
        claims (gate stays closed) and for sources no plugin recognizes
        (ignored entirely, matching the pre-plugin-layer gate that only
        looked at PVC claims — a raise here would take down the whole
        kubelet sync loop)."""
        spec = self._resolve_spec(pod, v)
        if spec is None:
            return None
        try:
            self.plugins.find_plugin_by_spec(spec)
        except ValueError:
            return None
        return spec

    def note_pod(self, pod: api.Pod) -> None:
        """Add/refresh a pod's volumes in the desired state."""
        with self._lock:
            for v in pod.spec.volumes:
                spec = self._mountable(pod, v)
                key = (pod.metadata.uid, v.name)
                if spec is not None and key not in self._desired:
                    self._desired[key] = (pod, spec)
                    self._dirty = True

    def forget_pod(self, pod_uid: str) -> None:
        with self._lock:
            for key in [k for k in self._desired if k[0] == pod_uid]:
                del self._desired[key]
                self._dirty = True

    # -- reconciler (reconciler.go:147) -----------------------------------

    def reconcile(self, node: Optional[api.Node] = None) -> None:
        """Unmount what's mounted but not desired; mount what's desired,
        PV-backed attachable volumes only once the attach/detach
        controller has recorded them on the node. Inline attachable
        volumes (pod-spec GCEPD/EBS/...) mount without waiting: the
        controller only manages PV-backed attachments
        (controllers/attachdetach.py) — for inline sources the kubelet
        itself is the attacher, as when the reference runs with
        --enable-controller-attach-detach=false."""
        attached = set(node.status.volumes_attached) if node else set()
        with self._lock:
            if not self._dirty and attached == self._last_attached:
                return
            self._dirty = False
            self._last_attached = attached
            desired = dict(self._desired)
        mounted: Set[Tuple[str, str]] = {
            (m.pod_uid, m.volume_name) for m in self.mount.list()}
        for pod_uid, vname in mounted - set(desired):
            # orphaned mount: the pod is gone (reconciler.go:166).
            # Tear down through the owning plugin — out-of-process
            # plugins (CSI NodeUnpublish) must observe the unmount, not
            # just the mount table
            rec = self.mount.get(pod_uid, vname)
            plugin = (self.plugins.find_plugin_by_name(rec.kind)
                      if rec is not None else None)
            if plugin is not None:
                try:
                    plugin.new_unmounter(vname, pod_uid,
                                         self.mount).tear_down()
                except Exception:
                    # the mount record survives a failed out-of-process
                    # teardown so the next pass retries NodeUnpublish —
                    # dropping it would leak the driver's publish state
                    self._dirty = True
            else:
                self.mount.unmount(pod_uid, vname)
        still_waiting = False
        for (pod_uid, vname), (pod, spec) in desired.items():
            if (pod_uid, vname) in mounted:
                continue
            plugin = self.plugins.find_plugin_by_spec(spec)
            if plugin.attachable and spec.pv is not None:
                if spec.pv.metadata.name not in attached:
                    still_waiting = True
                    continue  # waiting on the attach/detach controller
            try:
                plugin.new_mounter(spec, pod, self.mount, self.store,
                                   mgr=self.plugins).set_up()
            except Exception as e:
                # an out-of-process mount (CSI NodePublish) can fail or
                # time out; the pod stays gated and the mount retries
                # next pass — a raise here would take down the whole
                # kubelet sync loop and (worse) leave _dirty cleared,
                # wedging the manager permanently
                import sys

                print(f"# volume mount {vname!r} for pod {pod_uid} "
                      f"failed: {e}", file=sys.stderr)
                still_waiting = True
        if still_waiting:
            self._dirty = True  # retry next pass even if nothing changes

    # -- kubelet gate (volume_manager.go:371) ------------------------------

    def volumes_ready(self, pod: api.Pod,
                      node: Optional[api.Node] = None) -> bool:
        """All of the pod's volumes mounted? (WaitForAttachAndMount, minus
        the blocking — the kubelet sync loop polls.) Runs one reconcile
        pass first so ready pods don't wait an extra sync."""
        self.note_pod(pod)
        self.reconcile(node)  # no-op unless desired/attach state changed
        for v in pod.spec.volumes:
            if v.pvc_name:
                pass  # claim-backed: must mount (gate stays closed if unbound)
            elif self._mountable(pod, v) is None:
                continue  # unrecognized source: never gates the pod
            if self.mount.get(pod.metadata.uid, v.name) is None:
                return False
        return True

    def mounted_payload(self, pod: api.Pod, volume_name: str):
        m = self.mount.get(pod.metadata.uid, volume_name)
        return None if m is None else m.payload
