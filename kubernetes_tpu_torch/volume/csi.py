"""CSI: the out-of-process volume driver seam.

A copy of kubernetes_tpu/volume/csi.py; its relative imports resolve in this
package.

Reference: pkg/volume/csi/csi_plugin.go:45 — the in-tree "csi" plugin is
a SHIM: every operation crosses a process boundary to a driver speaking
the CSI protocol (gRPC over a unix socket; Identity/Controller/Node
services). The extensibility seam is the point, not any particular
driver. Here the wire protocol is JSON-over-HTTP on a loopback socket —
same boundary, same RPC shapes:

  GET  /identity                      GetPluginInfo
  POST /controller/create-volume      CreateVolume      {name, capacity}
  POST /controller/delete-volume      DeleteVolume      {volume_id}
  POST /controller/publish            ControllerPublishVolume {volume_id, node}
  POST /controller/unpublish          ControllerUnpublishVolume
  POST /node/publish                  NodePublishVolume {volume_id, pod_uid, target}
  POST /node/unpublish                NodeUnpublishVolume

Driver DISCOVERY is an API object: creating a `CSIDriver` (name +
endpoint) registers the driver cluster-wide — the analog of the
kubelet's plugin-socket watcher plus the CSIDriver object of later
Kubernetes. The shim (CSIPlugin) resolves endpoints through the store
at call time, so drivers can appear/disappear at runtime.

A pod's CSI volume flows exactly like any attachable in-tree volume:
the provisioner creates the PV (CreateVolume), the PV controller binds
the claim, the scheduler places the pod, the attach/detach controller
calls ControllerPublishVolume before recording the attachment in
node.status, the kubelet volume manager gates on that and then calls
NodePublishVolume to mount, and teardown unwinds through
NodeUnpublish/ControllerUnpublish/DeleteVolume.

`python -m kubernetes_tpu_torch.volume.csi --port N` serves the in-memory
mock driver standalone — a genuinely separate process, for the
out-of-process integration test.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..api import types as api
from .plugin import Mounter, Spec, Unmounter, VolumePlugin

CSI_SOURCE_KIND = "CSI"
# the reference external-provisioner's claim annotation
PROVISIONER_ANNOTATION = "volume.beta.kubernetes.io/storage-provisioner"


class CSIError(Exception):
    pass


# -- the driver side (what a storage vendor ships) ----------------------------


class MockCSIDriver:
    """In-memory driver implementing the protocol semantics the CSI spec
    demands: idempotent creates, publish tracked per (volume, node),
    node-publish tracked per (volume, target); operations on unknown
    volumes fail. The csi-sanity mock driver analog."""

    def __init__(self, name: str = "mock.csi.k8s.io"):
        self.name = name
        self._lock = threading.Lock()
        self.volumes: Dict[str, dict] = {}          # id -> {name, capacity}
        self.published: Dict[str, str] = {}         # id -> node
        self.node_published: Dict[tuple, dict] = {}  # (id, target) -> info

    def handle(self, method: str, path: str, body: dict) -> dict:
        if path == "/identity":
            return {"name": self.name, "capabilities":
                    ["CONTROLLER_SERVICE", "CREATE_DELETE_VOLUME"]}
        with self._lock:
            if path == "/controller/create-volume":
                name = body["name"]
                for vid, v in self.volumes.items():
                    if v["name"] == name:  # idempotency by name
                        return {"volume_id": vid,
                                "capacity": v["capacity"]}
                vid = f"vol-{len(self.volumes)}-{name}"
                self.volumes[vid] = {"name": name,
                                     "capacity": int(body.get("capacity", 0))}
                return {"volume_id": vid,
                        "capacity": self.volumes[vid]["capacity"]}
            if path == "/controller/delete-volume":
                self.volumes.pop(body["volume_id"], None)  # idempotent
                return {}
            vid = body.get("volume_id")
            if path == "/controller/publish":
                if vid not in self.volumes:
                    raise CSIError(f"unknown volume {vid!r}")
                node = body["node"]
                cur = self.published.get(vid)
                if cur is not None and cur != node:
                    raise CSIError(f"{vid} already published to {cur}")
                self.published[vid] = node
                return {"publish_context": {"device": f"/dev/csi/{vid}"}}
            if path == "/controller/unpublish":
                self.published.pop(vid, None)
                return {}
            if path == "/node/publish":
                if vid not in self.volumes:
                    raise CSIError(f"unknown volume {vid!r}")
                key = (vid, body["target"])
                self.node_published[key] = {"pod_uid": body.get("pod_uid")}
                return {"payload": {"csi/device": f"/dev/csi/{vid}"}}
            if path == "/node/unpublish":
                self.node_published.pop((vid, body.get("target")), None)
                return {}
        raise CSIError(f"unknown CSI call {path!r}")


class CSIDriverServer:
    """Serves a driver implementation over the wire protocol."""

    def __init__(self, driver, host: str = "127.0.0.1", port: int = 0):
        self.driver = driver
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _serve(self):
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    resp = outer.driver.handle(self.command, self.path, body)
                    code, payload = 200, json.dumps(resp).encode()
                except CSIError as e:
                    code, payload = 422, json.dumps(
                        {"error": str(e)}).encode()
                except Exception as e:
                    code, payload = 500, json.dumps(
                        {"error": repr(e)}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = _serve

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CSIDriverServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="csi-driver")
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


# -- the cluster side (the in-tree shim) --------------------------------------


class CSIClient:
    """HTTP client for one driver endpoint."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def call(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.url + path, method=method,
            data=json.dumps(body or {}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", "")
            except Exception:
                msg = str(e)
            raise CSIError(msg)
        except OSError as e:
            raise CSIError(f"driver unreachable: {e}")


def register_driver(store, name: str, endpoint: str) -> None:
    """Publish a CSIDriver object — cluster-wide driver discovery."""
    from ..runtime.store import Conflict

    try:
        store.create("csidrivers", api.CSIDriver(
            metadata=api.ObjectMeta(name=name, namespace=""),
            endpoint=endpoint))
    except Conflict:
        cur = store.get("csidrivers", "", name)
        if cur is not None and cur.endpoint != endpoint:
            cur.endpoint = endpoint
            store.update("csidrivers", cur)


def _client_for(store, driver_name: str,
                timeout: float = 10.0) -> CSIClient:
    obj = (store.get("csidrivers", "", driver_name)
           or store.get("csidrivers", "default", driver_name))
    if obj is None:
        raise CSIError(f"CSI driver {driver_name!r} is not registered")
    return CSIClient(obj.endpoint, timeout=timeout)


class _CSIMounter(Mounter):
    def set_up(self) -> None:
        pv = self.spec.pv
        client = _client_for(self.store, pv.spec.csi_driver)
        target = f"{self.pod.metadata.uid}/{self.spec.name}"
        resp = client.call("POST", "/node/publish", {
            "volume_id": pv.spec.source_id,
            "pod_uid": self.pod.metadata.uid,
            "target": target})
        payload = dict(resp.get("payload") or {})
        # teardown needs the driver + handle + target; carry them on the
        # mount record (the reference writes vol_data.json next to the
        # mount dir for the same reason)
        payload["csi/driver"] = pv.spec.csi_driver
        payload["csi/handle"] = pv.spec.source_id
        payload["csi/target"] = target
        self.mount.mount(self.pod.metadata.uid, self.spec.name,
                         kind=self.plugin.name, payload=payload,
                         read_only=(self.spec.volume.read_only
                                    if self.spec.volume else False))


class _CSIUnmounter(Unmounter):
    def __init__(self, plugin, volume_name, pod_uid, mount_backend, store):
        super().__init__(plugin, volume_name, pod_uid, mount_backend)
        self.store = store

    def tear_down(self) -> None:
        m = self.mount.get(self.pod_uid, self.volume_name)
        if m is not None and m.payload.get("csi/driver"):
            # NodeUnpublish must SUCCEED before the mount record is
            # dropped: the record is the only state that drives retries,
            # so removing it on failure would leak the driver's
            # node-publish entry forever (the driver may then refuse
            # ControllerUnpublish/DeleteVolume). The raise is caught by
            # the volume manager, which keeps the record and retries.
            _client_for(self.store, m.payload["csi/driver"]).call(
                "POST", "/node/unpublish", {
                    "volume_id": m.payload.get("csi/handle"),
                    "target": m.payload.get("csi/target")})
        self.mount.unmount(self.pod_uid, self.volume_name)


class _CSIAttacher:
    def __init__(self, store):
        self.store = store

    def attach(self, spec: Spec, node_name: str) -> str:
        pv = spec.pv
        # short timeout: this runs inside the attach/detach controller's
        # sync — a dead driver must not stall the worker 10s per volume
        # per retry while unrelated nodes queue behind it
        client = _client_for(self.store, pv.spec.csi_driver, timeout=2.0)
        client.call("POST", "/controller/publish", {
            "volume_id": pv.spec.source_id, "node": node_name})
        return pv.metadata.name

    def wait_for_attach(self, spec: Spec, node) -> bool:
        return (spec.pv is not None and
                spec.pv.metadata.name in set(node.status.volumes_attached))


class _CSIDetacher:
    def __init__(self, store):
        self.store = store

    def detach_pv(self, pv: api.PersistentVolume, node_name: str) -> None:
        client = _client_for(self.store, pv.spec.csi_driver, timeout=2.0)
        client.call("POST", "/controller/unpublish", {
            "volume_id": pv.spec.source_id, "node": node_name})


class CSIPlugin(VolumePlugin):
    """csi_plugin.go:45 — the shim. All state lives in the driver and
    the API objects; the plugin itself is stateless (safe to construct
    per component)."""

    name = "kubernetes.io/csi"
    attachable = True

    def __init__(self, store=None):
        self.store = store

    def can_support(self, spec: Spec) -> bool:
        return spec.source_kind == CSI_SOURCE_KIND

    def new_mounter(self, spec, pod, mount_backend, store=None, mgr=None):
        return _CSIMounter(self, spec, pod, mount_backend,
                           store or self.store)

    def new_unmounter(self, volume_name, pod_uid, mount_backend):
        return _CSIUnmounter(self, volume_name, pod_uid, mount_backend,
                             self.store)

    def new_attacher(self) -> _CSIAttacher:
        return _CSIAttacher(self.store)

    def new_detacher(self) -> _CSIDetacher:
        return _CSIDetacher(self.store)


# -- dynamic provisioning (external-provisioner analog) -----------------------


class CSIProvisioner:
    """external-provisioner sidecar analog: claims annotated with
    volume.beta.kubernetes.io/storage-provisioner=<driver> get a PV
    provisioned via CreateVolume; deleting a bound claim whose PV was
    provisioned here deletes the backing volume (reclaim policy Delete,
    the provisioner default)."""

    def __init__(self, store, driver_name: str):
        self.store = store
        self.driver_name = driver_name

    def sync(self) -> int:
        from ..runtime.store import Conflict

        made = 0
        pvs = {pv.metadata.name: pv
               for pv in self.store.list("persistentvolumes")}
        claims = list(self.store.list("persistentvolumeclaims"))
        claimed = {pvc.spec.volume_name for pvc in claims
                   if pvc.spec.volume_name}
        # PVs provisioned for a claim the binder hasn't processed yet:
        # the claim references them by CONSTRUCTION (pvc-<uid> naming),
        # not yet by volume_name — reclaiming those would provision/
        # destroy flip-flop and could delete the backing volume out from
        # under a concurrent bind
        claimed |= {f"pvc-{pvc.metadata.uid}" for pvc in claims}
        for pvc in claims:
            ann = (pvc.metadata.annotations or {}).get(
                PROVISIONER_ANNOTATION)
            if ann != self.driver_name or pvc.spec.volume_name:
                continue
            pv_name = f"pvc-{pvc.metadata.uid}"
            if pv_name in pvs:
                continue  # provisioned, waiting for the binder
            capacity = int(pvc.spec.requests.get("storage", 0))
            client = _client_for(self.store, self.driver_name)
            resp = client.call("POST", "/controller/create-volume", {
                "name": pv_name, "capacity": capacity})
            pv = api.PersistentVolume(
                metadata=api.ObjectMeta(
                    name=pv_name, namespace="",
                    annotations={PROVISIONER_ANNOTATION: self.driver_name}),
                spec=api.PersistentVolumeSpec(
                    source_kind=CSI_SOURCE_KIND,
                    source_id=resp["volume_id"],
                    csi_driver=self.driver_name,
                    capacity={"storage": capacity},
                    storage_class_name=pvc.spec.storage_class_name))
            try:
                self.store.create("persistentvolumes", pv)
                made += 1
            except Conflict:
                pass
        # reclaim: a provisioned PV whose claim is gone -> DeleteVolume
        for pv in list(pvs.values()):
            if (pv.metadata.annotations or {}).get(
                    PROVISIONER_ANNOTATION) != self.driver_name:
                continue
            if pv.metadata.name in claimed:
                continue
            try:
                client = _client_for(self.store, self.driver_name)
                client.call("POST", "/controller/delete-volume",
                            {"volume_id": pv.spec.source_id})
                self.store.delete("persistentvolumes", "",
                                  pv.metadata.name)
            except (CSIError, KeyError):
                pass
        return made


def main(argv=None) -> int:
    """Standalone mock driver process: prints its endpoint, serves until
    killed. The out-of-process half of the CSI integration test."""
    import argparse
    import sys
    import time

    ap = argparse.ArgumentParser(prog="csi-mock-driver")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--name", default="mock.csi.k8s.io")
    args = ap.parse_args(argv)
    srv = CSIDriverServer(MockCSIDriver(args.name), port=args.port).start()
    print(srv.url, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
