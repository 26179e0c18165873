"""Mount backend — pkg/util/mount analog.

A copy of kubernetes_tpu/volume/mount.py; its relative imports resolve in this
package.

The reference's mount.Interface wraps the real mount(2)/umount(2)
syscalls; tests run against FakeMounter's in-memory mount table
(util/mount/fake.go). This framework's node model has no real
filesystems, so the in-memory table IS the dataplane: a mount point
per (pod uid, volume name) carrying the materialized payload for
API-backed volumes (configmap/secret/downward), which is what the pod's
containers would read.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class MountPoint:
    pod_uid: str
    volume_name: str
    kind: str
    payload: Dict[str, str] = field(default_factory=dict)
    read_only: bool = False


class InMemoryMount:
    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[Tuple[str, str], MountPoint] = {}
        self.mount_count = 0
        self.unmount_count = 0

    def mount(self, pod_uid: str, volume_name: str, kind: str,
              payload=None, read_only: bool = False) -> None:
        with self._lock:
            self._table[(pod_uid, volume_name)] = MountPoint(
                pod_uid=pod_uid, volume_name=volume_name, kind=kind,
                payload=dict(payload or {}), read_only=read_only)
            self.mount_count += 1

    def unmount(self, pod_uid: str, volume_name: str) -> None:
        with self._lock:
            if self._table.pop((pod_uid, volume_name), None) is not None:
                self.unmount_count += 1

    def get(self, pod_uid: str, volume_name: str):
        with self._lock:
            return self._table.get((pod_uid, volume_name))

    def list(self) -> List[MountPoint]:
        with self._lock:
            return list(self._table.values())

    def pod_mounts(self, pod_uid: str) -> List[MountPoint]:
        with self._lock:
            return [m for (uid, _), m in self._table.items()
                    if uid == pod_uid]
