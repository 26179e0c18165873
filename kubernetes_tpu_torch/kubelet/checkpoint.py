"""Kubelet checkpointing: device and CPU assignments survive restarts.

A copy of kubernetes_tpu/kubelet/checkpoint.py; its relative imports
resolve in this package.

Reference: pkg/kubelet/checkpointmanager (checksummed JSON files under
the kubelet root), used by the device manager
(cm/devicemanager/manager.go kubelet_internal_checkpoint) and the CPU
manager (cm/cpumanager/state/state_checkpoint.go). A kubelet that
restarts must come back with the SAME device IDs and CPU pins for
running pods — re-allocating would hand a live workload's accelerator
to someone else.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional


class CorruptCheckpoint(Exception):
    pass


class CheckpointManager:
    """Checksummed JSON state files, written atomically (tmp + rename,
    like checkpointmanager's safe-file write)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, state: dict):
        payload = json.dumps(state, sort_keys=True)
        doc = {"data": payload,
               "checksum": hashlib.sha256(payload.encode()).hexdigest()}
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".{name}-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self._path(name))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load(self, name: str) -> Optional[dict]:
        """None when absent; CorruptCheckpoint when the checksum fails
        (the reference surfaces this so the caller can decide to start
        fresh rather than trust bad state)."""
        try:
            with open(self._path(name)) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError):
            raise CorruptCheckpoint(name)
        payload = doc.get("data", "")
        if hashlib.sha256(payload.encode()).hexdigest() != \
                doc.get("checksum"):
            raise CorruptCheckpoint(name)
        return json.loads(payload)

    def remove(self, name: str):
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass
