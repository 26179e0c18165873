"""Image manager, image GC, and container GC.

A copy of kubernetes_tpu/kubelet/images.py; its relative imports
resolve in this package.

Reference: pkg/kubelet/images/image_manager.go (EnsureImageExists with
pull-policy handling), image_gc_manager.go (high/low disk thresholds,
delete least-recently-used unused images), and
pkg/kubelet/container/container_gc.go via kuberuntime_gc.go (evictable
dead containers: min age, per-pod max, node-wide max).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..api import types as api
from .runtime import EXITED

PULL_ALWAYS = "Always"
PULL_IF_NOT_PRESENT = "IfNotPresent"
PULL_NEVER = "Never"

DEFAULT_IMAGE_SIZE = 100 << 20  # fake registry: 100Mi per image


class ImageStore:
    """Per-node image cache with sizes and last-used stamps — the state
    both the puller and the GC manager operate on."""

    def __init__(self, disk_capacity: int = 10 << 30):
        self._lock = threading.Lock()
        self.images: Dict[str, dict] = {}  # name -> {size, last_used, pulled_at}
        self.disk_capacity = disk_capacity
        # recorded pull sequence (test probe) — bounded so a
        # crash-looping Always-pull container can't grow it forever
        from collections import deque
        self.pulls = deque(maxlen=1000)

    def snapshot(self) -> List[Tuple[str, dict]]:
        """Consistent (name, record) view for the GC scan."""
        with self._lock:
            return [(n, dict(r)) for n, r in self.images.items()]

    def has(self, image: str) -> bool:
        with self._lock:
            return image in self.images

    def pull(self, image: str, now: float, size: Optional[int] = None):
        with self._lock:
            self.pulls.append(image)
            rec = self.images.get(image)
            if rec is None:
                self.images[image] = {"size": size or DEFAULT_IMAGE_SIZE,
                                      "last_used": now, "pulled_at": now}
            else:
                rec["last_used"] = now

    def touch(self, image: str, now: float):
        with self._lock:
            if image in self.images:
                self.images[image]["last_used"] = now

    def remove(self, image: str) -> int:
        with self._lock:
            rec = self.images.pop(image, None)
            return rec["size"] if rec else 0

    def disk_used(self) -> int:
        with self._lock:
            return sum(r["size"] for r in self.images.values())


class ImageManager:
    """EnsureImageExists (image_manager.go:59): apply the container's
    imagePullPolicy against the node's image store."""

    def __init__(self, store: ImageStore):
        self.store = store

    def ensure_image_exists(self, container: api.Container,
                            now: float) -> Tuple[bool, str]:
        image = container.image or ""
        policy = getattr(container, "image_pull_policy", "") or \
            self._default_policy(image)
        present = self.store.has(image)
        if policy == PULL_NEVER:
            if not present:
                return False, f"Container image {image!r} is not present " \
                              f"with pull policy of Never"
            self.store.touch(image, now)
            return True, ""
        if policy == PULL_IF_NOT_PRESENT and present:
            self.store.touch(image, now)
            return True, ""
        self.store.pull(image, now)
        return True, ""

    @staticmethod
    def _default_policy(image: str) -> str:
        # apis/core/v1/defaults.go: :latest (or untagged) -> Always
        tag = image.rsplit(":", 1)[1] if ":" in image.rsplit("/", 1)[-1] \
            else "latest"
        return PULL_ALWAYS if tag == "latest" else PULL_IF_NOT_PRESENT


class ImageGCManager:
    """image_gc_manager.go: when disk usage crosses the high threshold,
    delete unused images oldest-last-used first until usage is below the
    low threshold. Images referenced by any container are never
    deleted."""

    def __init__(self, store: ImageStore, runtime,
                 high_threshold_percent: int = 85,
                 low_threshold_percent: int = 80):
        self.store = store
        self.runtime = runtime
        self.high = high_threshold_percent
        self.low = low_threshold_percent

    def _in_use(self) -> set:
        return {st.image for _k, st in self.runtime.snapshot_containers()
                if st.image}

    def garbage_collect(self) -> List[str]:
        cap = self.store.disk_capacity
        used = self.store.disk_used()
        if used * 100 < self.high * cap:
            return []
        target = self.low * cap // 100
        amount_to_free = used - target
        in_use = self._in_use()
        candidates = sorted(
            ((name, rec) for name, rec in self.store.snapshot()
             if name not in in_use),
            key=lambda kv: kv[1]["last_used"])
        deleted = []
        freed = 0
        for name, _rec in candidates:
            if freed >= amount_to_free:
                break
            freed += self.store.remove(name)
            deleted.append(name)
        return deleted


@dataclass
class ContainerGCPolicy:
    """container_gc.go GCPolicy: defaults match the reference kubelet
    flags (minimum-container-ttl-duration=0, maximum-dead-containers-
    per-container=1, maximum-dead-containers=-1)."""

    min_age: float = 0.0
    max_per_pod_container: int = 1
    max_containers: int = -1


class ContainerGC:
    """kuberuntime_gc.go evictContainers: dead containers older than
    minAge are evictable; keep at most maxPerPodContainer per (pod,
    container-name) and maxContainers node-wide, evicting oldest
    first."""

    def __init__(self, runtime, policy: Optional[ContainerGCPolicy] = None):
        self.runtime = runtime
        self.policy = policy or ContainerGCPolicy()

    def garbage_collect(self, now: float) -> List[Tuple[str, str]]:
        dead: Dict[Tuple[str, str], List[Tuple[float, Tuple[str, str]]]] = {}
        for key, st in self.runtime.snapshot_containers():
            if st.state != EXITED:
                continue
            finished = st.finished_at or 0.0
            if now - finished < self.policy.min_age:
                continue
            dead.setdefault(key, []).append((finished, key))
        # evictable units are (pod_uid, container_name) generations; the
        # fake runtime keeps ONE record per key, so per-pod trimming
        # applies when max_per_pod_container == 0
        evicted: List[Tuple[str, str]] = []
        all_dead = sorted((v[0] for v in dead.values()))
        if self.policy.max_per_pod_container == 0:
            for _, key in all_dead:
                self.runtime.remove_container(*key)
                evicted.append(key)
            return evicted
        if self.policy.max_containers >= 0 and \
                len(all_dead) > self.policy.max_containers:
            excess = len(all_dead) - self.policy.max_containers
            for _, key in all_dead[:excess]:
                self.runtime.remove_container(*key)
                evicted.append(key)
        return evicted
