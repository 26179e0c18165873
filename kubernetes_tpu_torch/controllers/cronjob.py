"""CronJob: scheduled Job creation.

A copy of kubernetes_tpu/controllers/cronjob.py; its relative imports
resolve in this package.

Reference: pkg/controller/cronjob/cronjob_controller.go (syncOne:224 —
next-schedule computation, concurrencyPolicy Allow/Forbid/Replace,
active-job bookkeeping). Unlike most controllers this one polls (the
reference syncs all cronjobs every 10s, cronjob_controller.go:98); here
``tick(now)`` advances it, and run() wraps tick in a timer loop.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..api import types as api
from ..runtime.store import Conflict
from .base import Controller


def cron_matches(schedule: str, t: float) -> bool:
    """Does epoch-time t (minute resolution) match the 5-field cron spec?
    Supports '*', '*/n', 'a', 'a-b', and comma lists."""
    lt = time.gmtime(t)
    fields = schedule.split()
    if len(fields) != 5:
        return False
    vals = (lt.tm_min, lt.tm_hour, lt.tm_mday, lt.tm_mon, lt.tm_wday)
    # cron: 0=Sunday; python: 0=Monday
    vals = vals[:4] + ((lt.tm_wday + 1) % 7,)

    def field_ok(spec: str, v: int) -> bool:
        for part in spec.split(","):
            if part == "*":
                return True
            if part.startswith("*/"):
                if v % int(part[2:]) == 0:
                    return True
            elif "-" in part:
                lo, hi = part.split("-", 1)
                if int(lo) <= v <= int(hi):
                    return True
            elif part.isdigit() and int(part) == v:
                return True
        return False

    return all(field_ok(s, v) for s, v in zip(fields, vals))


class CronJobController(Controller):
    name = "cronjob"

    def __init__(self, store, clock=time.time):
        super().__init__(store)
        self.clock = clock
        self._timer: Optional[threading.Thread] = None

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        cj = self.store.get("cronjobs", ns, name)
        if cj is not None:
            self._sync_one(cj, self.clock())

    def tick(self, now: Optional[float] = None) -> int:
        """Sync every cronjob against `now`. Returns jobs started."""
        now = now if now is not None else self.clock()
        started = 0
        for cj in self.store.list("cronjobs"):
            started += self._sync_one(cj, now)
        return started

    def _sync_one(self, cj: api.CronJob, now: float) -> int:
        # refresh active list from live jobs
        ns = cj.metadata.namespace
        active = []
        for jname in cj.status.active:
            job = self.store.get("jobs", ns, jname)
            if job is not None and not any(
                    c[0] in ("Complete", "Failed") and str(c[1]).startswith("True")
                    for c in job.status.conditions):
                active.append(jname)
        if active != cj.status.active:
            cj.status.active = active
            self._update(cj)
        if cj.spec.suspend:
            return 0
        minute = int(now // 60) * 60
        if cj.status.last_schedule_time is not None and \
                cj.status.last_schedule_time >= minute:
            return 0
        if not cron_matches(cj.spec.schedule, minute):
            return 0
        if active:
            if cj.spec.concurrency_policy == "Forbid":
                return 0
            if cj.spec.concurrency_policy == "Replace":
                for jname in active:
                    try:
                        self.store.delete("jobs", ns, jname)
                    except KeyError:
                        pass
                active = []
        job = api.Job(
            metadata=api.ObjectMeta(
                name=f"{cj.metadata.name}-{int(minute // 60)}",
                namespace=ns,
                labels=dict(cj.spec.job_template_meta.labels or {}),
                owner_references=[api.OwnerReference(
                    kind="CronJob", name=cj.metadata.name,
                    uid=cj.metadata.uid, controller=True)]),
            spec=cj.spec.job_template or api.JobSpec())
        try:
            self.store.create("jobs", job)
        except Conflict:
            return 0
        cj.status.active = active + [job.metadata.name]
        cj.status.last_schedule_time = minute
        self._update(cj)
        return 1

    def _update(self, cj):
        try:
            self.store.update("cronjobs", cj)
        except (Conflict, KeyError):
            pass

    def run(self, workers: int = 1, period: float = 10.0):
        def loop():
            while not self._stop.is_set():
                self.tick()
                self._stop.wait(period)

        self._timer = threading.Thread(target=loop, daemon=True,
                                       name="cronjob-tick")
        self._timer.start()
