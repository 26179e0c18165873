"""Job: run pods to completion.

A copy of kubernetes_tpu/controllers/job.py; its relative imports
resolve in this package.

Reference: pkg/controller/job/job_controller.go (syncJob:436 —
active/succeeded/failed accounting, parallelism-bounded pod creation,
backoffLimit failure condition, Complete condition when succeeded >=
completions).
"""

from __future__ import annotations

import itertools

from ..api import types as api
from ..runtime.store import Conflict
from .base import Controller, make_pod_from_template

_suffix = itertools.count(1)


class JobController(Controller):
    name = "job"

    def __init__(self, store, clock=None):
        super().__init__(store)
        import time
        self.clock = clock or time.time
        self.informer("jobs")
        self.informer("pods",
                      on_add=self._pod_event,
                      on_update=lambda o, n: self._pod_event(n),
                      on_delete=self._pod_event)

    def _pod_event(self, pod):
        for ref in pod.metadata.owner_references:
            if ref.controller and ref.kind == "Job":
                self.queue.add(f"{pod.metadata.namespace}/{ref.name}")

    def sync(self, key: str):
        ns, name = key.split("/", 1)
        job = self.store.get("jobs", ns, name)
        if job is None:
            return
        if any(c[0] in ("Complete", "Failed") and str(c[1]).startswith("True")
               for c in job.status.conditions):
            return  # terminal
        owned = [p for p in self.store.list("pods", ns)
                 if any(r.controller and r.kind == "Job" and r.name == name
                        for r in p.metadata.owner_references)]
        active = [p for p in owned if p.status.phase in
                  ("", "Pending", "Running")
                  and p.metadata.deletion_timestamp is None]
        succeeded = sum(1 for p in owned if p.status.phase == "Succeeded")
        failed = sum(1 for p in owned if p.status.phase == "Failed")
        st = job.status
        changed = (st.active, st.succeeded, st.failed) != \
            (len(active), succeeded, failed)
        st.active, st.succeeded, st.failed = len(active), succeeded, failed
        if st.start_time is None:
            st.start_time = self.clock()
            changed = True
        # job_controller.go pastActiveDeadline: a wall-clock bound on
        # the whole job, failure reason DeadlineExceeded
        if job.spec.active_deadline_seconds is not None:
            remaining = (st.start_time + job.spec.active_deadline_seconds
                         - self.clock())
            if remaining <= 0:
                st.conditions = [("Failed", "True:DeadlineExceeded")]
                for p in active:
                    self._delete(p)
                st.active = 0
                self._update(job)
                return
            # re-enqueue at the deadline (job_controller.go AddAfter):
            # nothing else wakes the sync when the clock runs out
            self.queue.add_after(key, remaining)
        if failed > job.spec.backoff_limit:
            st.conditions = [("Failed", "True:BackoffLimitExceeded")]
            for p in active:
                self._delete(p)
            st.active = 0
            self._update(job)
            return
        if succeeded >= job.spec.completions:
            st.conditions = [("Complete", "True")]
            st.completion_time = self.clock()
            for p in active:
                self._delete(p)
            st.active = 0
            self._update(job)
            return
        # create up to parallelism, bounded by remaining completions
        remaining = job.spec.completions - succeeded
        want_active = min(job.spec.parallelism, remaining)
        for _ in range(want_active - len(active)):
            pod = make_pod_from_template(job.spec.template, "Job", job,
                                         f"{name}-{next(_suffix):05d}")
            pod.spec.restart_policy = "Never"
            try:
                self.store.create("pods", pod)
                st.active += 1
                changed = True
            except Conflict:
                pass
        for p in active[want_active:] if want_active < len(active) else []:
            self._delete(p)
        if changed:
            self._update(job)

    def _delete(self, pod):
        try:
            self.store.delete("pods", pod.metadata.namespace, pod.metadata.name)
        except KeyError:
            pass

    def _update(self, job):
        try:
            self.store.update("jobs", job)
        except (Conflict, KeyError):
            pass
