"""Lock-order race detection for tests.

A copy of kubernetes_tpu/utils/racecheck.py; its relative imports resolve in this
package.

Analog of the reference's `go test -race` reliance (SURVEY.md §5: race
detection is part of its test infrastructure). CPython can't have the
compiler instrument memory accesses, but the framework's shared state is
all lock-guarded — so the practical analog is a lock-ORDER watcher: wrap
the component locks, record the acquisition graph across threads, and
flag inversions (lock pairs taken in both orders), which are exactly the
latent deadlocks a data-race detector's happens-before analysis would
surface here. Used by tests/test_racecheck.py to run the
scheduler/store/kubelet concurrently under instrumentation.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple


class LockOrderWatcher:
    def __init__(self):
        self._mu = threading.Lock()
        self._held = threading.local()
        # directed edges name_a -> name_b: b was acquired while a held
        self.edges: Set[Tuple[str, str]] = set()
        self.violations: List[str] = []
        self._names: Dict[int, str] = {}

    def _stack(self) -> List[str]:
        if not hasattr(self._held, "stack"):
            self._held.stack = []
        return self._held.stack

    def wrap(self, name: str, lock):
        """Instrument a Lock/RLock-like object; returns a proxy with the
        same acquire/release/context-manager surface."""
        watcher = self

        class _Proxy:
            def acquire(self, *a, **kw):
                ok = lock.acquire(*a, **kw)
                if ok:
                    watcher._on_acquire(name)
                return ok

            def release(self):
                watcher._on_release(name)
                lock.release()

            def __enter__(self):
                self.acquire()
                return self

            def __exit__(self, *exc):
                self.release()

            def __getattr__(self, item):
                # Condition objects (wait/notify/notify_all) and any other
                # lock-like surface pass through to the real object
                return getattr(lock, item)

        return _Proxy()

    def _on_acquire(self, name: str):
        stack = self._stack()
        if name in stack:
            # re-entrant acquisition can't block: record no edges at all
            # (an a->r edge here would pair with the earlier r->a and
            # report a false inversion for `with r: with a: with r:`)
            stack.append(name)
            return
        with self._mu:
            for held in stack:
                edge = (held, name)
                if (name, held) in self.edges and edge not in self.edges:
                    self.violations.append(
                        f"lock-order inversion: {held!r} -> {name!r} here, "
                        f"{name!r} -> {held!r} elsewhere (potential "
                        f"deadlock)")
                self.edges.add(edge)
        stack.append(name)

    def _on_release(self, name: str):
        stack = self._stack()
        if name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()

    def assert_clean(self):
        if self.violations:
            raise AssertionError("; ".join(self.violations))


def instrument(watcher: LockOrderWatcher, obj, attr: str, name: str):
    """Replace obj.<attr> (a lock) with a watched proxy.

    Must run BEFORE any concurrency touches the object: a thread that
    captured the original lock object would not contend with threads
    acquiring the proxy, silently breaking mutual exclusion."""
    setattr(obj, attr, watcher.wrap(name, getattr(obj, attr)))
