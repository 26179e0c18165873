"""Container runtime interface + fake implementation.

A copy of kubernetes_tpu/kubelet/runtime.py; its relative imports
resolve in this package.

Reference: the CRI boundary (pkg/kubelet/kuberuntime/ over remote gRPC)
and its hollow stand-in (kubemark's fake docker client,
pkg/kubemark/hollow_kubelet.go:50). The fake runtime is deterministic
and injectable: tests and the kubemark-style load harness flip container
health or crash containers to exercise the kubelet's restart and probe
machinery.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

RUNNING = "running"
EXITED = "exited"
WAITING = "waiting"


@dataclass
class ContainerState:
    name: str
    state: str = WAITING
    exit_code: int = 0
    restart_count: int = 0
    healthy: bool = True  # liveness handler result
    ready: bool = True    # readiness handler result
    logs: List[str] = field(default_factory=list)  # stdout/stderr record
    # the PREVIOUS instance's log stream, snapshotted at restart —
    # what `kubectl logs --previous` reads (kuberuntime keeps the
    # last terminated container's logs)
    previous_logs: List[str] = field(default_factory=list)
    # the container's "filesystem" and environment — what exec/cp
    # actually operate on (path -> contents)
    files: Dict[str, str] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    image: str = ""  # what the container runs — image GC's in-use set
    # exclusively pinned cpu ids (cpumanager static policy); empty =
    # shared pool. The "cpuset cgroup write" surface of the fake runtime
    cpuset: List[int] = field(default_factory=list)
    finished_at: Optional[float] = None  # when it last exited (if known)
    # measured usage — what cadvisor reads from cgroups in the reference
    # (pkg/kubelet/cadvisor); here a seam stamped by set_usage (hollow
    # nodes / tests simulate load with it)
    cpu_millicores: int = 0
    memory_bytes: int = 0


class FakeRuntime:
    """Per-node container runtime: containers keyed by (pod_uid, name)."""

    def __init__(self, start_latency: float = 0.0):
        self._lock = threading.Lock()
        self.containers: Dict[Tuple[str, str], ContainerState] = {}
        self.start_latency = start_latency  # simulated image pull/start time
        self._pending_start: Dict[Tuple[str, str], float] = {}
        # (pod_uid, name) -> command: run-to-completion containers
        # (inits) executed + exited on the tick after they start
        self._pending_exit: Dict[Tuple[str, str], List[str]] = {}
        # (pod_uid, port) -> (host, backend_port): pod TCP listeners
        self._pod_servers: Dict[Tuple[str, int], Tuple[str, int]] = {}

    # -- CRI-ish surface -------------------------------------------------------

    def start_container(self, pod_uid: str, name: str, now: float,
                        env: Optional[Dict[str, str]] = None,
                        run_to_completion: bool = False,
                        command: Optional[List[str]] = None,
                        image: str = ""):
        """run_to_completion (init containers): the container starts
        RUNNING, then on the NEXT tick executes its command through the
        exec interpreter and EXITS with its code (0 when commandless) —
        one observable Running->Exited transition per init, like a real
        short-lived container."""
        with self._lock:
            key = (pod_uid, name)
            st = self.containers.get(key)
            if st is None:
                st = ContainerState(name)
                self.containers[key] = st
            if env:
                st.env = dict(env)
            if image:
                st.image = image
            if st.state != RUNNING:
                if st.state == EXITED:
                    # restart: the dead instance's stream becomes the
                    # --previous view; the new instance starts fresh
                    st.previous_logs = list(st.logs)
                    st.logs = []
                if run_to_completion:
                    self._pending_exit[key] = list(command or [])
                if self.start_latency > 0:
                    self._pending_start.setdefault(key, now + self.start_latency)
                else:
                    st.state = RUNNING
                    st.logs.append(f"container {name} started")

    def tick(self, now: float) -> List[Tuple[str, str, str]]:
        """Advance pending starts; returns lifecycle events
        (pod_uid, container, event) — the PLEG relist source
        (pkg/kubelet/pleg/generic.go relist)."""
        events = []
        with self._lock:
            for key, when in list(self._pending_start.items()):
                if now >= when:
                    st = self.containers.get(key)
                    if st is not None and st.state != RUNNING:
                        st.state = RUNNING
                        st.logs.append(f"container {key[1]} started")
                        events.append((key[0], key[1], "ContainerStarted"))
                    self._pending_start.pop(key, None)
            exiting = [(k, cmd) for k, cmd in self._pending_exit.items()
                       if k not in self._pending_start
                       and (st := self.containers.get(k)) is not None
                       and st.state == RUNNING]
        for key, cmd in exiting:
            st = self.containers[key]
            rc, out = (self._interpret(st, key[0], cmd, None) if cmd
                       else (0, ""))
            with self._lock:
                if out:
                    st.logs.append(out)
                st.state = EXITED
                st.exit_code = rc
                st.finished_at = now
                self._pending_exit.pop(key, None)
            events.append((key[0], key[1], "ContainerDied"))
        return events

    def kill_pod(self, pod_uid: str):
        with self._lock:
            for key in [k for k in self.containers if k[0] == pod_uid]:
                self.containers.pop(key, None)
                self._pending_start.pop(key, None)
                self._pending_exit.pop(key, None)

    def snapshot(self):
        """Consistent {(pod_uid, name): (state, restart_count)} view —
        the PLEG relist source (keeps the locking in here)."""
        with self._lock:
            return {k: (cs.state, cs.restart_count)
                    for k, cs in self.containers.items()}

    def get(self, pod_uid: str, name: str) -> Optional[ContainerState]:
        with self._lock:
            return self.containers.get((pod_uid, name))

    def pod_containers(self, pod_uid: str) -> List[ContainerState]:
        with self._lock:
            return [st for (uid, _), st in self.containers.items()
                    if uid == pod_uid]

    # -- logs + exec (the kubelet server's debug surface) ----------------------

    def append_log(self, pod_uid: str, name: str, line: str):
        """Record a stdout line (what a real runtime's log file collects)."""
        with self._lock:
            st = self.containers.get((pod_uid, name))
            if st is not None:
                st.logs.append(line)

    def container_logs(self, pod_uid: str, name: str,
                       tail: Optional[int] = None,
                       previous: bool = False) -> Optional[List[str]]:
        """The runtime's log records (CRI ContainerLog / docker logs
        analog); None if the container does not exist. previous=True
        reads the last terminated instance's stream (`kubectl logs
        --previous`)."""
        with self._lock:
            st = self.containers.get((pod_uid, name))
            if st is None:
                return None
            lines = list(st.previous_logs if previous else st.logs)
        if tail is None or tail < 0:
            return lines
        # explicit slice end: lines[-0:] would be the WHOLE list
        return lines[len(lines) - min(tail, len(lines)):]

    def exec_in_container(self, pod_uid: str, name: str, cmd: List[str],
                          stdin: Optional[str] = None) -> Tuple[int, str]:
        """Execute a command against the container's ACTUAL state — its
        files, env, and log stream — via a small shell-like interpreter
        (the reference streams a real exec over CRI, kuberuntime
        ExecSync; this is the hollow runtime's honest equivalent: the
        command's effects are observable through every other runtime
        surface). Non-running containers fail like a real exec would.
        stdin feeds `cat > path` / `tee path` — the upload half of
        `kubectl cp`."""
        with self._lock:
            st = self.containers.get((pod_uid, name))
            if st is None or st.state != RUNNING:
                return 126, f"container {name} is not running"
        rc, out = self._interpret(st, pod_uid, cmd, stdin)
        self.append_log(pod_uid, name, f"exec: {' '.join(cmd)} rc={rc}")
        return rc, out

    def _interpret(self, st: ContainerState, pod_uid: str,
                   cmd: List[str], stdin: Optional[str]) -> Tuple[int, str]:
        if not cmd:
            return 127, "no command"
        prog, args = cmd[0], cmd[1:]
        if prog == "sh" and len(args) >= 2 and args[0] == "-c":
            # one level of `sh -c "..."` with redirection into the
            # container fs: `cmd > path` / `cat > path`. Tokenize FIRST
            # so a quoted '>' is data, not redirection.
            import shlex

            try:
                tokens = shlex.split(args[1])
            except ValueError as e:
                return 2, f"sh: syntax error: {e}"
            if ">" in tokens:
                i = len(tokens) - 1 - tokens[::-1].index(">")
                inner, rest = tokens[:i], tokens[i + 1:]
                if len(rest) != 1:
                    return 2, "sh: syntax error near '>'"
                target = rest[0]
                if inner == ["cat"] or not inner:
                    content = stdin or ""
                    rc = 0
                else:
                    rc, content = self._interpret(st, pod_uid, inner, stdin)
                if rc == 0:
                    with self._lock:
                        st.files[target] = content
                    return 0, ""
                return rc, content
            return self._interpret(st, pod_uid, tokens, stdin)
        if prog == "echo":
            return 0, " ".join(args)
        if prog == "hostname":
            return 0, pod_uid
        if prog == "env":
            with self._lock:
                env = dict(st.env)
            return 0, "\n".join(f"{k}={v}" for k, v in sorted(env.items()))
        if prog == "cat":
            if not args:
                return 0, stdin or ""
            with self._lock:
                missing = [a for a in args if a not in st.files]
                if missing:
                    return 1, f"cat: {missing[0]}: No such file or directory"
                return 0, "".join(st.files[a] for a in args)
        if prog == "ls":
            prefix = (args[0].rstrip("/") + "/") if args else "/"
            with self._lock:
                if args and args[0] in st.files:
                    return 0, args[0]  # ls of a file echoes its path
                names = sorted({f[len(prefix):].split("/")[0]
                                for f in st.files
                                if f.startswith(prefix)})
            if not names and args:
                return 1, f"ls: {args[0]}: No such file or directory"
            return 0, "\n".join(names)
        if prog == "rm":
            with self._lock:
                for a in args:
                    if a not in st.files:
                        return 1, f"rm: {a}: No such file or directory"
                for a in args:
                    st.files.pop(a)
            return 0, ""
        if prog == "tee":
            content = stdin or ""
            if args:
                with self._lock:
                    st.files[args[0]] = content
            return 0, content
        if prog in ("true", "sleep"):
            return 0, ""
        if prog == "false":
            return 1, ""
        return 127, f"sh: {prog}: command not found"

    # -- pod TCP backends (port-forward's other end) ---------------------------

    def register_pod_server(self, pod_uid: str, port: int,
                            backend_port: int, host: str = "127.0.0.1"):
        """Declare that the pod listens on `port`, backed by a real local
        TCP server at (host, backend_port) — the hollow analog of a
        container process binding a port. kubelet portForward pipes
        bytes here."""
        with self._lock:
            self._pod_servers[(pod_uid, port)] = (host, backend_port)

    def pod_server(self, pod_uid: str, port: int):
        with self._lock:
            return self._pod_servers.get((pod_uid, port))

    # -- stats (the cadvisor seam) ---------------------------------------------

    def set_usage(self, pod_uid: str, name: str, cpu_millicores: int,
                  memory_bytes: int):
        """Stamp measured usage for a container — the hollow analog of
        cgroup accounting (reference pkg/kubelet/cadvisor reads real
        cgroups; kubemark's hollow kubelet returns canned stats)."""
        with self._lock:
            st = self.containers.get((pod_uid, name))
            if st is not None:
                st.cpu_millicores = int(cpu_millicores)
                st.memory_bytes = int(memory_bytes)

    def snapshot_containers(self) -> List[Tuple[Tuple[str, str],
                                                "ContainerState"]]:
        """Consistent (key, state) snapshot for GC scans — pod workers
        mutate the dict concurrently in background mode."""
        with self._lock:
            return list(self.containers.items())

    def remove_container(self, pod_uid: str, name: str):
        """Delete a (dead) container record — the ContainerGC eviction
        primitive (kuberuntime_gc.go removeContainer)."""
        with self._lock:
            self.containers.pop((pod_uid, name), None)
            self._pending_start.pop((pod_uid, name), None)
            self._pending_exit.pop((pod_uid, name), None)

    def container_stats(self, pod_uid: str) -> List["ContainerState"]:
        """RUNNING containers of a pod, for the /stats/summary builder."""
        with self._lock:
            return [st for (uid, _), st in self.containers.items()
                    if uid == pod_uid and st.state == RUNNING]

    # -- fault injection (tests / chaos harness) -------------------------------

    def crash_container(self, pod_uid: str, name: str, exit_code: int = 1,
                        now: Optional[float] = None):
        with self._lock:
            st = self.containers.get((pod_uid, name))
            if st is not None:
                st.state = EXITED
                st.exit_code = exit_code
                st.finished_at = now  # crash-backoff forgiveness input
                st.logs.append(f"container {name} exited rc={exit_code}")

    def set_healthy(self, pod_uid: str, name: str, healthy: bool):
        with self._lock:
            st = self.containers.get((pod_uid, name))
            if st is not None:
                st.healthy = healthy

    def set_ready(self, pod_uid: str, name: str, ready: bool):
        with self._lock:
            st = self.containers.get((pod_uid, name))
            if st is not None:
                st.ready = ready
