"""kube-scheduler binary of the port.

A port of kubernetes_tpu/cli/kube_scheduler.py, itself the analog of
cmd/kube-scheduler/app/server.go: flags + component config -> build the
scheduler against an apiserver, optionally behind leader election, with
healthz + /metrics served on the insecure port (server.go:225-236) and
the scheduling loop as the leader's run function (server.go:188-203).

Run: python -m kubernetes_tpu_torch.cli.kube_scheduler --server http://...
[--config cfg.json] [--once]

The scheduler runs on the CUDA card: `build_scheduler`, `run` and `main`
take `device=None` (the card; without one they raise, through
ops/encoding.py resolve_device) and tests pass device="cpu"; no flag
selects the device. Differences from the JAX binary, none of them a
flag:

  * `--mesh-devices` above 1 raises NotImplementedError (the mesh is not
    ported: ROADMAP.md queue 1 item 3); 0, 1 and -1 mean the one card,
    as the JAX resolution does on one device. `--invariants` builds a
    checked scheduler (a strict chaos/invariants.py checker after every
    round), as in JAX;
  * under `--leader-elect` the scheduling loop runs in a thread of its
    own, which takes over the calling thread's torch modes (inference
    mode, current CUDA device and stream: both are per thread in torch);
  * an exception in that thread stops the process's wait and re-raises
    from `run`, where the JAX binary's main thread would wait on; the
    health server and the reflectors are stopped on every exit.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..client import LeaderElector, RESTClient, RemoteStore
from ..plugins.registry import default_profile, default_registry
from ..sched.config import KubeSchedulerConfiguration
from ..sched.scheduler import Scheduler
from ..utils.feature_gates import FeatureGates
from ..utils.metrics import Metrics
from ..utils.watchdog import _run_with_state, _thread_state


class HealthServer:
    """healthz + /metrics on the insecure port (server.go:225)."""

    def __init__(self, scheduler_ref, host="127.0.0.1", port=0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/healthz":
                    body = b"ok"
                    ctype = "text/plain"
                elif self.path == "/metrics":
                    body = outer.metrics_text().encode()
                    ctype = "text/plain"
                elif self.path.startswith("/debug/profile"):
                    # pprof debug=1 analog (server.go:229 EnableProfiling)
                    from ..utils import profiling

                    prof = profiling.active()
                    body = (prof.report() if prof is not None
                            else "profiling disabled (run with "
                                 "--profiling)\n").encode()
                    ctype = "text/plain"
                elif self.path.startswith("/debug/trace"):
                    # flight recorder export: Chrome trace-event JSON
                    # (Perfetto-loadable) by default; ?format=text for
                    # the plain timeline, ?format=ledger for the round
                    # ledger records the JSONL file would hold
                    from ..utils import tracing

                    rec = tracing.active()
                    if rec is None:
                        body = (b"tracing disabled (run with --tracing)\n")
                        ctype = "text/plain"
                    elif "format=text" in self.path:
                        body = rec.text_timeline().encode()
                        ctype = "text/plain"
                    elif "format=ledger" in self.path:
                        body = ("\n".join(json.dumps(r)
                                          for r in rec.ledger_rows())
                                + "\n").encode()
                        ctype = "application/json"
                    else:
                        body = json.dumps(rec.chrome_trace()).encode()
                        ctype = "application/json"
                elif self.path.startswith("/debug/shadow"):
                    # shadow-scoring observatory: counterfactual
                    # divergence per candidate WeightProfile.
                    # ?profile=<name> for one profile's report
                    # (&format=text for flip explanations: "p1: prod
                    # chose node-42, candidate flips to node-7 on
                    # LeastRequested 8→3"); without a profile, an index
                    # of loaded profiles + the active weights_version.
                    from urllib.parse import parse_qs, urlparse

                    sched = outer.scheduler_ref()
                    book = getattr(sched, "weightbook", None)
                    if book is None:
                        body = b"scheduler not running\n"
                        ctype = "text/plain"
                    else:
                        q = parse_qs(urlparse(self.path).query)
                        profile = (q.get("profile") or [None])[0]
                        fmt = (q.get("format") or [""])[0]
                        if profile:
                            if fmt == "text":
                                text = book.report_text(profile)
                            else:
                                entry = book.report(profile)
                                text = (json.dumps(entry)
                                        if entry is not None else None)
                            if text is None:
                                body = (f"no shadow profile "
                                        f"{profile}\n").encode()
                                self.send_response(404)
                                self.send_header("Content-Type",
                                                 "text/plain")
                                self.send_header("Content-Length",
                                                 str(len(body)))
                                self.end_headers()
                                self.wfile.write(body)
                                return
                            body = text.encode()
                            ctype = ("text/plain" if fmt == "text"
                                     else "application/json")
                        else:
                            body = json.dumps(book.index()).encode()
                            ctype = "application/json"
                elif self.path.startswith("/debug/store"):
                    # control-plane outage observatory: store-path
                    # breaker state, bind-spool depth/watermark,
                    # journal stats and per-op store error counters
                    # (sched/scheduler.py store_debug())
                    sched = outer.scheduler_ref()
                    dbg = getattr(sched, "store_debug", None)
                    if dbg is None:
                        body = b"scheduler not running\n"
                        self.send_response(404)
                        self.send_header("Content-Type", "text/plain")
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    body = json.dumps(dbg()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/autopilot"):
                    # autopilot promotion pipeline: current phase,
                    # candidate under evaluation, gate reports and the
                    # bounded transition history
                    # (autopilot/controller.py status())
                    sched = outer.scheduler_ref()
                    ap = getattr(sched, "autopilot", None)
                    if ap is None:
                        body = b"no autopilot controller attached\n"
                        self.send_response(404)
                        self.send_header("Content-Type", "text/plain")
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    body = json.dumps(ap.status()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/score"):
                    # decision observatory: per-pod score decomposition
                    # ("why did node-42 win"). ?uid=<pod uid> for one
                    # pod (&format=text for the one-line explanation);
                    # without a uid, an index of recent decisions.
                    from urllib.parse import parse_qs, urlparse

                    from ..utils import tracing

                    rec = tracing.active()
                    if rec is None:
                        body = (b"tracing disabled (run with --tracing)\n")
                        ctype = "text/plain"
                    else:
                        q = parse_qs(urlparse(self.path).query)
                        uid = (q.get("uid") or [None])[0]
                        fmt = (q.get("format") or [""])[0]
                        if uid:
                            entry = rec.decision(uid)
                            if entry is None:
                                body = (f"no decision recorded for uid "
                                        f"{uid}\n").encode()
                                self.send_response(404)
                                self.send_header("Content-Type",
                                                 "text/plain")
                                self.send_header("Content-Length",
                                                 str(len(body)))
                                self.end_headers()
                                self.wfile.write(body)
                                return
                            if fmt == "text":
                                body = (tracing.format_decision(uid, entry)
                                        + "\n").encode()
                                ctype = "text/plain"
                            else:
                                body = json.dumps(
                                    {"uid": uid, **entry}).encode()
                                ctype = "application/json"
                        else:
                            idx = [{"uid": u, "pod": e.get("pod"),
                                    "node": e.get("node"),
                                    "round": e.get("round"),
                                    "total": e.get("total"),
                                    "margin": e.get("margin")}
                                   for u, e in rec.recent_decisions()]
                            body = json.dumps(idx).encode()
                            ctype = "application/json"
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.scheduler_ref = scheduler_ref
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True,
                         name="sched-healthz").start()

    def metrics_text(self) -> str:
        sched = self.scheduler_ref()
        if sched is None:
            return ""
        lines = []
        typed = set()
        for series in sched.metrics.all_series().values():
            if hasattr(series, "counts"):  # histogram
                # full Prometheus histogram exposition: CUMULATIVE
                # name_bucket{le="..."} lines ending at +Inf == _count —
                # without the buckets, dashboards cannot compute
                # histogram_quantile() and the old output failed strict
                # text-format parsers
                lines.append(f"# TYPE {series.name} histogram")
                cum = 0
                for bound, c in zip(series.buckets, series.counts):
                    cum += c
                    lines.append(
                        f'{series.name}_bucket{{le="{bound:g}"}} {cum}')
                cum += series.counts[-1]
                lines.append(f'{series.name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{series.name}_sum {series.sum}")
                lines.append(f"{series.name}_count {series.total}")
            else:
                # labelled children share one family: the TYPE line must
                # name the bare family (label syntax there fails the
                # Prometheus text parser, discarding the whole scrape)
                family = series.name.partition("{")[0]
                if family not in typed:
                    typed.add(family)
                    kind = getattr(series, "kind", "counter")
                    lines.append(f"# TYPE {family} {kind}")
                lines.append(f"{series.name} {series.value}")
        return "\n".join(lines) + "\n"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def build_scheduler(cfg: KubeSchedulerConfiguration, store,
                    metrics: Optional[Metrics] = None, *,
                    device=None) -> Scheduler:
    if cfg.policy_config_file:
        profile = default_registry.profile_from_policy(
            open(cfg.policy_config_file).read(), store=store)
    else:
        profile = default_profile(store)
    profile.scheduler_name = cfg.scheduler_name
    profile.disable_preemption = cfg.disable_preemption
    profile.hard_pod_affinity_symmetric_weight = \
        cfg.hard_pod_affinity_symmetric_weight
    features = FeatureGates()
    for k, v in (cfg.feature_gates or {}).items():
        features.set(k, bool(v))
    if cfg.mesh_devices > 1:
        # 0 = one device, -1 = every visible device: the one card the
        # port runs on (the JAX resolution gives no mesh for one device)
        raise NotImplementedError(
            f"mesh_devices={cfg.mesh_devices}: a mesh of more than one "
            "device is not ported yet (ROADMAP.md queue 1 item 3)")
    sched = Scheduler(store, profile=profile, wave_size=cfg.wave_size,
                      features=features, device=device,
                      mesh_min_devices=cfg.mesh_min_devices,
                      scrub_interval=cfg.scrub_interval or None,
                      compact_interval=cfg.compact_interval or None,
                      hbm_budget_bytes=cfg.hbm_budget_bytes,
                      breaker_threshold=cfg.breaker_threshold,
                      breaker_cooldown=cfg.breaker_cooldown,
                      metrics=metrics,
                      bind_max_attempts=cfg.bind_max_attempts,
                      racecheck=cfg.racecheck,
                      shed_watermark=cfg.shed_watermark,
                      shed_priority_threshold=cfg.shed_priority_threshold,
                      shed_age_s=cfg.shed_age_s,
                      wave_deadline_s=cfg.wave_deadline_s,
                      shadow_exact_interval=cfg.shadow_exact_interval,
                      invariants=cfg.invariants,
                      store_breaker_threshold=cfg.store_breaker_threshold,
                      store_breaker_cooldown=cfg.store_breaker_cooldown,
                      bind_journal_path=cfg.bind_journal_path or None,
                      bind_journal_max_bytes=cfg.bind_journal_max_bytes,
                      spool_watermark=cfg.spool_watermark)
    if cfg.weight_profiles_path:
        # file-preloaded profiles feed the weight book directly — the
        # store-watched `weightprofiles` kind is the dynamic path, but
        # a remote apiserver may not carry it
        sched.weightbook.load_file(cfg.weight_profiles_path)
    return sched


def run(cfg: KubeSchedulerConfiguration, server_url: str,
        token: Optional[str] = None, stop: Optional[threading.Event] = None,
        once: bool = False, ca_cert_pem: Optional[str] = None,
        client_cert_pem: Optional[str] = None,
        client_key_pem: Optional[str] = None,
        profiling_enabled: bool = False,
        contention_profiling: bool = False,
        tracing_enabled: bool = False, *, device=None) -> int:
    stop = stop or threading.Event()
    prof_on = profiling_enabled or contention_profiling
    if prof_on:
        from ..utils import profiling

        profiling.enable()
    # a ledger path implies tracing (the recorder is what writes it);
    # only tear down a recorder THIS call created — an embedding caller
    # may have enabled tracing for its own purposes
    trace_on = tracing_enabled or cfg.tracing or bool(cfg.round_ledger_path)
    trace_owned = False
    if trace_on:
        from ..utils import tracing

        trace_owned = tracing.active() is None
        tracing.enable(max_rounds=cfg.trace_rounds,
                       ledger_path=cfg.round_ledger_path or None,
                       ledger_max_bytes=(cfg.round_ledger_max_bytes
                                         if cfg.round_ledger_max_bytes >= 0
                                         else None))
    try:
        return _run_inner(cfg, server_url, token, stop, once, ca_cert_pem,
                          client_cert_pem, client_key_pem,
                          contention_profiling, device)
    finally:
        # process-global instrumentation: never leak, even on error
        if prof_on:
            from ..utils import profiling

            profiling.disable()
        if trace_owned:
            from ..utils import tracing

            tracing.disable()


def _run_inner(cfg, server_url, token, stop, once, ca_cert_pem,
               client_cert_pem, client_key_pem, contention_profiling,
               device=None):
    client = RESTClient(server_url, token=token, ca_cert_pem=ca_cert_pem,
                        client_cert_pem=client_cert_pem,
                        client_key_pem=client_key_pem)
    # ONE metrics registry shared by the store's reflectors and the
    # scheduler: reflector_relists/watch_stale/stage=reflector errors
    # are served from the same /metrics endpoint as scheduling series
    metrics = Metrics()
    store = RemoteStore(client, metrics=metrics)
    for kind in ("pods", "nodes", "services", "replicationcontrollers",
                 "replicasets", "statefulsets", "poddisruptionbudgets",
                 "persistentvolumes", "persistentvolumeclaims"):
        store.mirror(kind)
    store.wait_for_sync()
    sched_holder = [None]
    health = HealthServer(lambda: sched_holder[0], port=cfg.healthz_port) \
        if cfg.healthz_port >= 0 else None
    # SIGUSR2 -> audit the HBM snapshot against the host cache
    # (factory/cache_comparer.go's trigger). Installed HERE, before any
    # leader election: under --leader-elect the scheduling loop runs in
    # a worker thread where signal.signal() is illegal — installing from
    # there would silently leave SIGUSR2 at its default disposition
    # (terminate) and an operator's audit kill -USR2 would kill the
    # leader. The handler routes through the holder so it survives the
    # scheduler being built later (or never, on a standby).
    if hasattr(signal, "SIGUSR2") and \
            threading.current_thread() is threading.main_thread():
        signal.signal(
            signal.SIGUSR2,
            lambda *_: (sched_holder[0] is not None
                        and sched_holder[0].scrubber.request()))

    # the calling thread's torch modes: the loop thread takes them over
    modes = _thread_state()
    loop_error = []
    loop_threads = []

    def scheduling_loop(elector: Optional[LeaderElector] = None):
        _run_with_state(lambda: _loop(elector), modes)

    def loop_thread(elector: LeaderElector):
        # an exception must not leave the process waiting, or exiting 0
        # with pods unbound: it stops the wait and re-raises from run()
        try:
            scheduling_loop(elector)
        except Exception as e:
            loop_error.append(e)
            stop.set()

    def _loop(elector: Optional[LeaderElector]):
        sched = build_scheduler(cfg, store, metrics=metrics, device=device)
        if contention_profiling:
            from ..utils import profiling

            profiling.instrument_lock(sched, "_mu", "scheduler._mu")
        sched_holder[0] = sched
        while not stop.is_set():
            if elector is not None and not elector.is_leader:
                # demoted: drain binds once, then idle warm (informers
                # keep the cache current for the recovery pass)
                if not sched.dormant:
                    sched.enter_dormant()
                stop.wait(0.05)
                continue
            if sched.dormant:
                # re-elected: reconcile assumed pods against API truth,
                # rebuild the HBM snapshot, resume waves
                sched.recover_leadership()
            placed = sched.run_once(timeout=0.2)
            if once and sched.queue.active_count() == 0:
                stop.set()
            if placed == 0 and not once:
                stop.wait(0.02)
        sched.close()  # settle in-flight binds + release binder threads

    if cfg.leader_election.leader_elect:
        le = cfg.leader_election
        loop_started = threading.Event()

        def _on_started_leading():
            # the loop thread is started ONCE and then survives
            # leadership churn — warm restart, not process restart. The
            # loop keys dormancy off elector.is_leader itself (caught
            # within one iteration): enter_dormant's bind drain can
            # block for seconds, and the elector thread must get back
            # to candidate mode immediately, not run it
            if not loop_started.is_set() and not stop.is_set():
                loop_started.set()
                t = threading.Thread(target=loop_thread, args=(elector,),
                                     daemon=True, name="sched-loop")
                loop_threads.append(t)
                t.start()

        elector = LeaderElector(
            store, identity=f"{cfg.scheduler_name}-{id(store):x}",
            lock_name=le.lock_name, lease_duration=le.lease_duration,
            renew_deadline=le.renew_deadline, retry_period=le.retry_period,
            on_started_leading=_on_started_leading)
    try:
        if cfg.leader_election.leader_elect:
            elector.start()
            stop.wait()
            elector.stop()
            # the loop sees the stop within one run_once and settles its
            # binds in close(): wait for it, so that a caller reading
            # the bindings after run() returns sees every one
            for t in loop_threads:
                t.join()
            if loop_error:
                raise loop_error[0]
        else:
            scheduling_loop()
    finally:
        if health is not None:
            health.stop()
        store.stop()
    return 0


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(prog="kube-scheduler")
    ap.add_argument("--server", required=True, help="apiserver URL")
    ap.add_argument("--token", default=None)
    ap.add_argument("--ca-cert-data", default=None,
                    help="cluster CA bundle PEM (or @file) for https "
                         "servers")
    ap.add_argument("--client-cert-data", default=None,
                    help="x509 client cert PEM (or @file) for mTLS")
    ap.add_argument("--client-key-data", default=None,
                    help="x509 client key PEM (or @file) for mTLS")
    ap.add_argument("--config", default=None,
                    help="KubeSchedulerConfiguration file (YAML/JSON)")
    ap.add_argument("--policy-config-file", default=None)
    ap.add_argument("--scheduler-name", default=None)
    ap.add_argument("--leader-elect", action="store_true")
    ap.add_argument("--disable-preemption", action="store_true")
    ap.add_argument("--wave-size", type=int, default=None)
    ap.add_argument("--mesh-devices", type=int, default=None,
                    help="shard the scheduling plane's node axis across "
                         "this many devices (0 = single device, -1 = all "
                         "visible devices); placements stay bit-identical")
    ap.add_argument("--mesh-min-devices", type=int, default=None,
                    help="degradation-ladder floor: a device loss reforms "
                         "the mesh down (8->4->2->1) while at least this "
                         "many devices survive; below it the whole-path "
                         "breaker takes over (host twin)")
    ap.add_argument("--scrub-interval", type=float, default=None,
                    help="seconds between periodic snapshot scrubs "
                         "(0 disables the cadence; SIGUSR2 always works)")
    ap.add_argument("--compact-interval", type=float, default=None,
                    help="seconds between housekeeping snapshot "
                         "compaction sweeps — shrink over-grown row "
                         "buckets and rebuild the shared vocabularies "
                         "from live objects (0 disables the cadence; "
                         "OOM recovery and the HBM governor can still "
                         "force one)")
    ap.add_argument("--hbm-budget-bytes", type=int, default=None,
                    help="projected device-memory budget in bytes: a "
                         "snapshot grow that would exceed it compacts "
                         "first instead of letting the backend throw "
                         "RESOURCE_EXHAUSTED (0 = unbudgeted)")
    ap.add_argument("--healthz-port", type=int, default=None,
                    help="-1 disables; 0 picks a free port")
    ap.add_argument("--feature-gates", default="",
                    help="comma-separated key=bool pairs")
    ap.add_argument("--profiling", action="store_true",
                    help="step profiling served at /debug/profile "
                         "(EnableProfiling analog)")
    ap.add_argument("--contention-profiling", action="store_true",
                    help="also record lock wait times "
                         "(EnableContentionProfiling analog)")
    ap.add_argument("--tracing", action="store_true",
                    help="flight recorder: per-pod span tracing served at "
                         "/debug/trace (Chrome trace-event JSON; "
                         "?format=text for a timeline)")
    ap.add_argument("--trace-rounds", type=int, default=None,
                    help="rounds retained in the flight-recorder ring "
                         "buffer (default 64)")
    ap.add_argument("--round-ledger", default=None,
                    help="append one structured JSONL record per "
                         "scheduling round to this file (requires "
                         "--tracing)")
    ap.add_argument("--round-ledger-max-bytes", type=int, default=None,
                    help="rotate the round ledger to <path>.1 before it "
                         "exceeds this many bytes (one generation kept; "
                         "0 disables rotation, default 64MiB)")
    ap.add_argument("--weight-profiles", default=None,
                    help="JSON file of WeightProfiles ([{name, weights, "
                         "role}]) preloaded into the shadow-scoring "
                         "observatory; role=live hot-swaps the "
                         "production weight vector, candidates are "
                         "shadow-scored on traced rounds "
                         "(/debug/shadow; needs --tracing)")
    ap.add_argument("--shadow-exact-interval", type=int, default=None,
                    help="exact shadow mode: replay the first wave of "
                         "every Nth traced round through the numpy twin "
                         "under each candidate profile (0 disables; the "
                         "default shadow pass is a top-K lower bound)")
    ap.add_argument("--invariants", action="store_true",
                    help="continuously-checked cluster invariants: run "
                         "the chaos invariant checker after every "
                         "scheduling round (conservation, double-bind, "
                         "capacity, snapshot-vs-residents, gang "
                         "atomicity, state-machine sanity); a violation "
                         "raises with a full state digest")
    ap.add_argument("--racecheck", action="store_true",
                    help="instrument the scheduler/queue locks with the "
                         "lock-order watcher (go test -race analog; "
                         "edge names match the ktpu-lint static lock "
                         "graph)")
    ap.add_argument("--shed-watermark", type=int, default=None,
                    help="overload control: pending-depth high watermark "
                         "above which sub-threshold-priority pods park in "
                         "the shed area (0 disables shedding)")
    ap.add_argument("--shed-priority-threshold", type=int, default=None,
                    help="pods below this priority are sheddable past the "
                         "watermark (default 1000: system/high classes "
                         "are never shed)")
    ap.add_argument("--shed-age", type=float, default=None,
                    help="seconds a shed pod waits before aging back into "
                         "the active heap (starvation proof; default 30)")
    ap.add_argument("--wave-deadline", type=float, default=None,
                    help="device-dispatch watchdog budget in seconds: an "
                         "exceeded dispatch is abandoned, trips the "
                         "breaker, and the round completes via the host "
                         "twin (0 disables)")
    ap.add_argument("--bind-journal", default=None,
                    help="durable bind-intent journal path: binds "
                         "spooled during a control-plane outage are "
                         "journaled (fsync'd JSONL) and replayed on "
                         "restart before the first wave (empty "
                         "disables durability)")
    ap.add_argument("--spool-watermark", type=int, default=None,
                    help="disconnected-mode spool depth above which new "
                         "sheddable admissions are held in the shed "
                         "area until the store heals (0 = never hold)")
    ap.add_argument("--store-breaker-threshold", type=int, default=None,
                    help="consecutive store failures (bind/GET/LIST) "
                         "before the store-path breaker declares "
                         "DISCONNECTED (default 3)")
    ap.add_argument("--store-breaker-cooldown", type=float, default=None,
                    help="base seconds between jittered half-open store "
                         "probes while DISCONNECTED (default 30)")
    ap.add_argument("--once", action="store_true",
                    help="exit when the queue drains (batch mode)")
    args = ap.parse_args(argv)

    cfg = (KubeSchedulerConfiguration.load(args.config) if args.config
           else KubeSchedulerConfiguration())
    if args.scheduler_name:
        cfg.scheduler_name = args.scheduler_name
    if args.policy_config_file:
        cfg.policy_config_file = args.policy_config_file
    if args.leader_elect:
        cfg.leader_election.leader_elect = True
    if args.disable_preemption:
        cfg.disable_preemption = True
    if args.wave_size is not None:
        cfg.wave_size = args.wave_size
    if args.mesh_devices is not None:
        cfg.mesh_devices = args.mesh_devices
    if args.mesh_min_devices is not None:
        cfg.mesh_min_devices = args.mesh_min_devices
    if args.scrub_interval is not None:
        cfg.scrub_interval = args.scrub_interval
    if args.compact_interval is not None:
        cfg.compact_interval = args.compact_interval
    if args.hbm_budget_bytes is not None:
        cfg.hbm_budget_bytes = args.hbm_budget_bytes
    if args.healthz_port is not None:
        cfg.healthz_port = args.healthz_port
    if args.tracing:
        cfg.tracing = True
    if args.trace_rounds is not None:
        cfg.trace_rounds = args.trace_rounds
    if args.round_ledger is not None:
        cfg.round_ledger_path = args.round_ledger
    if args.round_ledger_max_bytes is not None:
        cfg.round_ledger_max_bytes = args.round_ledger_max_bytes
    if args.weight_profiles is not None:
        cfg.weight_profiles_path = args.weight_profiles
    if args.shadow_exact_interval is not None:
        cfg.shadow_exact_interval = args.shadow_exact_interval
    if args.invariants:
        cfg.invariants = True
    if args.racecheck:
        cfg.racecheck = True
    if args.shed_watermark is not None:
        cfg.shed_watermark = args.shed_watermark
    if args.shed_priority_threshold is not None:
        cfg.shed_priority_threshold = args.shed_priority_threshold
    if args.shed_age is not None:
        cfg.shed_age_s = args.shed_age
    if args.wave_deadline is not None:
        cfg.wave_deadline_s = args.wave_deadline
    if args.bind_journal is not None:
        cfg.bind_journal_path = args.bind_journal
    if args.spool_watermark is not None:
        cfg.spool_watermark = args.spool_watermark
    if args.store_breaker_threshold is not None:
        cfg.store_breaker_threshold = args.store_breaker_threshold
    if args.store_breaker_cooldown is not None:
        cfg.store_breaker_cooldown = args.store_breaker_cooldown
    for kv in filter(None, args.feature_gates.split(",")):
        k, _, v = kv.partition("=")
        cfg.feature_gates[k] = v.lower() in ("true", "1", "")

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    from ..client.rest import pem_arg

    try:
        return run(cfg, args.server, token=args.token, stop=stop,
                   once=args.once, ca_cert_pem=pem_arg(args.ca_cert_data),
                   client_cert_pem=pem_arg(args.client_cert_data),
                   client_key_pem=pem_arg(args.client_key_data),
                   profiling_enabled=args.profiling,
                   contention_profiling=args.contention_profiling,
                   tracing_enabled=args.tracing, device=device)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
