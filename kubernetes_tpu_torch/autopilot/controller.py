"""The promotion pipeline: candidate -> gates -> live -> watched.

A copy of kubernetes_tpu/autopilot/controller.py: OUTCOMES,
AutopilotConfig and AutopilotController over the port's WeightBook
(sched/weights.py), flight recorder and metrics, with the
`autopilot.promote` point in the port's fault registry. The one change:
the replay CI (`_replay_verdict`) runs `run_replay` on the live
scheduler's device (`sched.device`), so promotion CI runs where the
scheduler runs, on the card, and never quietly on the CPU.

State machine over one candidate WeightProfile at a time:

  idle -> shadowing      set_gating pre-compiles the candidate's score
                         planes (so the eventual promotion is a pure
                         traced-value swap, zero recompiles) and
                         snapshots its shadow counters; live traffic
                         then accumulates divergence evidence
       -> (shadow gate)  flip rate and margin-delta over the gating
                         window, bounded by config; candidate deleted
                         mid-window aborts cleanly
       -> (replay CI)    storm trace-replay (replay.py) under the
                         candidate AND under the current production
                         weights; per-class STORM_SLO_P99 gates must
                         pass and the replay objective must not
                         regress against the production baseline
       -> promoted       role=live through the store object when one
                         exists (the informer hot-swap path), else the
                         WeightBook directly; recompile-free by the
                         pre-compile gating above
       -> watching       a FlightRecorder round observer inspects every
                         subsequent traced round; margin collapse or a
                         round-wall SLO breach inside the watch window
                         auto-rolls-back IN MEMORY immediately (the
                         WeightBook demote takes no scheduler lock, so
                         the observer — which may run on the scheduling
                         thread — can never deadlock); the store object
                         is reconciled on the next step()
       -> completed | rolled_back

Every transition is ledgered (tracing.append_record kind "autopilot"),
evented (tracing.event), logged, and the terminal outcome metered as
scheduler_autopilot_promotions_total{outcome}. /debug/autopilot serves
status()/history.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..api import types as api
from ..ops.scores import SCORE_STACK, WEIGHT_FIELDS
from ..utils import faultpoints, tracing
from . import replay as replay_mod

log = logging.getLogger(__name__)

# declared {outcome} label values of
# scheduler_autopilot_promotions_total (utils/metrics.py keeps the
# registered set in lockstep; tests assert it)
OUTCOMES = ("promoted", "rejected_shadow", "rejected_replay",
            "rolled_back", "aborted")

MAX_HISTORY = 64


@dataclass
class AutopilotConfig:
    # shadow gate: evidence floor and bounds over the gating window
    min_shadow_pods: int = 8
    max_flip_rate: float = 0.25
    # mean candidate-margin-minus-production-margin floor (score units;
    # deeply negative = the candidate decides much less decisively)
    margin_delta_floor: float = -1e9
    # promotion CI (replay.py) shape
    replay_nodes: int = 4
    replay_node_cpu: str = "8"
    replay_pod_cpu: str = "100m"
    replay_wave: int = 16
    replay_trace: Optional[List[Dict[str, int]]] = None
    replay_prefill: Optional[Dict[int, int]] = None
    replay_slo_scale: float = 1.0
    # candidate objective may trail the production baseline by at most
    # this much (0 = strict no-regression)
    objective_tolerance: float = 0.02
    # post-promotion regression watch: rounds observed before the
    # promotion is declared good, and the per-round breach bounds
    watch_rounds: int = 8
    watch_margin_floor: float = 0.0   # scores.margin.mean below = breach
    watch_wall_slo_s: float = 30.0    # round wall above = breach

    def as_dict(self) -> Dict[str, Any]:
        return {
            "min_shadow_pods": self.min_shadow_pods,
            "max_flip_rate": self.max_flip_rate,
            "margin_delta_floor": self.margin_delta_floor,
            "objective_tolerance": self.objective_tolerance,
            "watch_rounds": self.watch_rounds,
            "watch_margin_floor": self.watch_margin_floor,
            "watch_wall_slo_s": self.watch_wall_slo_s,
            "replay_slo_scale": self.replay_slo_scale}


class AutopilotController:
    """Drives one candidate at a time through the promotion pipeline.

    Externally paced: start(name) opens the gating window, step()
    advances as far as the evidence allows (and runs the synchronous
    replay CI when the shadow gate passes). The post-promotion watch
    advances itself via a recorder observer; step() only reconciles
    terminal state. Thread-safety: _mu guards controller state;
    WeightBook/ObjectStore calls happen outside scheduler locks except
    the observer's in-memory demote, which is deadlock-free by design
    (WeightBook lock only)."""

    def __init__(self, sched, store=None,
                 config: Optional[AutopilotConfig] = None):
        self.sched = sched
        self.store = store
        self.book = sched.weightbook
        self.metrics = sched.metrics
        self.cfg = config or AutopilotConfig()
        self._mu = threading.Lock()
        self.state = "idle"
        self.candidate: Optional[str] = None
        self.outcome: Optional[str] = None
        self.history: List[Dict[str, Any]] = []
        self.reports: Dict[str, Any] = {}
        self._shadow_start: Optional[Dict[str, float]] = None
        self._watch: Optional[Dict[str, Any]] = None
        self._observer = None
        self._force = False
        # the scheduler serves /debug/autopilot through this backref
        sched.autopilot = self

    # -- bookkeeping ---------------------------------------------------------

    def _transition(self, state: str, **info):
        entry = {"state": state, "profile": self.candidate}
        entry.update({k: v for k, v in info.items() if v is not None})
        self.state = state
        self.history.append(entry)
        del self.history[:-MAX_HISTORY]
        rec = tracing.active()
        if rec is not None:
            rec.append_record("autopilot", state=state,
                              profile=self.candidate,
                              **{k: v for k, v in info.items()
                                 if v is not None})
        tracing.event("autopilot", state=state, profile=self.candidate)
        log.info("autopilot: %s profile=%s %s", state, self.candidate,
                 info or "")

    def _finish(self, outcome: str, **info):
        self.outcome = outcome
        self.metrics.autopilot_promotions.labels(outcome=outcome).inc()
        self._transition(outcome, **info)
        self._detach_observer()
        self._watch = None
        self._shadow_start = None

    def _detach_observer(self):
        rec = tracing.active()
        if rec is not None and self._observer is not None:
            try:
                rec.observers.remove(self._observer)
            except ValueError:
                pass
        self._observer = None

    # -- pipeline ------------------------------------------------------------

    def start(self, name: str, force: bool = False) -> str:
        """Open the gating window for one candidate. force=True skips
        the shadow and replay gates on the next step() — the operator
        override the regression watch exists to backstop."""
        with self._mu:
            if self.state not in ("idle", "completed", "rolled_back",
                                  "rejected_shadow", "rejected_replay",
                                  "aborted"):
                raise RuntimeError(
                    f"autopilot busy: {self.state} on {self.candidate}")
            self.candidate = name
            self.outcome = None
            self._force = force
            if not self.book.has_profile(name):
                self._finish("aborted", reason="unknown profile")
                return self.state
            # pre-compile the candidate's planes NOW: the one gating
            # compile lands here, before any verdict, so promotion
            # later swaps a traced value into an already-built program
            self.book.set_gating(name, True)
            self._shadow_start = self.book.stats_snapshot(name)
            self._transition("shadowing", force=force or None)
            return self.state

    def step(self) -> str:
        """Advance as far as the current evidence allows. Returns the
        (possibly terminal) state."""
        with self._mu:
            if self.state == "shadowing":
                self._step_shadowing()
            elif self.state == "watching" or self.outcome == "rolled_back":
                # rolled_back keeps reconciling: the observer could not
                # touch the store, so the object's role lags the
                # in-memory demote until a step() lands
                self._reconcile_watch()
            return self.state

    def _step_shadowing(self):
        name = self.candidate
        if not self.book.has_profile(name):
            # deleted mid-gating: abort cleanly, nothing was promoted
            self._finish("aborted", reason="candidate deleted "
                                           "during gating")
            return
        if not self._force:
            verdict = self._shadow_verdict(name)
            if verdict is None:
                return  # not enough evidence yet; stay shadowing
            ok, shadow_info = verdict
            self.reports["shadow"] = shadow_info
            if not ok:
                self.book.set_gating(name, False)
                self._finish("rejected_shadow", **shadow_info)
                return
            self._transition("replaying", **shadow_info)
            ok, replay_info = self._replay_verdict(name)
            self.reports["replay"] = replay_info
            if not self.book.has_profile(name):
                self._finish("aborted", reason="candidate deleted "
                                               "during replay CI")
                return
            if not ok:
                self.book.set_gating(name, False)
                self._finish("rejected_replay", **{
                    k: replay_info[k] for k in
                    ("objective", "baseline_objective", "failures")
                    if k in replay_info})
                return
        try:
            self._promote(name)
        except faultpoints.FaultInjected as e:
            self.book.set_gating(name, False)
            self._finish("aborted", reason=str(e))
            return
        self._begin_watch(name)

    def _shadow_verdict(self, name):
        """(ok, info) once the gating window holds enough scored pods;
        None while evidence is still accumulating."""
        s0 = self._shadow_start or {}
        s1 = self.book.stats_snapshot(name)
        pods = s1["pods"] - s0.get("pods", 0)
        if pods < self.cfg.min_shadow_pods:
            return None
        flips = s1["flips"] - s0.get("flips", 0)
        flip_rate = flips / pods
        dn = s1["delta_n"] - s0.get("delta_n", 0)
        dsum = s1["delta_sum"] - s0.get("delta_sum", 0.0)
        delta_mean = dsum / dn if dn else 0.0
        info = {"pods": pods, "flips": flips,
                "flip_rate": round(flip_rate, 4),
                "margin_delta_mean": round(delta_mean, 4)}
        if flip_rate > self.cfg.max_flip_rate:
            info["reason"] = (f"flip rate {flip_rate:.2f} over the "
                              f"{self.cfg.max_flip_rate:.2f} gate")
            return False, info
        if dn and delta_mean < self.cfg.margin_delta_floor:
            info["reason"] = (f"margin delta {delta_mean:.2f} under "
                              f"the {self.cfg.margin_delta_floor:.2f} "
                              f"floor")
            return False, info
        return True, info

    def _current_production_table(self) -> Optional[Dict[str, float]]:
        """The live weight table as a profiles dict (None = static
        defaults, which run_replay applies by construction)."""
        if self.book.live_version() == "static":
            return None
        vec = self.book.live_vector()
        return {name: float(vec[s]) for s, name in enumerate(SCORE_STACK)
                if WEIGHT_FIELDS[name] is not None and vec[s]}

    def _replay_verdict(self, name):
        """Promotion CI: replay under the candidate and under current
        production, on the live scheduler's device; SLO gates must pass
        and the objective must not regress."""
        cfg = self.cfg
        rep = self.book.report(name) or {}
        weights = rep.get("weights")
        if not weights:
            return False, {"failures": ["candidate has no weights"]}
        kw = dict(nodes=cfg.replay_nodes, node_cpu=cfg.replay_node_cpu,
                  pod_cpu=cfg.replay_pod_cpu, wave=cfg.replay_wave,
                  trace=cfg.replay_trace, prefill=cfg.replay_prefill,
                  slo_scale=cfg.replay_slo_scale, device=self.sched.device)
        baseline = replay_mod.run_replay(
            self._current_production_table(), name="production", **kw)
        cand = replay_mod.run_replay(dict(weights), name=name, **kw)
        info = {"objective": cand.objective,
                "baseline_objective": baseline.objective,
                "candidate": cand.as_dict(),
                "baseline": baseline.as_dict()}
        if not cand.passed:
            info["failures"] = list(cand.failures)
            return False, info
        if cand.objective < baseline.objective - cfg.objective_tolerance:
            info["failures"] = [
                f"objective {cand.objective:.4f} regresses the "
                f"production baseline {baseline.objective:.4f}"]
            return False, info
        return True, info

    def _promote(self, name: str):
        faultpoints.fire("autopilot.promote", payload=name)
        prev_version = self.book.live_version()
        promoted_via = "weightbook"
        if self.store is not None:
            obj = self.store.get("weightprofiles", "default", name)
            if obj is not None:
                obj.spec.role = api.WEIGHT_PROFILE_ROLE_LIVE
                self.store.update("weightprofiles", obj)
                promoted_via = "store"
        if promoted_via == "weightbook":
            self.book.set_role(name, api.WEIGHT_PROFILE_ROLE_LIVE)
        self.outcome = "promoted"
        self.metrics.autopilot_promotions.labels(
            outcome="promoted").inc()
        self._transition("promoted", previous=prev_version,
                         now=self.book.live_version(), via=promoted_via)

    def _begin_watch(self, name: str):
        w = {"profile": name, "version": self.book.live_version(),
             "rounds_left": self.cfg.watch_rounds, "breach": None}
        self._watch = w
        rec = tracing.active()
        if rec is None:
            # nothing to observe without a recorder: the promotion
            # stands on the gates alone
            self._transition("completed", watched=0)
            self.book.set_gating(name, False)
            self._watch = None
            return

        def observe(record):
            self._observe_round(record)

        self._observer = observe
        rec.observers.append(observe)
        self._transition("watching", rounds=self.cfg.watch_rounds,
                         version=w["version"])

    def _observe_round(self, record: Dict[str, Any]):
        """FlightRecorder observer: runs after every finished traced
        round, possibly ON the scheduling thread — so a breach rolls
        back through the WeightBook only (no scheduler lock, no store
        round-trip; step() reconciles the object afterwards)."""
        w = self._watch
        if w is None or self.state != "watching":
            return
        if record.get("weights_version") != w["version"]:
            return  # replay rounds, other schedulers, stale records
        scores = record.get("scores")
        if not scores:
            return
        breach = None
        margin = (scores.get("margin") or {}).get("mean")
        if margin is not None and margin < self.cfg.watch_margin_floor:
            breach = (f"margin mean {margin:.4f} under the "
                      f"{self.cfg.watch_margin_floor:.4f} floor")
        wall = float(record.get("wall_s", 0.0))
        if breach is None and wall > self.cfg.watch_wall_slo_s:
            breach = (f"round wall {wall:.3f}s over the "
                      f"{self.cfg.watch_wall_slo_s:.3f}s SLO")
        with self._mu:
            if self._watch is not w or self.state != "watching":
                return
            if breach is not None:
                w["breach"] = breach
                # instant in-memory rollback: demote ONLY the promoted
                # candidate, so whatever was live before it (or the
                # static defaults) decides the very next round
                self.book.set_role(w["profile"],
                                   api.WEIGHT_PROFILE_ROLE_CANDIDATE)
                self.book.set_gating(w["profile"], False)
                self._finish("rolled_back", reason=breach,
                             restored=self.book.live_version())
                return
            w["rounds_left"] -= 1
            if w["rounds_left"] <= 0:
                self.book.set_gating(w["profile"], False)
                self._transition("completed",
                                 watched=self.cfg.watch_rounds)
                self._detach_observer()
                self._watch = None

    def _reconcile_watch(self):
        """step() housekeeping while watching / after a rollback: the
        store object's role must eventually match the in-memory truth
        (the observer cannot do a store round-trip — see
        _observe_round), and an externally deleted or demoted live
        profile ends the watch as an operator rollback."""
        name = self.candidate
        if self.outcome == "rolled_back" and self.store is not None:
            obj = self.store.get("weightprofiles", "default", name)
            if obj is not None and obj.spec.role == \
                    api.WEIGHT_PROFILE_ROLE_LIVE:
                obj.spec.role = api.WEIGHT_PROFILE_ROLE_CANDIDATE
                self.store.update("weightprofiles", obj)
            return
        if self.state == "watching" and not self.book.has_profile(name):
            self._finish("rolled_back",
                         reason="candidate deleted during watch",
                         restored=self.book.live_version())

    def rollback(self, reason: str = "operator"):
        """Explicit rollback lever (CLI / debug): demote the promoted
        candidate and finish."""
        with self._mu:
            if self.candidate is None or self.state not in (
                    "watching", "promoted", "completed"):
                return
            self.book.set_role(self.candidate,
                               api.WEIGHT_PROFILE_ROLE_CANDIDATE)
            self.book.set_gating(self.candidate, False)
            self._finish("rolled_back", reason=reason,
                         restored=self.book.live_version())
        self._reconcile_watch()

    # -- reporting (/debug/autopilot) ----------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._mu:
            out: Dict[str, Any] = {
                "state": self.state,
                "candidate": self.candidate,
                "outcome": self.outcome,
                "weights_version": self.book.live_version(),
                "config": self.cfg.as_dict(),
                "history": list(self.history),
            }
            if self._watch is not None:
                out["watch"] = {k: self._watch[k] for k in
                                ("profile", "version", "rounds_left",
                                 "breach")}
            if self.reports:
                out["reports"] = dict(self.reports)
            return out
