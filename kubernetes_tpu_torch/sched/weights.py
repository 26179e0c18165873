"""Live weight profiles + the counterfactual shadow-scoring observatory.

A copy of kubernetes_tpu/sched/weights.py, its imports pointed at this
package's ops.kernel.Weights and ops.scores.

The decision observatory ledgers every traced placement with its
per-priority score decomposition; this module closes the observability
half of the learned-scoring loop: it makes the production weight vector
a LIVE, versioned object and lets candidate vectors be judged against
real traffic before they decide anything.

  * ``WeightProfile`` objects (kind ``weightprofiles``, api/types.py)
    are ConfigMap-style weight tables stored through the object store
    and watched by the scheduler. The one with role ``live`` supplies
    the production weight vector — hot-swapped between rounds as a
    TRACED f32 [S] array (ops/kernel.py ``weight_vec``), so a swap or a
    rollback to the static defaults never recompiles a program.
  * every other loaded profile is a shadow CANDIDATE: each traced wave
    is re-scored under it ON HOST by re-applying the candidate vector
    to the per-priority top-K decomposition (``ScoreDeco.top_parts``)
    that already rides out of the scan — zero extra device dispatch.
    Per-wave placement divergence (would-have-chosen != chosen, margin
    deltas, per-priority attribution of each flip) feeds
    ``scheduler_shadow_divergence_total{profile}`` /
    ``scheduler_shadow_margin_delta``, the round ledger's ``shadow``
    record, and the ``/debug/shadow`` endpoint.

Top-K exactness caveat: the decomposition carries the chosen node plus
the top-``SCORE_TOPK`` candidates by PRODUCTION weighted total. A
candidate profile that would elevate a node outside that top-K is
invisible to the host re-scoring, so reported divergence is a LOWER
BOUND. The opt-in exact mode (``shadow_exact_interval``) closes the gap
on sampled rounds by replaying one wave under the candidate vector —
exact placements, at one wave of extra cost per sample. The JAX package
replays through its numpy twin; this package replays through its own
`schedule_wave` on the round's device tensors (sched/scheduler.py
`_shadow_exact_sample`), which gives the same placements because the
wave is bit-equal to the twin. Exact ties keep the production
choice (the kernel breaks score ties round-robin, which host re-scoring
cannot replay), so a tie is never reported as a flip.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np

from ..api import types as api
from ..ops.kernel import Weights
from ..ops.scores import SCORE_STACK, WEIGHT_FIELDS, stack_weights
from ..utils.metrics import bounded_label

# profile names declared for the {profile} metric label: the first
# MAX_PROFILES loaded names form the bounded set, everything past it
# buckets to "Other" via bounded_label (ktpu-lint metrics-hygiene)
MAX_PROFILES = 8
# recent flip entries retained per profile for /debug/shadow
RECENT_FLIPS = 64
# flip samples embedded in each round's `shadow` ledger record
LEDGER_FLIP_SAMPLES = 3

STATIC_VERSION = "static"


def profile_vector(weights: Dict[str, float]) -> np.ndarray:
    """f32 [S] SCORE_STACK-aligned vector from a SCORE_STACK-keyed
    weight table. Unnamed rows default to 0; HostExtra is pinned to 1
    (host/extender rows arrive pre-weighted — the kernel adds them raw,
    so a profile cannot re-weight them and an attempt to must fail
    loudly, not be silently discarded). Unknown keys raise too — a
    typo'd profile must never silently weight nothing."""
    for k in weights:
        if k not in WEIGHT_FIELDS:
            raise ValueError(
                f"unknown priority {k!r} in WeightProfile (rows: "
                f"{', '.join(SCORE_STACK)})")
    if "HostExtra" in weights and float(weights["HostExtra"]) != 1.0:
        raise ValueError(
            "HostExtra cannot be re-weighted (host/extender scores "
            "arrive pre-weighted; the row is pinned to 1)")
    vec = np.zeros(len(SCORE_STACK), np.float32)
    for s, name in enumerate(SCORE_STACK):
        if WEIGHT_FIELDS[name] is None:
            vec[s] = 1.0
        else:
            vec[s] = float(weights.get(name, 0.0))
    return vec


def gate_weights(base: Weights, *vecs: np.ndarray) -> Weights:
    """Static compile gating for live/candidate vectors: a score plane
    compiles in when the profile's static weight OR any given vector
    activates it. Only 0 fields are RAISED (to a 1.0 flag — the traced
    weight_vec supplies the real multiplier), so with no activating
    vector the gating Weights is `base` unchanged and the jit cache key
    is stable; a vector deactivating a statically-active plane keeps it
    compiled (its traced weight is 0, contributing exactly +0.0)."""
    kw = {}
    for s, name in enumerate(SCORE_STACK):
        fld = WEIGHT_FIELDS[name]
        if fld is None:
            continue
        if getattr(base, fld) == 0 and any(float(v[s]) != 0 for v in vecs):
            kw[fld] = 1.0
    return base._replace(**kw) if kw else base


def parse_profiles_file(path: str) -> List[Dict[str, Any]]:
    """Profiles JSON file — one {name, weights, role?} object or a list
    of them — normalized to a list. Shared by WeightBook.load_file and
    bench --shadow so the two paths cannot drift."""
    data = json.loads(open(path).read())
    if isinstance(data, dict):
        data = [data]
    return data


def profile_objects(entries: List[Dict[str, Any]]) -> List[Any]:
    """Plain {name, weights, role?} dicts -> api.WeightProfile objects
    (the single construction point for every file-fed path)."""
    return [api.WeightProfile(
        metadata=api.ObjectMeta(name=e["name"]),
        spec=api.WeightProfileSpec(
            weights=dict(e.get("weights") or {}),
            role=e.get("role", api.WEIGHT_PROFILE_ROLE_CANDIDATE)))
        for e in entries]


def _f32_totals(vec: np.ndarray, parts: np.ndarray) -> np.ndarray:
    """[K] candidate weighted totals from raw parts [S, K], accumulated
    in f32 in SCORE_STACK order — the exact op order the kernel's
    chosen-parts recompute test pins, so under the production vector
    these equal WaveResult.score bitwise."""
    t = np.zeros(parts.shape[-1], np.float32)
    for s in range(parts.shape[0]):
        t = (t + np.float32(vec[s]) * parts[s]).astype(np.float32)
    return t


def _f32_total(vec: np.ndarray, col: np.ndarray) -> np.float32:
    return _f32_totals(vec, col[:, None])[0]


def flip_text(f: Dict[str, Any]) -> str:
    """One-line flip explanation: 'p1: prod chose node-42, candidate
    flips to node-7 on LeastRequested 8→3'."""
    return (f"{f['pod']}: prod chose {f['from']}, candidate flips to "
            f"{f['to']} on {f['priority']} {f['prod']:g}→{f['cand']:g}")


class _ProfileStats:
    """Cumulative shadow accounting for one candidate profile."""

    __slots__ = ("pods", "flips", "delta_n", "delta_sum", "delta_min",
                 "delta_max", "recent", "exact_rounds", "exact_pods",
                 "exact_flips")

    def __init__(self):
        self.pods = 0
        self.flips = 0
        self.delta_n = 0
        self.delta_sum = 0.0
        self.delta_min: Optional[float] = None
        self.delta_max: Optional[float] = None
        self.recent: deque = deque(maxlen=RECENT_FLIPS)
        self.exact_rounds = 0
        self.exact_pods = 0
        self.exact_flips = 0

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"pods": self.pods, "flips": self.flips}
        if self.delta_n:
            out["margin_delta"] = {
                "min": round(float(self.delta_min), 4),
                "mean": round(self.delta_sum / self.delta_n, 4),
                "max": round(float(self.delta_max), 4)}
        if self.exact_rounds:
            out["exact"] = {"rounds": self.exact_rounds,
                            "pods": self.exact_pods,
                            "flips": self.exact_flips}
        return out


class WeightBook:
    """The scheduler's live/candidate weight table.

    Holds every loaded WeightProfile, resolves which one (if any) is
    LIVE, serves the production vector + its version string, gates the
    kernel's static weight arg, and owns the shadow-scoring pass over
    each traced wave's decomposition. Thread-safe: profile events land
    from informer threads, shadow scoring from the wave thread (under
    the scheduler lock), reads from the HealthServer's HTTP threads."""

    def __init__(self, default_weights: Weights):
        self._defaults = default_weights
        self._static_vec = stack_weights(default_weights)
        self._lock = threading.Lock()
        # name -> {"vec", "version", "role"}; insertion-ordered — the
        # first MAX_PROFILES names are the bounded metric label set
        self._profiles: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._stats: Dict[str, _ProfileStats] = {}
        self._synthetic_version = 0

    # -- profile lifecycle (informer handlers / file loading) ----------------

    def on_profile(self, obj) -> None:
        """Add/update one WeightProfile object. A bad weight table is
        rejected with a log-visible ValueError left to the caller —
        the previous table stays in force."""
        vec = profile_vector(dict(obj.spec.weights or {}))
        role = obj.spec.role or api.WEIGHT_PROFILE_ROLE_CANDIDATE
        version = int(getattr(obj.metadata, "resource_version", 0) or 0)
        with self._lock:
            if not version:
                # minted under the lock: concurrent versionless loads
                # must never share a number (highest-version-wins live
                # selection would turn nondeterministic)
                self._synthetic_version += 1
                version = self._synthetic_version
            prev = self._profiles.get(obj.metadata.name)
            self._profiles[obj.metadata.name] = {
                "vec": vec, "version": version, "role": role,
                # the autopilot pre-compile gating flag survives object
                # updates: re-emitting a candidate mid-evaluation must
                # not silently drop its planes from the compiled program
                "gate": bool(prev and prev.get("gate"))}
            self._stats.setdefault(obj.metadata.name, _ProfileStats())

    def on_profile_delete(self, obj) -> None:
        with self._lock:
            self._profiles.pop(obj.metadata.name, None)
            # stats survive deletion: /debug/shadow keeps answering for
            # a just-rolled-back candidate

    def load_entries(self, entries: List[Dict[str, Any]]) -> int:
        """Load profiles from plain dicts ({name, weights, role?}) —
        the file-based path for CLI/bench runs whose store cannot carry
        the weightprofiles kind."""
        n = 0
        for obj in profile_objects(entries):
            self.on_profile(obj)
            n += 1
        return n

    def load_file(self, path: str) -> int:
        """JSON file: one profile object or a list of them."""
        return self.load_entries(parse_profiles_file(path))

    def rollback(self) -> None:
        """Instant in-memory rollback: demote every live profile to
        candidate, so the next round runs the static defaults. The
        authoritative path is updating/deleting the store object (the
        informer applies it identically); this is the emergency lever
        for embedding callers and tests."""
        with self._lock:
            for p in self._profiles.values():
                p["role"] = api.WEIGHT_PROFILE_ROLE_CANDIDATE

    def set_role(self, name: str, role: str) -> bool:
        """Targeted in-memory role change for one profile (the
        autopilot's promote/demote lever when the profile has no store
        object). Demoting only the promoted candidate — instead of
        rollback()'s demote-everything — restores whatever was live
        before it (highest-version live wins again). False when the
        profile isn't loaded."""
        with self._lock:
            p = self._profiles.get(name)
            if p is None:
                return False
            p["role"] = role
            return True

    def set_gating(self, name: str, flag: bool = True) -> bool:
        """Autopilot pre-compile gating: include this candidate's
        vector in the kernel's static gating Weights while it is under
        evaluation. Planes only the candidate activates then compile at
        evaluation START (one compile, before any gate verdict), so a
        later promotion to live is a pure traced-value swap — zero
        recompiles at the moment that matters. False when the profile
        isn't loaded."""
        with self._lock:
            p = self._profiles.get(name)
            if p is None:
                return False
            p["gate"] = bool(flag)
            return True

    def has_profile(self, name: str) -> bool:
        with self._lock:
            return name in self._profiles

    def stats_snapshot(self, name: str) -> Dict[str, float]:
        """Raw cumulative shadow counters for one profile — the
        autopilot shadow gate diffs two snapshots to score exactly its
        gating window, not the profile's lifetime."""
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                return {"pods": 0, "flips": 0, "delta_n": 0,
                        "delta_sum": 0.0}
            return {"pods": st.pods, "flips": st.flips,
                    "delta_n": st.delta_n, "delta_sum": st.delta_sum}

    # -- live vector ---------------------------------------------------------

    def _live_item(self):
        """(name, entry) of the live profile — highest version wins when
        several claim the role — or None. Caller holds _lock."""
        best = None
        for name, p in self._profiles.items():
            if p["role"] != api.WEIGHT_PROFILE_ROLE_LIVE:
                continue
            if best is None or p["version"] > best[1]["version"]:
                best = (name, p)
        return best

    def live_vector(self) -> np.ndarray:
        """The production f32 [S] weight vector: the live profile's, or
        the static defaults."""
        with self._lock:
            item = self._live_item()
            return item[1]["vec"] if item is not None else self._static_vec

    def live_version(self) -> str:
        """The `weights_version` string every round-ledger record and
        decision entry carries: 'static', or '<name>@<version>'."""
        with self._lock:
            item = self._live_item()
            if item is None:
                return STATIC_VERSION
            return f"{item[0]}@{item[1]['version']}"

    def _gating_vecs(self):
        """Vectors of profiles under autopilot pre-compile gating.
        Caller holds _lock."""
        return [p["vec"] for p in self._profiles.values()
                if p.get("gate")]

    def gate(self, base: Weights) -> Weights:
        """The kernel's static gating Weights for the current live
        vector plus any candidates under autopilot pre-compile gating
        (see gate_weights / set_gating)."""
        with self._lock:
            item = self._live_item()
            vecs = self._gating_vecs()
            if item is not None:
                vecs.append(item[1]["vec"])
            if not vecs:
                return base
            return gate_weights(base, *vecs)

    def dispatch_view(self, base: Weights):
        """(gating Weights, live f32 [S] vector, version string) under
        ONE lock hold — the per-round view the scheduler dispatches,
        records decisions, and ledgers with. Resolving the triple
        atomically means a concurrent swap or rollback() (which takes
        only this lock, not the scheduler lock) can never split the
        vector a round dispatched under from the version it reports.
        Gating folds in set_gating candidates so promoting one later
        leaves the gating Weights — and therefore the jit cache key —
        unchanged."""
        with self._lock:
            item = self._live_item()
            vecs = self._gating_vecs()
            if item is None:
                if not vecs:
                    return base, self._static_vec, STATIC_VERSION
                return (gate_weights(base, *vecs), self._static_vec,
                        STATIC_VERSION)
            name, p = item
            return (gate_weights(base, p["vec"], *vecs), p["vec"],
                    f"{name}@{p['version']}")

    # -- shadow candidates ---------------------------------------------------

    def candidate_vectors(self) -> "OrderedDict[str, np.ndarray]":
        """Every loaded profile EXCEPT the current live one (re-scoring
        production against itself is zero divergence by construction)."""
        with self._lock:
            item = self._live_item()
            live_name = item[0] if item is not None else None
            return OrderedDict(
                (name, p["vec"]) for name, p in self._profiles.items()
                if name != live_name)

    def has_candidates(self) -> bool:
        return bool(self.candidate_vectors())

    def declared_labels(self) -> List[str]:
        """The bounded {profile} label value set: the first MAX_PROFILES
        loaded names; call sites clamp through bounded_label so overflow
        buckets to Other (ktpu-lint metrics-hygiene)."""
        with self._lock:
            return list(self._profiles)[:MAX_PROFILES]

    # -- the shadow pass -----------------------------------------------------

    def score_wave(self, pods, chosen, node_names, cparts, tidx, tvals,
                   tparts, committed: Optional[set] = None,
                   metrics=None) -> Optional[Dict[str, Any]]:
        """Re-score one traced wave's decomposition under every
        candidate profile; returns the round ledger's `shadow` record
        (None when there are no candidates or no scored pods).

        Inputs are the fetched ScoreDeco planes aligned with `pods`
        (the same arrays Scheduler._record_decisions consumes):
        cparts f32 [P, S], tidx i32 [P, K], tvals f32 [P, K],
        tparts f32 [P, S, K]. Divergence is computed over the top-K
        candidate set plus the chosen node — a LOWER BOUND (see module
        doc); `lower_bound` is stamped on every record so readers can't
        mistake it for exact."""
        candidates = self.candidate_vectors()
        if not candidates:
            return None
        # NOTE: production totals/margins come from the device-computed
        # tvals, never a live-vector re-read — the record describes the
        # wave that happened even if a swap landed since
        out: Dict[str, Any] = {}
        for name, vec in candidates.items():
            scored = 0
            flips: List[Dict[str, Any]] = []
            deltas: List[float] = []
            for i, pod in enumerate(pods):
                c = int(chosen[i])
                if c < 0 or c >= len(node_names):
                    continue
                if committed is not None and pod.uid not in committed:
                    continue
                scored += 1
                # candidate totals over the top-K set; the chosen node
                # may sit outside top-K (round-robin tie-breaks), so its
                # column comes from chosen_parts and overrides
                cand_tot = _f32_totals(vec, tparts[i])  # [K]
                chosen_tot = _f32_total(vec, cparts[i])
                totals: "OrderedDict[int, np.float32]" = OrderedDict()
                for j in range(tidx[i].shape[0]):
                    n = int(tidx[i][j])
                    if float(tvals[i][j]) < 0 or n >= len(node_names):
                        continue
                    totals[n] = cand_tot[j]
                totals[c] = chosen_tot
                # candidate winner; STRICT > keeps the production choice
                # on exact ties (ties break round-robin on device — a
                # tie is not a divergence the host can assert)
                best_n, best_v = c, chosen_tot
                for n, v in totals.items():
                    if v > best_v:
                        best_n, best_v = n, v
                if best_n != c:
                    jcol = int(np.argmax(tidx[i] == best_n))
                    contrib = (vec.astype(np.float64)
                               * (tparts[i][:, jcol].astype(np.float64)
                                  - cparts[i].astype(np.float64)))
                    s = int(np.argmax(contrib))
                    flips.append({
                        "pod": pod.full_name(), "uid": pod.uid,
                        "from": node_names[c],
                        "to": node_names[best_n],
                        "priority": SCORE_STACK[s],
                        "prod": round(float(cparts[i][s]), 4),
                        "cand": round(float(tparts[i][s][jcol]), 4),
                        "total_delta": round(float(best_v - chosen_tot),
                                             4)})
                # margin delta: candidate margin-over-runner-up minus the
                # production one (both best-minus-second over the same
                # candidate set)
                runner_v = None
                for n, v in totals.items():
                    if n == best_n:
                        continue
                    if runner_v is None or v > runner_v:
                        runner_v = v
                prod_runner = None
                for j in range(tidx[i].shape[0]):
                    if int(tidx[i][j]) != c and float(tvals[i][j]) >= 0:
                        prod_runner = float(tvals[i][j])
                        break
                if runner_v is not None and prod_runner is not None:
                    prod_margin = float(tvals[i][0]) - prod_runner
                    delta = float(best_v - runner_v) - prod_margin
                    deltas.append(delta)
                    if metrics is not None:
                        metrics.shadow_margin_delta.observe(delta)
            if not scored:
                continue
            if metrics is not None:
                lab = bounded_label(name, self.declared_labels())
                metrics.shadow_scored_pods.labels(profile=lab).inc(scored)
                metrics.shadow_divergence.labels(profile=lab).inc(
                    len(flips))
            entry: Dict[str, Any] = {"pods": scored, "flips": len(flips),
                                     "lower_bound": True}
            if deltas:
                entry["margin_delta"] = {
                    "min": round(min(deltas), 4),
                    "mean": round(sum(deltas) / len(deltas), 4),
                    "max": round(max(deltas), 4)}
            if flips:
                entry["flips_sample"] = flips[:LEDGER_FLIP_SAMPLES]
            out[name] = entry
            with self._lock:
                st = self._stats.setdefault(name, _ProfileStats())
                st.pods += scored
                st.flips += len(flips)
                for d in deltas:
                    st.delta_n += 1
                    st.delta_sum += d
                    st.delta_min = (d if st.delta_min is None
                                    else min(st.delta_min, d))
                    st.delta_max = (d if st.delta_max is None
                                    else max(st.delta_max, d))
                st.recent.extend(flips)
        return out or None

    def record_exact(self, name: str, pods: int, flips: int) -> None:
        """Fold one exact-mode replayed wave's result into the
        profile's cumulative stats."""
        with self._lock:
            st = self._stats.setdefault(name, _ProfileStats())
            st.exact_rounds += 1
            st.exact_pods += pods
            st.exact_flips += flips

    # -- reporting (/debug/shadow, bench) ------------------------------------

    def index(self) -> Dict[str, Any]:
        with self._lock:
            item = self._live_item()
            profiles = {}
            for name, p in self._profiles.items():
                st = self._stats.get(name)
                entry = {
                    "version": p["version"], "role": p["role"],
                    "weights": {SCORE_STACK[s]: float(p["vec"][s])
                                for s in range(len(SCORE_STACK))
                                if p["vec"][s]},
                }
                if p.get("gate"):
                    entry["gating"] = True
                if st is not None:
                    entry.update(st.as_dict())
                profiles[name] = entry
            live_version = (STATIC_VERSION if item is None
                            else f"{item[0]}@{item[1]['version']}")
        return {"weights_version": live_version,
                "live": item[0] if item is not None else None,
                "lower_bound": True,
                "profiles": profiles}

    def report(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            p = self._profiles.get(name)
            st = self._stats.get(name)
            if p is None and st is None:
                return None
            out: Dict[str, Any] = {"profile": name, "lower_bound": True}
            if p is not None:
                out["version"] = p["version"]
                out["role"] = p["role"]
                out["weights"] = {SCORE_STACK[s]: float(p["vec"][s])
                                  for s in range(len(SCORE_STACK))
                                  if p["vec"][s]}
            if st is not None:
                out.update(st.as_dict())
                out["recent_flips"] = list(st.recent)
            return out

    def report_text(self, name: str) -> Optional[str]:
        r = self.report(name)
        if r is None:
            return None
        lines = [f"# shadow profile {name}: {r.get('flips', 0)} flips / "
                 f"{r.get('pods', 0)} pods scored (top-K lower bound)"]
        md = r.get("margin_delta")
        if md:
            lines.append(f"# margin delta min/mean/max: "
                         f"{md['min']}/{md['mean']}/{md['max']}")
        ex = r.get("exact")
        if ex:
            lines.append(f"# exact-mode: {ex['flips']} flips / "
                         f"{ex['pods']} pods over {ex['rounds']} "
                         f"sampled waves")
        for f in r.get("recent_flips", []):
            lines.append(flip_text(f))
        return "\n".join(lines) + "\n"

    def summary(self) -> Optional[Dict[str, Any]]:
        """Cumulative per-profile divergence summary (the bench's JSON
        `shadow` field)."""
        with self._lock:
            out = {name: st.as_dict() for name, st in self._stats.items()
                   if st.pods or st.exact_rounds}
        return out or None
