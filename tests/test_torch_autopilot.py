"""The port's scheduler autopilot (kubernetes_tpu_torch/autopilot/,
cli/autopilot.py) against the JAX package's, on the CPU.

The offline half runs on both packages from the same files and records:
the ledger loader and build_dataset (rotation, torn lines, mixed
versions, a missing file) give equal matrices and skip counts, the ridge
trainer gives bit-equal tables and the same errors below its evidence
floor, and emit_candidate stores the same object. The replay CI runs on
both packages' schedulers with equal deterministic fields (p99 and wall
seconds are wall-clock). The promotion pipeline (tests/test_autopilot.py's
cases) runs in lockstep on the skewed 3-node world, one 100m pod a round
(more pods a round equalize the nodes, the margins tie to 0 and the
watch rolls a good candidate back): the same states, outcomes, reports,
ledgered transitions and promotion counts in both, and no new shape
bucket of the round (the port's `_COMPILED` keys of program "round",
JAX's `_schedule_round._cache_size()`) across step, promotion and watch.
The gating sets are test_autopilot.py's, so that the JAX jit cache the
files share on a worker compiles nothing test_shadow.py expects to
compile fresh. /debug/autopilot and the CLI's train and replay answer
the same JSON.
"""

import importlib
import io
import json
import urllib.error
import urllib.request
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_worlds import plain_node, plain_pod

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")
JAX, TORCH = PKGS
# wall-clock fields of reports, histories and ledger records
TIMED = ("p99", "wall_s", "ts")
# replay CI at the live world's shape (3 8-core nodes, wave 8) with SLO
# headroom for contended hosts, as tests/test_autopilot.py runs it
REPLAY_KW = dict(replay_nodes=3, replay_wave=8, replay_slo_scale=4.0)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def device_kw(pkg):
    return dict(device="cpu") if pkg == TORCH else {}


def untimed(x):
    """x less its wall-clock fields, at any depth."""
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k not in TIMED}
    if isinstance(x, (list, tuple)):
        return [untimed(v) for v in x]
    return x


def both(fn):
    """fn(pkg) on each package; the two results equal; the port's."""
    got = {pkg: fn(pkg) for pkg in PKGS}
    assert got[TORCH] == got[JAX]
    return got[TORCH]


@pytest.fixture(autouse=True)
def _tracing_off():
    for pkg in PKGS:
        mod(pkg, "utils.tracing").disable()
    yield
    for pkg in PKGS:
        mod(pkg, "utils.tracing").disable()


def test_the_surface_is_the_jax_one():
    j, t = mod(JAX, "autopilot"), mod(TORCH, "autopilot")
    assert t.__all__ == j.__all__
    assert t.OUTCOMES == j.OUTCOMES
    assert t.STORM_PRIORITY == j.STORM_PRIORITY
    assert t.STORM_SLO_P99 == j.STORM_SLO_P99
    assert t.workload_profiles_path() != j.workload_profiles_path()
    with open(t.workload_profiles_path(), "rb") as f, \
            open(j.workload_profiles_path(), "rb") as g:
        assert f.read() == g.read()
    assert mod(TORCH, "autopilot.dataset").FEATURES == \
        mod(JAX, "autopilot.dataset").FEATURES
    assert mod(TORCH, "autopilot.trainer").MIN_ROUNDS == \
        mod(JAX, "autopilot.trainer").MIN_ROUNDS
    assert mod(TORCH, "autopilot.controller").AutopilotConfig().as_dict() \
        == mod(JAX, "autopilot.controller").AutopilotConfig().as_dict()
    decl = mod(TORCH, "utils.metrics").Metrics().autopilot_promotions.decl
    assert set(decl.values["outcome"]) == set(t.OUTCOMES)
    points = mod(TORCH, "utils.faultpoints").registered_points()
    assert {"autopilot.train", "autopilot.promote"} <= points


# -- the ledger loader and the dataset ----------------------------------------


def _round_rec(rid, util, frag, breakdown, version="static", **extra):
    """A synthetic v2 round-ledger record with a scores aggregate."""
    total = float(sum(breakdown.values()))
    rec = {"v": 2, "round": rid, "kind": "round", "placed": 8,
           "pending": 0, "wall_s": 0.01, "weights_version": version,
           "scores": {"min": total, "max": total, "mean": total,
                      "breakdown": dict(breakdown),
                      "margin": {"min": 1.0, "mean": 2.0, "max": 4.0}},
           "telemetry": {"util": {"cpu": util}, "frag": {"cpu": frag}}}
    rec.update(extra)
    return rec


def _planted(n=16, prio="LeastRequested", anti="BalancedAllocation",
             invert=False):
    """Rounds where `prio`'s contribution share tracks round quality and
    `anti`'s anti-tracks it (tests/test_autopilot.py _planted_records)."""
    out = []
    for i in range(n):
        share = i / (n - 1)
        util = 0.2 + 0.6 * ((1 - share) if invert else share)
        out.append(_round_rec(i, util, 0.2,
                              {prio: 1.0 + 9.0 * share,
                               anti: 1.0 + 9.0 * (1 - share)}))
    return out


def _write(path, lines):
    with open(path, "w") as f:
        for x in lines:
            f.write(x if isinstance(x, str) else json.dumps(x) + "\n")


def _ledger_rotated(path):
    _write(path + ".1", [_round_rec(i, 0.1 * i, 0.3, {"LeastRequested": i})
                         for i in range(1, 5)])
    _write(path, [_round_rec(i, 0.5, 0.05 * i, {"MostRequested": 3.0,
                                                  "LeastRequested": i})
                  for i in range(5, 9)])


def _ledger_torn(path):
    _write(path, [
        _round_rec(1, 0.5, 0.2, {"LeastRequested": 8.0}),
        _round_rec(2, 0.6, 0.1, {"LeastRequested": 9.0},
                   version="cand@3", future_key={"x": 1}),
        _round_rec(3, 0.4, 0.3, {"BalancedAllocation": 2.0}, v=99),
        {"v": 2, "round": 4, "kind": "autopilot", "state": "promoted"},
        {"v": 1, "round": 5, "placed": 3},
        "[1, 2, 3]\n",
        "\n",
        '{"torn": "lin'])


def _ledger_planted(path):
    _write(path, _planted(24) + [
        {"v": 2, "round": 0, "kind": "autopilot", "state": "shadowing"}])


LEDGERS = {"rotated": _ledger_rotated, "torn": _ledger_torn,
           "planted": _ledger_planted, "missing": lambda path: None}


@pytest.mark.parametrize("ledger", sorted(LEDGERS))
def test_the_loader_and_the_dataset_are_the_jax_ones(ledger, tmp_path):
    path = str(tmp_path / "rounds.jsonl")
    LEDGERS[ledger](path)
    got = {}
    for pkg in PKGS:
        ds_mod = mod(pkg, "autopilot.dataset")
        records, skipped = ds_mod.load_records(path)
        ds = ds_mod.load_dataset(path)
        built = ds_mod.build_dataset(records, skipped=skipped)
        for d in (ds, built):
            assert d.features.dtype == d.contrib.dtype == np.float64
        assert all(np.array_equal(getattr(ds, f), getattr(built, f))
                   for f in ("features", "contrib", "quality"))
        # the documented trap: a path passed for the records skips each
        # of its characters
        wrong = ds_mod.build_dataset(path)
        got[pkg] = (records, skipped, ds, len(wrong), wrong.skipped,
                    [ds_mod.round_quality(r) for r in records])
    (rj, sj, dj, *rest_j), (rt, st, dt, *rest_t) = got[JAX], got[TORCH]
    assert rt == rj and st == sj and rest_t == rest_j
    for f in ("features", "contrib", "quality"):
        a, b = getattr(dj, f), getattr(dt, f)
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert (dt.rounds, dt.versions, dt.skipped, dt.active_priorities()) == \
        (dj.rounds, dj.versions, dj.skipped, dj.active_priorities())
    want = {"rotated": (8, 0), "torn": (3, 4), "planted": (24, 1),
            "missing": (0, 0)}[ledger]
    assert (len(dt), dt.skipped) == want


# -- the trainer ----------------------------------------------------------------


FITS = {
    "boost": dict(records=_planted()),
    "boost_step": dict(records=_planted(), step=0.25, ridge_lambda=0.1),
    "introduce": dict(records=_planted(prio="MostRequested")),
    "keep_off": dict(records=_planted(prio="MostRequested", invert=True)),
    "inverted": dict(records=_planted(invert=True)),
    "mixed": dict(records=_planted(9) + _planted(7, prio="ImageLocality",
                                                 anti="NodeAffinity")),
    "below_floor": dict(records=_planted(n=3)),
    "no_signal": dict(records=[_round_rec(i, 0.5, 0.2, {"HostExtra": 5.0})
                               for i in range(8)]),
    "empty": dict(records=[]),
}


@pytest.mark.parametrize("fit", sorted(FITS))
def test_the_ridge_fit_is_bit_equal(fit):
    kw = dict(FITS[fit])
    records = kw.pop("records")

    def run(pkg):
        tr = mod(pkg, "autopilot.trainer")
        base = mod(pkg, "plugins.registry").default_profile(None).weights()
        ds = mod(pkg, "autopilot.dataset").build_dataset(records)
        try:
            table = tr.RidgeTrainer(base, **kw).fit(ds)
        except ValueError as e:
            return ("error", str(e))
        # bit for bit: each weight's float64 bytes
        return sorted((k, np.float64(v).tobytes().hex())
                      for k, v in table.items())
    got = both(run)
    if fit in ("below_floor", "no_signal", "empty"):
        assert got[0] == "error"
    else:
        assert dict(got)["PreferAvoid"] == \
            np.float64(10000.0).tobytes().hex()


def test_weights_table_and_the_policy_gradient_seam():
    def run(pkg):
        tr = mod(pkg, "autopilot.trainer")
        base = mod(pkg, "plugins.registry").default_profile(None).weights()
        out = [sorted(tr.weights_table(base).items()),
               sorted(tr.weights_table({"LeastRequested": 2, "HostExtra": 3,
                                        "MostRequested": 0}).items())]
        with pytest.raises(NotImplementedError) as ei:
            tr.PolicyGradientTrainer(base).fit(
                mod(pkg, "autopilot.dataset").build_dataset(_planted()))
        return out + [str(ei.value)]
    both(run)


def test_the_train_fault_point_fires_in_the_port():
    fp = mod(TORCH, "utils.faultpoints")
    tr = mod(TORCH, "autopilot.trainer")
    base = mod(TORCH, "plugins.registry").default_profile(None).weights()
    ds = mod(TORCH, "autopilot.dataset").build_dataset(_planted())
    with fp.injected("autopilot.train", "raise"):
        with pytest.raises(fp.FaultInjected):
            tr.RidgeTrainer(base).fit(ds)
    assert fp.hits("autopilot.train") == 1


def test_emit_candidate_stores_the_same_object():
    def run(pkg):
        api = mod(pkg, "api.types")
        store = mod(pkg, "runtime.store").ObjectStore()
        sched = mod(pkg, "sched.scheduler").Scheduler(
            store, wave_size=8, **device_kw(pkg))
        tr = mod(pkg, "autopilot.trainer")
        seen = []
        try:
            def obj():
                wp = store.get("weightprofiles", "default", "trained")
                return (wp.metadata.name, wp.metadata.namespace,
                        wp.metadata.resource_version, dict(wp.spec.weights),
                        wp.spec.role, sched.weightbook.has_profile("trained"),
                        sched.weightbook.live_version())
            tr.emit_candidate(store, "trained", {"LeastRequested": 1.4})
            seen.append(obj())
            wp = store.get("weightprofiles", "default", "trained")
            wp.spec.role = api.WEIGHT_PROFILE_ROLE_LIVE
            store.update("weightprofiles", wp)
            seen.append(obj())
            # a retrain supersedes in place and demotes to candidate
            tr.emit_candidate(store, "trained", {"LeastRequested": 1.8})
            seen.append(obj())
        finally:
            sched.close()
        return seen
    seen = both(run)
    assert [s[4] for s in seen] == ["candidate", "live", "candidate"]
    assert seen[2][3] == {"LeastRequested": 1.8}


# -- the replay CI -----------------------------------------------------------------


REPLAYS = {
    "baseline": dict(weights=None),
    "packer": dict(weights={"MostRequested": 5.0, "ImageLocality": 0.5},
                   prefill={0: 6, 1: 3}),
    "tiny": dict(weights={"LeastRequested": 0.001}, prefill={0: 6, 1: 3}),
}


@pytest.mark.parametrize("replay", sorted(REPLAYS))
def test_the_replay_ci_is_the_jax_one(replay):
    kw = dict(REPLAYS[replay])
    weights = kw.pop("weights")

    def run(pkg):
        rp = mod(pkg, "autopilot.replay")
        rep = rp.run_replay(weights, nodes=3, wave=8, slo_scale=4.0,
                            **kw, **device_kw(pkg))
        # the recorder the replay brought up is gone again
        assert mod(pkg, "utils.tracing").active() is None
        return untimed(rep.as_dict())
    rep = both(run)
    assert rep["passed"] and rep["placed"] == rep["total"] == 42
    assert rep["version"] == ("static" if weights is None else
                              rep["version"])


def test_the_replay_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod(TORCH, "autopilot.replay").run_replay(None, nodes=3, wave=8)
    assert mod(TORCH, "utils.tracing").active() is None


# -- the promotion pipeline in lockstep ----------------------------------------------


class Pilot:
    """The skewed 3-node world (6/3/0 cores used of 8: the defaults pick
    n2, MostRequested strictly prefers n0) in both packages, traced, each
    with its controller."""

    def __init__(self, live=None, **over):
        self.side = {}
        for pkg in PKGS:
            api = mod(pkg, "api.types")
            rec = mod(pkg, "utils.tracing").enable()
            store = mod(pkg, "runtime.store").ObjectStore()
            sched = mod(pkg, "sched.scheduler").Scheduler(
                store, wave_size=8, **device_kw(pkg))
            for i in range(3):
                store.create("nodes", plain_node(pkg, f"n{i}", cpu="8"))
            for node, n in (("n0", 6), ("n1", 3)):
                for i in range(n):
                    store.create("pods", plain_pod(
                        pkg, f"pre-{node}-{i}", cpu="1", node_name=node))
            if live is not None:
                store.create("weightprofiles", api.WeightProfile(
                    metadata=api.ObjectMeta(name="good"),
                    spec=api.WeightProfileSpec(weights=dict(live),
                                               role="live")))
            cfg = dict(min_shadow_pods=3, watch_rounds=2,
                       watch_margin_floor=1.0, **REPLAY_KW)
            cfg.update(over)
            ap = mod(pkg, "autopilot")
            ctl = ap.AutopilotController(
                sched, store=store, config=ap.AutopilotConfig(**cfg))
            self.side[pkg] = SimpleNamespace(pkg=pkg, api=api, rec=rec,
                                             store=store, sched=sched,
                                             ctl=ctl)
        self.seq = 0

    def close(self):
        for s in self.side.values():
            s.sched.close()

    def each(self, fn):
        """fn(side) on both sides; equal results; the port's."""
        got = {pkg: fn(s) for pkg, s in self.side.items()}
        assert got[TORCH] == got[JAX]
        return got[TORCH]

    def emit(self, name, table):
        self.each(lambda s: mod(s.pkg, "autopilot.trainer").emit_candidate(
            s.store, name, table).metadata.resource_version)

    def rounds(self, n, tag):
        for _ in range(n):
            for s in self.side.values():
                s.store.create("pods", plain_pod(
                    s.pkg, f"{tag}-{self.seq}", cpu="100m"))
                assert s.sched.schedule_pending() == 1
            self.seq += 1
        self.check()

    def state(self, s):
        m = s.sched.metrics.autopilot_promotions
        return {
            "state": s.ctl.state, "outcome": s.ctl.outcome,
            "candidate": s.ctl.candidate,
            "live": s.sched.weightbook.live_version(),
            "history": untimed(s.ctl.history),
            "reports": untimed(s.ctl.reports),
            "promotions": {o: m.value(outcome=o)
                           for o in mod(s.pkg, "autopilot").OUTCOMES
                           if m.value(outcome=o)},
            "transitions": [untimed(r) for r in s.rec.ledger_rows()
                            if r.get("kind") == "autopilot"],
            "versions": [r.get("weights_version")
                         for r in s.rec.ledger_rows() if r.get("placed")],
            "bindings": sorted((p.metadata.name, p.spec.node_name)
                               for p in s.store.list("pods")),
            "index": s.sched.weightbook.index(),
        }

    def check(self):
        return self.each(self.state)

    def step(self):
        out = self.each(lambda s: s.ctl.step())
        self.check()
        return out

    def start(self, name, force=False):
        out = self.each(lambda s: s.ctl.start(name, force=force))
        self.check()
        return out


def round_keys():
    """The round program's shape buckets in each package: the port's
    `_COMPILED` keys of program "round", JAX's `_schedule_round` cache."""
    return (mod(JAX, "ops.kernel")._schedule_round._cache_size(),
            frozenset(k for k in mod(TORCH, "ops.kernel")._COMPILED
                      if k[0] == "round"))


def _trained():
    return both(lambda pkg: mod(pkg, "autopilot.trainer").RidgeTrainer(
        mod(pkg, "plugins.registry").default_profile(None).weights()).fit(
        mod(pkg, "autopilot.dataset").build_dataset(_planted())))


def test_a_trained_candidate_is_promoted_with_no_new_round_bucket():
    trained = _trained()
    assert trained["LeastRequested"] > 1.0
    p = Pilot()
    try:
        p.emit("trained", trained)
        assert p.start("trained") == "shadowing"
        p.rounds(3, "gate")
        keys = round_keys()  # after the gating rounds
        assert p.step() == "watching"
        st = p.check()
        assert st["outcome"] == "promoted" and st["live"].startswith(
            "trained@")
        assert round_keys() == keys
        p.rounds(2, "watch")
        st = p.check()
        assert st["state"] == "completed"
        assert round_keys() == keys
        assert [t["state"] for t in st["transitions"]] == [
            "shadowing", "replaying", "promoted", "watching", "completed"]
        assert st["promotions"] == {"promoted": 1.0}
        assert st["reports"]["shadow"]["flip_rate"] <= 0.25
        assert st["reports"]["replay"]["candidate"]["passed"] is True
        assert st["versions"][-1] == st["live"]
    finally:
        p.close()


def test_a_regression_candidate_is_rejected_at_the_shadow_gate():
    p = Pilot()
    try:
        # MostRequested flips every placement on the skewed world (the
        # inert ImageLocality keeps test_autopilot.py's gating set)
        p.emit("packer", {"MostRequested": 5.0, "ImageLocality": 0.5})
        p.start("packer")
        p.rounds(4, "gate")
        assert p.step() == "rejected_shadow"
        st = p.check()
        assert st["reports"]["shadow"]["flip_rate"] == 1.0
        assert st["live"] == "static"
        assert "gating" not in st["index"]["profiles"]["packer"]
        assert st["promotions"] == {"rejected_shadow": 1.0}
    finally:
        p.close()


def test_a_forced_regression_is_rolled_back_then_reconciled():
    p = Pilot(live={"LeastRequested": 2.0, "PreferAvoid": 10000.0})
    try:
        prior = p.check()["live"]
        assert prior.startswith("good@")
        # near-zero weights collapse the margins under the watch floor
        p.emit("tiny", {"LeastRequested": 0.001})
        p.start("tiny", force=True)
        assert p.step() == "watching"
        assert p.check()["live"].startswith("tiny@")
        # the first watched round breaches: rolled back in memory
        p.rounds(1, "breach")
        st = p.check()
        assert st["state"] == "rolled_back" and st["live"] == prior
        assert "margin" in st["history"][-1]["reason"]
        p.rounds(1, "after")
        assert p.check()["versions"][-1] == prior
        # the store's role lags until a step() reconciles it
        p.each(lambda s: s.store.get("weightprofiles", "default",
                                     "tiny").spec.role)
        p.step()
        assert p.each(lambda s: s.store.get(
            "weightprofiles", "default", "tiny").spec.role) == "candidate"
        st = p.check()
        assert [t["state"] for t in st["transitions"]] == [
            "shadowing", "promoted", "watching", "rolled_back"]
        assert st["promotions"] == {"promoted": 1.0,
                                    "rolled_back": 1.0}
    finally:
        p.close()


def test_a_candidate_deleted_mid_gating_aborts():
    p = Pilot()
    try:
        p.emit("ghost", {"LeastRequested": 1.2})
        p.start("ghost")
        p.rounds(1, "gate")
        p.each(lambda s: s.store.delete("weightprofiles", "default",
                                        "ghost") and None)
        assert p.step() == "aborted"
        st = p.check()
        assert "deleted" in st["history"][-1]["reason"]
        assert st["live"] == "static"
        assert st["promotions"] == {"aborted": 1.0}
        # reusable after a terminal state
        p.emit("next", {"LeastRequested": 1.2})
        assert p.start("next") == "shadowing"
    finally:
        p.close()


def test_the_promote_fault_point_aborts_cleanly():
    p = Pilot()
    try:
        p.emit("cand", {"LeastRequested": 1.2})
        p.start("cand", force=True)

        def step(s):
            fp = mod(s.pkg, "utils.faultpoints")
            with fp.injected("autopilot.promote", "raise"):
                return s.ctl.step(), fp.hits("autopilot.promote")
        assert p.each(step) == ("aborted", 1)
        st = p.check()
        assert st["live"] == "static"
        assert "gating" not in st["index"]["profiles"]["cand"]
        assert st["promotions"] == {"aborted": 1.0}
    finally:
        p.close()


def test_the_replay_ci_runs_on_the_live_schedulers_device(monkeypatch):
    replay = mod(TORCH, "autopilot.replay")
    seen = []
    real = replay.run_replay

    def spy(*a, **kw):
        seen.append(kw["device"])
        return real(*a, **kw)
    monkeypatch.setattr(replay, "run_replay", spy)
    ap = mod(TORCH, "autopilot")
    store = mod(TORCH, "runtime.store").ObjectStore()
    sched = mod(TORCH, "sched.scheduler").Scheduler(store, wave_size=8,
                                                     device="cpu")
    try:
        ctl = ap.AutopilotController(sched, store=store, config=ap
                                     .AutopilotConfig(**REPLAY_KW))
        assert sched.autopilot is ctl
        mod(TORCH, "autopilot.trainer").emit_candidate(
            store, "c", {"LeastRequested": 1.2})
        ok, info = ctl._replay_verdict("c")
        assert seen == [sched.device, sched.device]
        assert info["candidate"]["placed"] == info["candidate"]["total"]
    finally:
        sched.close()


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_debug_autopilot_serves_the_jax_json():
    p = Pilot()
    servers = {}
    try:
        for pkg, s in p.side.items():
            hs = mod(pkg, "cli.kube_scheduler").HealthServer(
                lambda s=s: s.sched)
            servers[pkg] = hs
        # nothing attached yet on a fresh scheduler: 404
        for pkg, s in p.side.items():
            s.sched.autopilot = None
        assert p.each(lambda s: _get(servers[s.pkg].port,
                                     "/debug/autopilot")) == (
            404, "no autopilot controller attached\n")
        for s in p.side.values():
            s.sched.autopilot = s.ctl
        p.emit("cand", {"LeastRequested": 1.2})
        p.start("cand")
        p.rounds(3, "gate")
        p.step()
        status = p.each(lambda s: untimed(
            _get(servers[s.pkg].port, "/debug/autopilot")))
        assert status[0] == 200
        st = status[1]
        assert st["state"] == "watching" and st["candidate"] == "cand"
        assert st["watch"]["rounds_left"] == 2
        assert st["config"]["watch_rounds"] == 2
        assert [h["state"] for h in st["history"]] == [
            "shadowing", "replaying", "promoted", "watching"]
    finally:
        for hs in servers.values():
            hs.stop()
        p.close()


# -- the CLI ----------------------------------------------------------------------


def _cli(pkg, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = mod(pkg, "cli.autopilot").main(argv, **device_kw(pkg))
    return rc, out.getvalue(), err.getvalue()


def test_the_cli_train_then_replay_round_trip(tmp_path):
    ledger = str(tmp_path / "rounds.jsonl")
    _write(ledger, _planted(24))

    def run(pkg):
        out = str(tmp_path / f"{pkg}.json")
        rc, _, err = _cli(pkg, ["train", "--ledger", ledger, "--out", out,
                                "--name", "trained"])
        with open(out, "rb") as f:
            text = f.read()
        rc2, stdout, _ = _cli(pkg, ["replay", "--profiles", out, "--name",
                                    "trained", "--nodes", "3", "--wave", "8",
                                    "--slo-scale", "4.0",
                                    "--compare-baseline"])
        verdicts = [untimed(json.loads(x)) for x in stdout.splitlines()]
        return rc, err.replace(out, "OUT"), text, rc2, verdicts
    rc, err, text, rc2, verdicts = both(run)
    assert rc == 0 and rc2 == 0
    assert "24 scored rounds" in err
    table = json.loads(text)
    assert table[0]["name"] == "trained" and table[0]["role"] == "candidate"
    assert [v["name"] for v in verdicts] == ["baseline", "trained"]
    assert all(v["passed"] for v in verdicts)


def test_the_cli_refusals_are_the_jax_ones(tmp_path):
    short = str(tmp_path / "short.jsonl")
    _write(short, _planted(3))
    profiles = str(tmp_path / "p.json")
    _write(profiles, [json.dumps([{"name": "a", "weights": {
        "LeastRequested": 1.0}, "role": "candidate"}])])

    def run(pkg):
        return (_cli(pkg, ["train", "--ledger", short]),
                _cli(pkg, ["replay", "--profiles", profiles, "--name",
                           "nope"]))
    (train, replay) = both(run)
    assert train[0] == 1 and "scored rounds" in train[2]
    assert replay[0] == 1 and "no profile named 'nope'" in replay[2]
