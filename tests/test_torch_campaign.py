"""The port's chaos campaign (kubernetes_tpu_torch/chaos/campaign.py and
chaos/__main__.py) against the JAX package's, on the CPU.

Each case runs the same seed through both packages: the schedule space
and the sampler are the JAX ones; a replay of a seeded schedule gives
the same violation, placements, checks, hits per point and digest (pod
uids stripped: they come from a process-wide counter); a seeded
campaign is clean in both, schedule by schedule; both broken builds
(`_gang_rollback_enabled` and `_journal_replay_enabled` off,
tests/test_campaign.py:300-365 and tests/test_outage.py:445-490) are
caught, shrink to JAX's minimal schedule and re-trigger from its env
string, while the healthy build tolerates the same schedules. Without a
card, `device=None` raises, and the CLI reads KTPU_TORCH_FAULTPOINTS.

JAX runs here with `jax.device_put` copying its host planes. On the CPU
it may alias them, and its kernels run asynchronously, so a
`snapshot.write` corruption of a host row races the kernel that reads
it: the broken gang-rollback build at seed 7 is then caught in most
first replays of a process and raises KeyError in others (ROADMAP.md
queue 3). With the copy, as in the port, whose upload copies, the
outcome is fixed; the lockstep holds the port to that.
"""

import dataclasses
import random
import re

import pytest
import torch

from kubernetes_tpu.chaos import __main__ as jmain
from kubernetes_tpu.chaos import campaign as jc
from kubernetes_tpu_torch.chaos import __main__ as tmain
from kubernetes_tpu_torch.chaos import campaign as tc
from kubernetes_tpu_torch.utils import faultpoints

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)

CAMPAIGN_SEED = 3
# sample_schedule(random.Random(s)) for these s covers every SAMPLABLE
# point at least once (held by test_the_cover_seeds_cover_every_point)
COVER_SEEDS = (0, 1, 2, 3, 5, 9, 10, 11, 16)
_UID = re.compile(r"uid-\d+")


@pytest.fixture(autouse=True)
def jax_device_put_copies(monkeypatch):
    import jax
    import numpy as np

    real = jax.device_put

    def copying(x, *a, **kw):
        return real(jax.tree_util.tree_map(
            lambda v: np.array(v, copy=True)
            if isinstance(v, np.ndarray) else v, x), *a, **kw)
    monkeypatch.setattr(jax, "device_put", copying)


def strip(x):
    """x with every pod uid masked, recursively."""
    if isinstance(x, str):
        return _UID.sub("uid-*", x)
    if isinstance(x, dict):
        return {strip(k): strip(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [strip(v) for v in x]
    return x


def outcome(o) -> dict:
    return dict(violation=o.violation, detail=strip(o.detail),
                digest=strip(o.digest), injected=dict(o.injected),
                placed=o.placed, checks=o.checks)


def specs(side, schedule):
    """One package's FaultSpecs for a schedule of plain tuples."""
    return [side.FaultSpec(*s) for s in schedule]


def plain(schedule):
    return [dataclasses.astuple(s) for s in schedule]


def both_replay(schedule, seed, **kw):
    j = jc.replay(specs(jc, schedule), seed, **kw)
    t = tc.replay(specs(tc, schedule), seed, device="cpu", **kw)
    return outcome(j), outcome(t)


# -- the schedule space -------------------------------------------------------


def test_the_schedule_space_is_the_jax_one():
    assert tc.SAMPLABLE == jc.SAMPLABLE
    assert tc.NASTY_PAIRS == jc.NASTY_PAIRS
    assert tc._LATENCY_ARGS == jc._LATENCY_ARGS
    points = {p for p, _ in tc.SAMPLABLE}
    assert points <= faultpoints.registered_points()
    for a, b in tc.NASTY_PAIRS:
        for point, mode in (a, b):
            assert mode in dict(tc.SAMPLABLE)[point]


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 42])
def test_the_sampler_draws_the_jax_schedules(seed):
    rj, rt = random.Random(seed), random.Random(seed)
    for _ in range(25):
        a, b = jc.sample_schedule(rj), tc.sample_schedule(rt)
        assert plain(b) == plain(a)
        env = tc.env_string(b)
        assert env == jc.env_string(a)
        # every sampled schedule parses in the port's registry, in order
        assert [p[0] for p in faultpoints.parse(env)] == [s.point for s in b]
        assert [s.token() for s in b] == [s.token() for s in a]


def test_the_cover_seeds_cover_every_point():
    seen = set()
    for s in COVER_SEEDS:
        seen |= {f.point for f in tc.sample_schedule(random.Random(s))}
    assert {p for p, _ in tc.SAMPLABLE} <= seen


# -- replays ------------------------------------------------------------------


@pytest.mark.parametrize("seed", COVER_SEEDS)
def test_a_seeded_schedule_replays_as_in_jax(seed):
    schedule = plain(tc.sample_schedule(random.Random(seed)))
    j, t = both_replay(schedule, CAMPAIGN_SEED)
    assert t == j
    assert t["checks"] > 0


def test_a_seeded_campaign_is_clean_and_equal_to_jax():
    logs = {"jax": [], "torch": []}
    j = jc.run_campaign(seed=CAMPAIGN_SEED, schedules=8,
                        log=logs["jax"].append)
    t = tc.run_campaign(seed=CAMPAIGN_SEED, schedules=8, device="cpu",
                        log=logs["torch"].append)
    assert t.ok and j.ok, [f.outcome.detail for f in t.findings]
    assert t.schedules == j.schedules == 8
    assert (t.checks_total, t.injected_total) == \
        (j.checks_total, j.injected_total)
    assert t.checks_total > 0 and t.injected_total > 0
    # schedule by schedule: the same env string and the same status
    assert logs["torch"] == logs["jax"] and len(logs["torch"]) == 8


def test_the_budget_stops_sampling_early():
    res = tc.run_campaign(seed=5, schedules=50, budget_s=0.0, device="cpu")
    assert res.schedules < 50


# -- the broken builds --------------------------------------------------------


def _no_gang_rollback(sched):
    sched._gang_rollback_enabled = False


def _no_journal_replay(sched):
    sched._journal_replay_enabled = False


BROKEN = {
    # snapshot.write=corrupt inflates a node row's allocatable; the next
    # heartbeat uploads it, the gang kernel over-proposes and the exact
    # recheck fails mid-commit: without the rollback, assumed members
    # leak (tests/test_campaign.py:309-345)
    "gang_rollback": (_no_gang_rollback,
                      [("snapshot.write", "corrupt", 0.0, 4, 0)],
                      ("conservation", "gang_atomic"),
                      "snapshot.write=corrupt::1", 1),
    # three bind-POST failures trip the store breaker and the fourth
    # darkens the truth GET, so the intent spools; without the drain and
    # the replay it outlives the outage (tests/test_outage.py:445-490)
    "journal_replay": (_no_journal_replay,
                       [("store.outage", "raise", 0.0, 6, 0)],
                       ("conservation",), "store.outage=raise::4", 4),
}


@pytest.mark.parametrize("build", sorted(BROKEN))
def test_a_broken_build_is_caught_shrunk_and_retriggered_as_in_jax(build):
    configure, schedule, names, minimal_env, min_hits = BROKEN[build]
    j, t = both_replay(schedule, 7, configure=configure)
    assert t == j
    assert t["violation"] in names and t["digest"]
    if build == "journal_replay":
        assert "outlived the outage" in t["detail"]

    jmin, jmo = jc.shrink(specs(jc, schedule), 7, configure=configure)
    tmin, tmo = tc.shrink(specs(tc, schedule), 7, configure=configure,
                          device="cpu")
    assert plain(tmin) == plain(jmin)
    assert outcome(tmo) == outcome(jmo) and tmo.violated
    env = tc.env_string(tmin)
    assert env == minimal_env == jc.env_string(jmin)

    ja = jc.replay((), 7, env_spec=env, configure=configure)
    ta = tc.replay((), 7, env_spec=env, configure=configure, device="cpu")
    assert outcome(ta) == outcome(ja)
    assert ta.violated
    assert ta.injected[tmin[0].point] >= min_hits


@pytest.mark.parametrize("build", sorted(BROKEN))
def test_the_healthy_build_tolerates_the_broken_builds_schedule(build):
    _, schedule, _, _, _ = BROKEN[build]
    j, t = both_replay(schedule, 7)
    assert t == j
    assert t["violation"] is None and t["checks"] > 0
    assert t["injected"][schedule[0][0]] >= 1


def test_a_broken_build_that_reassumes_a_leaked_member_raises_as_in_jax():
    """Reference behaviour: at seed 3 the broken build's leaked gang
    member is assumed again by a later gang commit, and the cache's
    KeyError leaves replay (which turns only an InvariantViolation into
    an outcome) in both packages."""
    schedule = BROKEN["gang_rollback"][1]
    with pytest.raises(KeyError, match="already in cache"):
        jc.replay(specs(jc, schedule), 3, configure=_no_gang_rollback)
    with pytest.raises(KeyError, match="already in cache"):
        tc.replay(specs(tc, schedule), 3, configure=_no_gang_rollback,
                  device="cpu")


@pytest.mark.parametrize("seed", [9, 17, 25, 35, 42])
def test_a_sampled_snapshot_write_corruption_replays_as_in_jax(seed):
    """Sampled schedules that corrupt snapshot rows (each seed's first
    schedule holds snapshot.write=corrupt): the corrupted row reaches the
    device with the next upload in both packages."""
    schedule = plain(tc.sample_schedule(random.Random(seed)))
    assert ("snapshot.write", "corrupt") in [s[:2] for s in schedule]
    j, t = both_replay(schedule, CAMPAIGN_SEED)
    assert t == j
    assert t["injected"]["snapshot.write"] >= 1


# -- the card and the CLI -----------------------------------------------------


def test_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = [tc.FaultSpec("kernel.wave", "raise")]
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.replay(spec, 7)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.run_campaign(seed=7, schedules=1, budget_s=0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.shrink(spec, 7)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["--seed", "7", "--schedules", "1"])
    assert not faultpoints.active()


def test_the_cli_repro_reads_the_ports_variable(monkeypatch, capsys):
    env = "snapshot.write=corrupt::1,watch.deliver=latency:0.005:2"
    monkeypatch.setenv("KTPU_FAULTPOINTS", env)
    assert jmain.main(["--repro", "--seed", "7"]) == 0
    want = capsys.readouterr().out
    monkeypatch.setenv("KTPU_TORCH_FAULTPOINTS", env)
    assert tmain.main(["--repro", "--seed", "7"], device="cpu") == 0
    got = capsys.readouterr().out
    assert strip(got) == strip(want)
    assert "fired={'snapshot.write': 1, 'watch.deliver': 2}" in got
    assert got.splitlines()[-1] == "clean"
    # the spec is consumed: a second --repro has nothing to replay
    assert tmain.main(["--repro", "--seed", "7"], device="cpu") == 2
    assert "KTPU_TORCH_FAULTPOINTS" in capsys.readouterr().err


def test_a_two_schedule_cli_campaign_exits_0_as_in_jax(capsys):
    assert jmain.main(["--seed", "3", "--schedules", "2"]) == 0
    want = capsys.readouterr().out
    assert tmain.main(["--seed", "3", "--schedules", "2"],
                      device="cpu") == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[-1].startswith(
        "campaign seed=3: 2 schedules, ")
    assert got.splitlines()[-1].endswith("0 violation(s)")
