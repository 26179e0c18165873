"""The port's flight recorder, decision observatory, live WeightProfiles
and shadow scoring against the JAX Scheduler's, with each package's own
recorder enabled, in lockstep scenarios (torch_parity.Both).

After every `run()` a scenario compares, between the two packages:

  * the round ledger rows, every key but the timings (`ts`, `wall_s`,
    the span seconds) and `path` ("cuda" / "torch-cpu" against the JAX
    "xla"), and the names of each row's stage spans;
  * the decisions (`rec.decision(uid)` of every pod), the instant
    events other than `jit_compile` (whose hit/miss depends on what the
    process ran before) and the pod spans less their times;
  * `weightbook.report(name)` of every profile loaded and its summary;
  * the SCHED_METRICS and the series these modules feed (TRACE_METRICS);
  * the dispatches counted a program and the bucket labels seen.

The scenarios: a pipeline round, the per-wave loop (a host filter sends
the pass back), a gang, preemption, a multi-key host-path pod (the
golden coverage gap), a hot swap, a rollback and a rejected bad profile,
and shadow_exact_interval=1 with a candidate that flips. Then, with
tracing off: no decomposition is built and device_fetch_bytes equals
the JAX scheduler's. And the bind a second writer wins (CONFIRMED).
"""

import numpy as np
import pytest

from kubernetes_tpu.ops.scores import SCORE_STACK
from kubernetes_tpu.plugins.registry import default_profile as jax_default
from kubernetes_tpu.runtime.store import Conflict as JaxConflict
from kubernetes_tpu.sched import weights as jweights
from kubernetes_tpu.utils import tracing as jtracing
from kubernetes_tpu_torch.ops import kernel as tkernel
from kubernetes_tpu_torch.runtime.store import Conflict as TorchConflict
from kubernetes_tpu_torch.sched import weights as tweights
from kubernetes_tpu_torch.utils import tracing as ttracing

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)
from torch_parity import Both
from torch_worlds import GCE_PD, bindings, multikey_affinity, volume_pod

TRACING = {"jax": jtracing, "torch": ttracing}
# ledger keys that hold wall-clock times, and the backend name
TIMING_KEYS = ("ts", "wall_s", "spans", "path")
# the series the recorder, the decomposition, the shadow pass and the
# telemetry feed
TRACE_METRICS = ("score_margin", "score_priority_points",
                 "shadow_divergence", "shadow_scored_pods",
                 "shadow_margin_delta", "cluster_requested",
                 "cluster_allocatable", "cluster_free_largest",
                 "cluster_fragmentation", "feasibility_headroom",
                 "zone_utilization", "device_fetch_bytes")


@pytest.fixture(autouse=True)
def recorders_off():
    for mod in TRACING.values():
        mod.disable()
    yield
    for mod in TRACING.values():
        mod.disable()


def _api(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.api.types")


def profile(pkg, name, weights, role="candidate"):
    api = _api(pkg)
    return api.WeightProfile(
        metadata=api.ObjectMeta(name=name),
        spec=api.WeightProfileSpec(weights=dict(weights), role=role))


def prod_table():
    """The default weights as a WeightProfile table (every non-zero
    plane), which is the table of a `live` profile equal to them."""
    vec = jweights.stack_weights(jax_default().weights())
    return {n: float(vec[s]) for s, n in enumerate(SCORE_STACK)
            if jweights.WEIGHT_FIELDS[n] is not None and vec[s]}


def jit_state(metrics):
    """(dispatches a program, bucket labels seen a program): the
    device_jit_events series without the hit/miss split."""
    totals, buckets = {}, set()
    for (program, bucket, _event), c in \
            metrics.device_jit_events._children.items():
        totals[program] = totals.get(program, 0) + c.value
        buckets.add((program, bucket))
    return totals, buckets


def trace_metrics(metrics):
    out = {}
    for name in TRACE_METRICS:
        m = getattr(metrics, name)
        if hasattr(m, "counts"):
            out[name] = (m.total, m.sum, tuple(m.counts), m.max)
        elif hasattr(m, "children"):
            out[name] = {c.name: c.value for c in m.children()}
        else:
            out[name] = m.value
    return out


def ledger_view(rows):
    return [({k: v for k, v in r.items() if k not in TIMING_KEYS},
             sorted(r.get("spans", {}))) for r in rows]


def trace_view(rec):
    """The recorder's events (less jit_compile) and pod spans, less
    their times, round by round."""
    out = []
    for rt in list(rec.rounds) + [rec.background]:
        out.append((rt.rid, rt.kind,
                    [(e.name, e.args) for e in rt.events
                     if e.name != "jit_compile"],
                    [(p.uid, p.name, p.args) for p in rt.pod_spans]))
    return out


class Traced(Both):
    """Both, with each package's recorder enabled, comparing what the
    recorders and the weight books hold after every run()."""

    def __init__(self, *a, ledger_dir=None, sched_kw=None, **kw):
        self.rec = {}
        for side, mod in TRACING.items():
            path = (str(ledger_dir / f"{side}.jsonl")
                    if ledger_dir is not None else None)
            self.rec[side] = mod.enable(ledger_path=path)
        super().__init__(*a, **kw)
        if sched_kw:
            for s in self.sched.values():
                for k, v in sched_kw.items():
                    setattr(s, k, v)

    def check(self):
        super().check()
        j, t = self.sched["jax"], self.sched["torch"]
        jr, tr = self.rec["jax"], self.rec["torch"]
        assert ledger_view(tr.ledger_rows()) == ledger_view(jr.ledger_rows())
        assert dict(tr.decisions) == dict(jr.decisions)
        assert trace_view(tr) == trace_view(jr)
        assert trace_metrics(t.metrics) == trace_metrics(j.metrics)
        assert jit_state(t.metrics) == jit_state(j.metrics)
        names = set(j.weightbook.index()["profiles"])
        assert set(t.weightbook.index()["profiles"]) == names
        for name in names:
            assert t.weightbook.report(name) == j.weightbook.report(name)
        assert t.weightbook.summary() == j.weightbook.summary()
        assert t.weightbook.live_version() == j.weightbook.live_version()

    def rows(self):
        return self.rec["torch"].ledger_rows()

    def profile(self, name, weights, role="candidate"):
        self.create("weightprofiles",
                    lambda pkg: profile(pkg, name, weights, role))

    def set_role(self, name, role):
        for store in self.stores.values():
            wp = store.get("weightprofiles", "default", name)
            wp.spec.role = role
            store.update("weightprofiles", wp)

    def drop_profile(self, name):
        for store in self.stores.values():
            store.delete("weightprofiles", "default", name)


def skewed(b):
    """Three 8-core nodes with 6, 3 and 0 cores bound: the defaults pick
    the emptiest, a MostRequested candidate strictly the fullest."""
    for i, used in enumerate((6, 3, 0)):
        b.node(f"n{i}", cpu="8", memory="32Gi")
        if used:
            b.pod(f"f{i}", cpu=str(used), node_name=f"n{i}")


def test_pipeline_round_records_equal(tmp_path):
    """A traced pipeline round with a flipping candidate: ledger (also
    as JSONL on disk), decisions, shadow report and metrics equal."""
    b = Traced(ledger_dir=tmp_path)
    skewed(b)
    b.profile("packer", {"MostRequested": 1.0})
    for k in range(40):
        b.pod(f"p{k}", cpu="100m", memory="128Mi")
    assert b.run() == 40
    rows = b.rows()
    ok = [r for r in rows if r["kind"] == "pipeline"]
    assert ok and all(r["v"] == 2 and r["weights_version"] == "static"
                      and r["telemetry"]["backend"] == "device"
                      for r in ok)
    assert ok[0]["shadow"]["packer"]["flips"] >= 1
    assert len(b.rec["torch"].decisions) == 40
    files = [[{k: v for k, v in __import__("json").loads(line).items()
               if k not in TIMING_KEYS}
              for line in (tmp_path / f"{side}.jsonl").read_text()
              .splitlines()] for side in ("jax", "torch")]
    assert files[1] == files[0] and len(files[1]) == len(rows)


def test_per_wave_loop_records_equal():
    """Pods whose inline disks collide with bound pods' make the host
    filter reject nodes, so the pipeline hands its pass back and the
    per-wave loop places them: the wave rounds' records equal."""
    b = Traced(n_nodes=4, cpu="8", memory="32Gi")
    b.profile("packer", {"MostRequested": 2.0, "LeastRequested": 0.0})
    for i in range(3):
        b.create("pods", lambda pkg, i=i: volume_pod(
            pkg, f"h{i}", disks=[(GCE_PD, f"pd-{i}", False)], cpu="1",
            node_name=f"n{i}"))
    for k in range(6):
        b.create("pods", lambda pkg, k=k: volume_pod(
            pkg, f"d{k}", disks=[(GCE_PD, f"pd-{k % 3}", False)],
            cpu="200m"))
    for k in range(10):
        b.pod(f"p{k}", cpu="300m")
    b.run()
    kinds = {r["kind"] for r in b.rows()}
    assert "wave" in kinds
    wave = [r for r in b.rows() if r["kind"] == "wave"
            and r.get("outcome") == "ok"]
    assert wave and all("scores" in r and "telemetry" in r for r in wave)


def test_gang_records_equal():
    """A gang of 4 that fits and one that cannot: gang rounds, the
    gang_failed event and the gang_wait span equal."""
    b = Traced(n_nodes=4, cpu="4", memory="16Gi")
    b.group("g", 4)
    for k in range(4):
        b.pod(f"g-{k}", cpu="2", gang="g")
    b.group("big", 4)
    for k in range(4):
        b.pod(f"big-{k}", cpu="3", gang="big")
    b.run()
    assert b.bound("g") == 4
    gang = [r for r in b.rows() if r["kind"] == "gang"]
    assert {r.get("outcome") for r in gang} >= {"ok", "gang_unplaceable"}


def test_preemption_records_equal():
    """Low-priority pods fill the nodes; high-priority pods preempt
    them: preemption events, the what-if events and the ledger equal."""
    b = Traced(n_nodes=3, cpu="4", memory="16Gi")
    for k in range(6):
        b.pod(f"low-{k}", cpu="2", priority=1)
    b.run()
    for k in range(3):
        b.pod(f"hi-{k}", cpu="2", priority=1000)
    b.run()
    b.advance(5)
    b.run()
    events = [e for _rid, _kind, evs, _spans in trace_view(b.rec["torch"])
              for e in evs]
    assert any(name == "preemption" for name, _ in events)
    assert any(name == "preempt_whatif" for name, _ in events)


def test_golden_gap_records_equal():
    """A pod whose required affinity spans two topology keys takes the
    exact host path: the round's `golden` gap, the host_wave span and
    the live interpod weight equal."""
    b = Traced()
    for i in range(4):
        b.node(f"n{i}", cpu="8", memory="32Gi", zone=f"z{i % 2}")
    b.pod("anchor", cpu="100m", labels={"app": "db", "tier": "cache"},
          node_name="n1")
    b.run()
    b.pod("mk", cpu="100m", affinity=multikey_affinity())
    for k in range(5):
        b.pod(f"p{k}", cpu="100m")
    b.run()
    assert bindings(b.stores["torch"])["mk"] == "n1"
    golden = [r for r in b.rows() if r.get("golden")]
    assert golden and golden[0]["golden"] == {"multi_tk": 1}


def test_hot_swap_rollback_and_bad_profile():
    """A live profile equal to the defaults, a rejected table (the old
    one stays), a promotion of the candidate (the next round places as
    the shadow predicted), a rollback by delete: weights_version and
    every record equal at each step."""
    b = Traced()
    skewed(b)
    b.profile("same", prod_table(), role="live")
    b.profile("packer", {"MostRequested": 1.0})
    b.profile("oops", {"NoSuchPriority": 1.0}, role="live")
    ver = b.sched["torch"].weightbook.live_version()
    assert ver.startswith("same@")
    b.pod("p1", cpu="100m")
    b.run()
    assert bindings(b.stores["torch"])["p1"] == "n2"
    predicted = b.rows()[-1]["shadow"]["packer"]["flips_sample"][0]["to"]
    b.set_role("packer", "live")
    assert b.sched["torch"].weightbook.live_version().startswith("packer@")
    b.delete("p1")
    b.pod("p2", cpu="100m")
    b.run()
    assert bindings(b.stores["torch"])["p2"] == predicted
    assert b.rows()[-1]["weights_version"].startswith("packer@")
    b.drop_profile("packer")
    b.drop_profile("same")
    assert b.sched["torch"].weightbook.live_version() == "static"
    b.delete("p2")
    b.pod("p3", cpu="100m")
    b.run()
    assert bindings(b.stores["torch"])["p3"] == "n2"
    assert b.rows()[-1]["weights_version"] == "static"


def test_exact_shadow_sample_flipping_candidate():
    """shadow_exact_interval=1: the first wave of every traced round is
    replayed under each candidate; a production-equal candidate flips
    nothing, a packer flips."""
    b = Traced(sched_kw={"shadow_exact_interval": 1})
    skewed(b)
    b.profile("packer", {"MostRequested": 1.0})
    b.profile("twin", prod_table())
    for k in range(20):
        b.pod(f"p{k}", cpu="100m")
    b.run()
    summary = b.sched["torch"].weightbook.summary()
    assert summary["packer"]["exact"]["flips"] >= 1
    assert summary["twin"]["exact"]["flips"] == 0
    assert any((r.get("shadow") or {}).get("packer", {}).get("exact")
               for r in b.rows())


def test_tracing_off_builds_no_deco_and_fetches_as_jax(monkeypatch):
    """Untraced, the round and the wave build no decomposition and
    device_fetch_bytes equals the JAX scheduler's; the ledger is
    empty because no recorder is on."""
    seen = []
    real = tkernel._wave_body

    def spy(*a, **kw):
        res, usage = real(*a, **kw)
        seen.append((kw.get("collect_scores", False), res.deco))
        return res, usage

    monkeypatch.setattr(tkernel, "_wave_body", spy)
    b = Both(n_nodes=3, cpu="4", memory="16Gi")
    for k in range(20):
        b.pod(f"p{k}", cpu="500m")
    b.create("pods", lambda pkg: volume_pod(
        pkg, "d0", disks=[(GCE_PD, "pd-0", False)], cpu="100m"))
    b.run()
    assert seen and all(not c and d is None for c, d in seen)
    assert (b.sched["torch"].metrics.device_fetch_bytes.value
            == b.sched["jax"].metrics.device_fetch_bytes.value > 0)
    assert jit_state(b.sched["torch"].metrics) == jit_state(
        b.sched["jax"].metrics)


def test_bind_won_by_another_writer_is_confirmed(monkeypatch):
    """The store binds the pod to another node and then answers
    Conflict: both packages adopt the binding the store holds (the cache
    and the snapshot row move to that node), do not requeue or park the
    pod, and count it scheduled."""
    b = Both(n_nodes=3, cpu="4", memory="16Gi")
    conflicts = {"jax": JaxConflict, "torch": TorchConflict}
    for side, store in b.stores.items():
        real = store.bind

        def hooked(pod, node_name, real=real, side=side):
            if pod.metadata.name == "p1":
                # the other writer binds it to another node first
                won[side] = "n0" if node_name != "n0" else "n1"
                real(pod, won[side])
                raise conflicts[side]("already bound")
            return real(pod, node_name)

        monkeypatch.setattr(store, "bind", hooked)
    won = {}
    b.pod("p0", cpu="500m")
    b.pod("p1", cpu="1")
    b.pod("p2", cpu="500m")
    b.run()
    assert won["torch"] == won["jax"]
    assert bindings(b.stores["torch"])["p1"] == won["torch"]
    j, t = b.sched["jax"], b.sched["torch"]
    for s in (j, t):
        assert s.queue.pending_count() == 0
    got = {side: {n: sorted(p.metadata.name for p in ni.pods)
                  for n, ni in s.cache.node_infos.items()}
           for side, s in (("jax", j), ("torch", t))}
    assert got["torch"] == got["jax"]
    assert "p1" in got["torch"][won["torch"]]
    for s in (j, t):
        slot = s.snapshot.pod_slot["p1"]
        assert (s.snapshot.node_names[int(s.snapshot.ep_node[slot])]
                == won["torch"])
    np.testing.assert_array_equal(t.snapshot.requested[:3],
                                  j.snapshot.requested[:3])
    b.pod("p3", cpu="1")
    b.run()


# -- the WeightBook cases of tests/test_shadow.py, in both packages ------------


PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")


def _pkg(pkg, mod):
    import importlib

    return importlib.import_module(f"{pkg}.{mod}")


def _book(pkg):
    weights = _pkg(pkg, "sched.weights")
    registry = _pkg(pkg, "plugins.registry")
    return weights, weights.WeightBook(registry.default_profile().weights())


@pytest.mark.parametrize("pkg", PKGS)
class TestProfileVector:
    def test_stack_alignment_and_hostextra_pinned(self, pkg):
        w = _pkg(pkg, "sched.weights")
        stack = _pkg(pkg, "ops.scores").SCORE_STACK
        vec = w.profile_vector({"LeastRequested": 2.0, "MostRequested": 3.5})
        assert vec.dtype == np.float32
        assert vec[stack.index("LeastRequested")] == 2.0
        assert vec[stack.index("MostRequested")] == 3.5
        assert vec[stack.index("BalancedAllocation")] == 0.0
        assert vec[stack.index("HostExtra")] == 1.0

    def test_unknown_priority_raises(self, pkg):
        with pytest.raises(ValueError, match="MostRequsted"):
            _pkg(pkg, "sched.weights").profile_vector({"MostRequsted": 1.0})

    def test_hostextra_reweight_rejected(self, pkg):
        w = _pkg(pkg, "sched.weights")
        stack = _pkg(pkg, "ops.scores").SCORE_STACK
        with pytest.raises(ValueError, match="HostExtra"):
            w.profile_vector({"HostExtra": 0.0})
        assert w.profile_vector({"HostExtra": 1.0})[
            stack.index("HostExtra")] == 1.0

    def test_gate_raises_only_inactive_planes(self, pkg):
        w = _pkg(pkg, "sched.weights")
        base = _pkg(pkg, "plugins.registry").default_profile().weights()
        assert base.most_requested == 0.0
        vec = w.profile_vector({"MostRequested": 2.0, "LeastRequested": 9.0})
        gated = w.gate_weights(base, vec)
        assert gated.most_requested == 1.0
        assert gated.least_requested == base.least_requested
        assert w.gate_weights(base) is base
        assert w.gate_weights(base, w.stack_weights(base)) is base


@pytest.mark.parametrize("pkg", PKGS)
class TestWeightBook:
    def test_live_selection_and_version(self, pkg):
        w, book = _book(pkg)
        stack = _pkg(pkg, "ops.scores").SCORE_STACK
        assert book.live_version() == "static"
        a = profile(pkg, "a", {"MostRequested": 1.0})
        a.metadata.resource_version = 5
        book.on_profile(a)
        assert book.live_version() == "static"
        b = profile(pkg, "b", {"LeastRequested": 2.0}, role="live")
        b.metadata.resource_version = 7
        book.on_profile(b)
        assert book.live_version() == "b@7"
        assert book.live_vector()[stack.index("LeastRequested")] == 2.0
        c = profile(pkg, "c", {"MostRequested": 4.0}, role="live")
        c.metadata.resource_version = 9
        book.on_profile(c)
        assert book.live_version() == "c@9"
        assert "c" not in book.candidate_vectors()
        assert {"a", "b"} <= set(book.candidate_vectors())

    def test_rollback_and_delete(self, pkg):
        w, book = _book(pkg)
        live = profile(pkg, "l", {"MostRequested": 1.0}, role="live")
        live.metadata.resource_version = 3
        book.on_profile(live)
        assert book.live_version() == "l@3"
        book.rollback()
        assert book.live_version() == "static"
        np.testing.assert_array_equal(book.live_vector(),
                                      w.stack_weights(book._defaults))
        book.on_profile_delete(live)
        assert "l" not in book.candidate_vectors()

    def test_load_entries_and_declared_labels(self, pkg):
        w, book = _book(pkg)
        n = book.load_entries(
            [{"name": f"p{i}", "weights": {"LeastRequested": float(i)}}
             for i in range(10)])
        assert n == 10
        declared = book.declared_labels()
        assert len(declared) == 8 and declared[0] == "p0"


def test_f32_totals_and_flip_text_match_jax():
    """The host re-add in SCORE_STACK order and the flip line are the JAX
    package's, on random parts."""
    rng = np.random.RandomState(7)
    vec = rng.rand(len(SCORE_STACK)).astype(np.float32) * 3
    parts = (rng.rand(len(SCORE_STACK), 5) * 10).astype(np.float32)
    np.testing.assert_array_equal(
        tweights._f32_totals(vec, parts).view(np.int32),
        jweights._f32_totals(vec, parts).view(np.int32))
    flip = {"pod": "default/p", "from": "n0", "to": "n1",
            "priority": "MostRequested", "prod": 1.0, "cand": 2.5}
    assert tweights.flip_text(flip) == jweights.flip_text(flip)
