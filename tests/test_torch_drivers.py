"""The rest of bench.py's DRIVER_SUITE on kubernetes_tpu_torch's
Scheduler against the JAX Scheduler, on a virtual clock.

- trickle and paced (bench.py run_trickle_config / run_paced_config,
  cut to 16 nodes): a warm-up through `warm_pipeline`, a fresh Metrics,
  then chunks of bench.py's pods arriving between drains;
- preempt_host (run_preempt_config with device_preemption = False, wave
  16): hogs fill the nodes, then vips place only by evicting them, the
  batched what-if running through the numpy twin in both packages.

After every drain both packages hold the same bindings, nominations,
queue, pipeline preemptions and scheduler metrics (torch_parity.Both,
SCHED_METRICS: counts, sums, buckets and label sets). Also: the port's
Metrics renders the JAX registry's exposition text; warm_pipeline leaves
the live state as it was; device_preemption is a switch, not a
fallback.
"""

import types

import numpy as np
import pytest

from kubernetes_tpu.cli.kube_scheduler import HealthServer
from kubernetes_tpu.utils import metrics as jmetrics
from kubernetes_tpu.utils.backoff import PodBackoff as JaxBackoff
from kubernetes_tpu_torch.ops.encoding import Caps
from kubernetes_tpu_torch.runtime.store import ObjectStore
from kubernetes_tpu_torch.sched import scheduler as tsched
from kubernetes_tpu_torch.utils import metrics as tmetrics
from kubernetes_tpu_torch.utils.backoff import PodBackoff as TorchBackoff

from torch_guard import jax_watchdog_off, torch_one_thread  # noqa: F401
from torch_parity import Both
from torch_worlds import (FakeClock, bench_node, bench_pod, bindings,
                          ipa_store_world)

NODES = 16
WAVE = 16


# --- the metrics registry --------------------------------------------------------


def _exposition(registry) -> str:
    """The JAX scheduler's /metrics text (cli/kube_scheduler.py
    HealthServer.metrics_text) for one registry."""
    fake = types.SimpleNamespace(
        scheduler_ref=lambda: types.SimpleNamespace(metrics=registry))
    return HealthServer.metrics_text(fake)


def _script(m, case):
    """One scripted sequence of observations on a registry `m`."""
    if case == "histograms":
        for v in (0.0, 0.0004, 0.001, 0.0015, 0.3, 2.5, 17.0, 600.0, 1e4):
            m.pod_scheduling_latency.observe(v)
            m.e2e_scheduling_latency.observe(v / 3)
        m.gang_wait_seconds.observe(0.25)
    elif case == "counters":
        m.pods_scheduled.inc()
        m.pods_scheduled.inc(41)
        m.schedule_attempts.inc(0.5)
        m.pod_preemption_victims.inc(3)
    elif case == "labeled":
        m.waves_total.labels(path="device").inc(7)
        m.waves_total.labels(path="host").inc()
        for reason in ("PodFitsResources", "MatchInterPodAffinity",
                       "a reason no predicate has"):
            m.unschedulable_reasons.labels(predicate=jmetrics.bounded_label(
                reason, ("PodFitsResources", "MatchInterPodAffinity"))).inc()
        m.scheduling_errors.labels(stage="bind").inc()
        m.scheduling_errors.labels(stage="dispatch", device="cuda:0").inc(2)
    elif case == "gauges":
        m.pending_pods.labels(queue="active").set(12)
        m.pending_pods.labels(queue="backoff").inc(3)
        m.pending_pods.labels(queue="backoff").dec()
        m.zone_utilization.labels(zone="z1", resource="cpu").set(0.5)
        m.zone_utilization.remove(zone="z1", resource="cpu")
        m.breaker_state.set(2)
    elif case == "reservoir":
        # past the reservoir: Vitter's sampling with the fixed LCG
        for i in range(m.pod_scheduling_latency.RESERVOIR + 4000):
            m.pod_scheduling_latency.observe((i * 7919 % 10007) / 1000.0)


@pytest.mark.parametrize("case", ["histograms", "counters", "labeled",
                                  "gauges", "reservoir"])
def test_metrics_exposition_matches_jax(case):
    want, got = jmetrics.Metrics(), tmetrics.Metrics()
    _script(want, case)
    _script(got, case)
    assert _exposition(got) == _exposition(want)
    for q in (0.5, 0.9, 0.99):
        assert (got.pod_scheduling_latency.quantile(q)
                == want.pod_scheduling_latency.quantile(q))
    assert sorted(got.all_series()) == sorted(want.all_series())


def test_metrics_declare_the_same_label_sets():
    with pytest.raises(ValueError, match="declared value set"):
        tmetrics.Metrics().feasibility_headroom.labels(shape="3c-7g")
    with pytest.raises(ValueError, match="declared value set"):
        jmetrics.Metrics().feasibility_headroom.labels(shape="3c-7g")


# --- driver shapes on a virtual clock ----------------------------------------------


def _cluster(n_nodes=NODES):
    b = Both(wave=WAVE)
    for i in range(n_nodes):
        b.create("nodes", lambda pkg, i=i: bench_node(pkg, i))
    return b


def _warm(b, n_waves=1):
    """bench.py _warmed_scheduler: warm pods created, warm_pipeline,
    deleted, and a fresh Metrics on each side."""
    names = [f"warmup-{i}" for i in range(min(WAVE, 64))]
    for name in names:
        b.create("pods", lambda pkg, name=name: bench_pod(pkg, name, "warmup"))
    for side, sched in b.sched.items():
        store = b.stores[side]
        sched.warm_pipeline([store.get("pods", "default", n) for n in names],
                            n_waves=n_waves)
    for name in names:
        b.delete(name)
    b.sched["jax"].metrics = jmetrics.Metrics()
    b.sched["torch"].metrics = tmetrics.Metrics()
    b.check()


def _offer(b, prefix, first, n, gap=0.0):
    """n of bench.py's pods arrive, `gap` virtual seconds apart."""
    for i in range(first, first + n):
        b.create("pods", lambda pkg, i=i: bench_pod(pkg, f"{prefix}-{i}",
                                                    prefix))
        b.advance(gap)


def test_trickle_matches_jax():
    """bench.py trickle, cut to 16 nodes and 48 pods in chunks of 8: each
    chunk's pods arrive 10 ms apart and are drained before the next."""
    b = _cluster()
    _warm(b)
    placed = 0
    for first in range(0, 48, 8):
        _offer(b, "trickle-pod", first, 8, gap=0.01)
        placed += b.run()
    assert placed == 48
    m = b.sched["torch"].metrics
    assert m.pod_scheduling_latency.total == 48
    assert m.pod_scheduling_latency.quantile(0.99) == pytest.approx(0.08)
    assert m.e2e_scheduling_latency.total == 6
    assert m.waves_total.value(path="device") == 6
    assert m.pods_scheduled.value == 48 and m.schedule_attempts.value == 48


def test_paced_matches_jax():
    """bench.py paced, cut to 16 nodes and 60 pods offered at 200 pods/s
    in chunks of 10; each drain starts 20 ms after its chunk lands, and
    the same stalled-drain loop follows."""
    b = _cluster()
    _warm(b)
    rate, chunk, pods = 200.0, 10, 60
    clock = b.clock["torch"]
    next_tick = clock()
    made = placed = 0
    while made < pods:
        if clock() < next_tick:
            b.advance(next_tick - clock())
        _offer(b, "paced-pod", made, chunk)
        made += chunk
        next_tick += chunk / rate
        b.advance(0.02)
        placed += b.run()
    stalled = 0
    while placed < pods and stalled <= 20:
        b.advance(0.002)
        n = b.run()
        placed += n
        stalled = stalled + 1 if n == 0 else 0
    assert placed == pods
    m = b.sched["torch"].metrics
    assert m.pod_scheduling_latency.total == pods
    assert m.pod_scheduling_latency.quantile(0.99) == pytest.approx(0.02)


def _preempt_host(b, n_nodes, vips):
    """run_preempt_config at `n_nodes`: two 8-core hogs a node at
    priority 1, a warm-up, then `vips` 8-core pods at priority 100 on
    PodBackoff(initial=0.001), the what-if on the numpy twin."""
    for side, sched in b.sched.items():
        backoff = JaxBackoff if side == "jax" else TorchBackoff
        sched.backoff = backoff(initial=0.001, clock=b.clock[side])
        sched.device_preemption = False
    for i in range(2 * n_nodes):
        b.create("pods", lambda pkg, i=i: bench_pod(pkg, f"hog-{i}", "hog",
                                                    cpu="8", priority=1))
    assert b.run() == 2 * n_nodes
    _warm(b, n_waves=min(-(-vips // WAVE), 128))
    for i in range(vips):
        b.create("pods", lambda pkg, i=i: bench_pod(pkg, f"vip-{i}", "vip",
                                                    cpu="8", priority=100))
    done = b.run()
    stalled = 0
    while done < vips and stalled <= 50:
        b.advance(0.002)
        n = b.run()
        done += n
        stalled = stalled + 1 if n == 0 else 0
    return done


def test_preempt_host_matches_jax(monkeypatch):
    """bench.py preempt_host cut to 8 nodes and 8 vips: every vip places
    by evicting one hog, every preemption is the pipeline's, and the
    port never calls the device what-if."""

    def no_device_whatif(*a, **kw):
        raise AssertionError("the device what-if ran with "
                             "device_preemption = False")

    monkeypatch.setattr(tsched, "preemption_stats", no_device_whatif)
    b = _cluster(8)
    assert _preempt_host(b, 8, 8) == 8
    store = b.stores["torch"]
    pods = {p.metadata.name: p for p in store.list("pods")}
    assert all(pods[f"vip-{i}"].spec.node_name for i in range(8))
    assert sum(n.startswith("hog-") for n in pods) == 8
    sched = b.sched["torch"]
    assert sched.pipeline_preemptions == 8
    assert sched.metrics.pod_preemption_victims.value == 8
    assert sched.metrics.total_preemption_attempts.value >= 8
    assert sched.metrics.preemption_evaluation.total >= 1


def test_failing_device_whatif_raises(monkeypatch):
    """With device_preemption on, a what-if that fails raises out of the
    drain: no silent switch to the twin."""

    def broken(*a, **kw):
        raise RuntimeError("what-if failed")

    monkeypatch.setattr(tsched, "preemption_stats", broken)
    clock = FakeClock()
    store = ObjectStore()
    sched = tsched.Scheduler(store, wave_size=WAVE, device="cpu",
                             clock=clock)
    for i in range(2):
        store.create("nodes", bench_node("kubernetes_tpu_torch", i))
    for i in range(4):
        store.create("pods", bench_pod("kubernetes_tpu_torch", f"hog-{i}",
                                       "hog", cpu="8", priority=1))
    assert sched.schedule_pending() == 4
    store.create("pods", bench_pod("kubernetes_tpu_torch", "vip", "vip",
                                   cpu="8", priority=100))
    with pytest.raises(RuntimeError, match="what-if failed"):
        sched.schedule_pending()


# --- warm-up -------------------------------------------------------------------


def _live_state(sched):
    """What the rounds read: the node tensors whole, the pod and term
    rows of live entries, the slot map, the queue and rr."""
    nt, pm, tt = sched.snapshot.host_tensors()
    out = {f"nt.{k}": v.copy() for k, v in nt._asdict().items()}
    for name, tab in (("pm", pm), ("tt", tt)):
        out[f"{name}.valid"] = tab.valid.copy()
        for k, v in tab._asdict().items():
            out[f"{name}.{k}"] = v[tab.valid].copy()
    out["slots"] = dict(sched.snapshot.pod_slot)
    out["active"] = [p.uid for p in sched.queue.active_pods()]
    out["pending"] = sched.pending_count()
    out["rr"] = None if sched._rr is None else int(sched._rr)
    return out


@pytest.mark.parametrize("n_waves", [None, 2])
def test_warm_pipeline_leaves_the_state_as_it_was(n_waves):
    """warm_pipeline on a world with bound pods carrying affinity terms
    and a pending backlog with pod (anti-)affinity and spread: the state
    the rounds read, the queue and rr are unchanged, the pods stay
    pending, and the drain after it binds as a drain without it."""
    got = {}
    for warm in (False, True):
        store, names = ipa_store_world("kubernetes_tpu_torch", 7, 12, 40)
        sched = tsched.Scheduler(store, wave_size=WAVE, device="cpu",
                                 clock=FakeClock(), caps=Caps(M=256, E=256),
                                 disable_preemption=True)
        if warm:
            before = _live_state(sched)
            sched.warm_pipeline(sched.queue.active_pods(), n_waves=n_waves)
            after = _live_state(sched)
            assert after.keys() == before.keys()
            for k in before:
                if isinstance(before[k], np.ndarray):
                    np.testing.assert_array_equal(after[k], before[k],
                                                  err_msg=k)
                else:
                    assert after[k] == before[k], k
            assert sched.queue.added_at.keys() >= set(names)
        sched.schedule_pending()
        got[warm] = bindings(store)
    assert got[True] == got[False]
    assert any(got[True].values())
