"""Shared parts of the port's parity tests: worlds pre-sized so that
their JAX programs compile once, the JAX scheduler's round assembly over
them, the comparison of the two packages' rounds, every output
bit-equal, and `Both`, which drives one scenario through both packages'
schedulers in lockstep. Used by tests/test_torch_kernel.py,
tests/test_torch_affinity.py, tests/test_torch_topology.py,
tests/test_torch_gang.py, tests/test_torch_preempt.py,
tests/test_torch_drivers.py and tests/test_torch_hostpath.py.
"""

import numpy as np
import torch

from kubernetes_tpu.ops import encoding as jenc
from kubernetes_tpu.ops import kernel as jk
from kubernetes_tpu.ops.scores import stack_weights
from kubernetes_tpu.runtime.store import ObjectStore as JaxStore
from kubernetes_tpu.sched import scheduler as jsched
from kubernetes_tpu.state.featurize import PodFeaturizer
from kubernetes_tpu_torch.ops import encoding as tenc
from kubernetes_tpu_torch.ops import kernel as tk
from kubernetes_tpu_torch.runtime.store import ObjectStore as TorchStore
from kubernetes_tpu_torch.sched.scheduler import Scheduler as TorchScheduler

from torch_worlds import (FakeClock, bindings, group_selectors, ipa_world,
                          pdb, plain_node, plain_pod, pod_group)

# pre-sized so that every world below compiles the same JAX shapes
CAPS = dict(N=16, Z=16, M=64, P=16, E=128, PA=4, UI=32, UP=32)
# one caps size for every scheduler scenario (Both), in both packages, so
# their JAX programs compile once
SCHED_CAPS = dict(N=16, Z=16, M=64, P=16, LV=64)
WAVE_PLANES = ("chosen", "score", "feasible_count", "fail_counts", "masks",
               "rr_end", "finite")
# gating weights that switch on the optional planes, and a live vector
# whose values differ from the gating ones (the traced weight_vec path),
# the interpod and spread planes re-weighted too
RICH_WEIGHTS = dict(most_requested=1.0, image_locality=1.0)
LIVE_VECTOR = np.asarray([2, 1, 3, 1, 2, 1, 10000, 1, 3, 2, 4, 1],
                         np.float32)
# the scheduler metrics the port observes where the JAX scheduler does
SCHED_METRICS = ("pod_scheduling_latency", "binding_latency",
                 "pods_scheduled", "e2e_scheduling_latency", "waves_total",
                 "schedule_attempts", "pods_failed", "unschedulable_reasons",
                 "preemption_evaluation", "total_preemption_attempts",
                 "pod_preemption_victims", "gang_schedule_attempts",
                 "gang_wait_seconds", "scheduling_errors")


def eq(want, got, name=""):
    """A JAX (or numpy) array and a CPU tensor: same dtype, same shape,
    every element equal."""
    a = np.asarray(want)
    b = got.numpy()
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def parity_world(seed, **kw):
    """An `ipa_world` built by the JAX package at CAPS: (snapshot, its
    numpy tensors and batch, the same as CPU tensors)."""
    snap, pb, pods = ipa_world("kubernetes_tpu", seed,
                               caps=jenc.Caps(**CAPS), **kw)
    nt, pm, tt = snap.host_tensors()
    return snap, (nt, pm, tt, pb), tenc.to_torch(nt, pm, tt, pb, "cpu")


def assemble(snap, feat, waves):
    """Featurize and stage `waves` and assemble them as the JAX scheduler
    does: (node tensors, pod matrix, term table, stacked batch, pod rows,
    term rows). The term rows are padded (-1) to at least 8 a pod, so
    that worlds whose pods carry different numbers of terms share one JAX
    program."""
    pbs = [feat.featurize(w) for w in waves]
    pods = [p for w in waves for p in w]
    pm_rows, term_rows = snap.stage_pending(pods)
    tpp = max(8, term_rows.shape[1])
    term_rows = np.pad(term_rows, ((0, 0), (0, tpp - term_rows.shape[1])),
                       constant_values=-1)
    nt, pm, tt = snap.host_tensors()
    stacked, rows, trows = jsched.assemble_round(
        pbs, waves, pm_rows, term_rows, jsched.pipeline_bucket(len(waves)),
        tpp)
    return nt, pm, tt, stacked, rows, trows


def round_inputs(seed, wave_sizes, world=ipa_world, caps=CAPS):
    """The round inputs of a seeded world whose pending pods are split
    into waves of `wave_sizes`: (snapshot, numpy round inputs). caps=None
    sizes the snapshot by its defaults."""
    snap, _, pods = world("kubernetes_tpu", seed, n_pending=sum(wave_sizes),
                          caps=jenc.Caps(**caps) if caps else None,
                          featurize=False)
    feat = PodFeaturizer(snap, group_selectors("kubernetes_tpu"))
    waves, start = [], 0
    for n in wave_sizes:
        waves.append(pods[start:start + n])
        start += n
    return snap, assemble(snap, feat, waves)


def compare_rounds(snap, inputs, has_ipa=False, vector=False, gating=None):
    """The JAX round and the port's round on the same inputs, every
    output bit-equal; the port's inputs are left untouched. vector: the
    live LIVE_VECTOR instead of the gating weights' own vector; gating:
    Weights keywords (RICH_WEIGHTS switches the optional planes on).
    Returns the port's chosen [W, P]."""
    nt, pm, tt, pbs, rows, trows = inputs
    gating = gating or {}
    vec = LIVE_VECTOR if vector else stack_weights(jk.Weights(**gating))
    zl = dict(num_zones=snap.caps.Z, num_label_values=snap.num_label_values)
    want = jk.schedule_round(nt, pm, tt, pbs,
                             (nt.requested, nt.nonzero, nt.pod_count),
                             np.int32(3), rows, trows,
                             weights=jk.Weights(**gating), has_ipa=has_ipa,
                             weight_vec=vec, **zl)
    ntt, pmt, ttt, pbst = tenc.to_torch(nt, pm, tt, pbs, "cpu")
    got = tk.schedule_round(ntt, pmt, ttt, pbst,
                            (ntt.requested, ntt.nonzero, ntt.pod_count),
                            torch.tensor(3, dtype=torch.int32),
                            torch.from_numpy(rows), torch.from_numpy(trows),
                            weights=tk.Weights(**gating), has_ipa=has_ipa,
                            weight_vec=tenc.weight_vec_to_torch(vec, "cpu"),
                            **zl)
    eq(want[0], got[0], "chosen")
    eq(want[1], got[1], "fail_counts")
    for i in range(3):
        eq(want[2][i], got[2][i], f"usage[{i}]")
    eq(want[3], got[3], "rr_end")
    assert want[4] is None and got[4] is None
    eq(want[5], got[5], "finite")
    # the carried usage is a new tensor: the inputs are untouched
    np.testing.assert_array_equal(ntt.requested.numpy(), nt.requested)
    return got[0].numpy()


def metric_state(metrics) -> dict:
    """The SCHED_METRICS of one registry: a histogram's count, sum,
    bucket counts and max, a counter's value, a labelled family's
    {series: value}."""
    out = {}
    for name in SCHED_METRICS:
        m = getattr(metrics, name)
        if hasattr(m, "counts"):
            out[name] = (m.total, m.sum, tuple(m.counts), m.max)
        elif hasattr(m, "children"):
            out[name] = {c.name: c.value for c in m.children()}
        else:
            out[name] = m.value
    return out


class Both:
    """One scenario driven through both packages' schedulers in lockstep:
    every store write goes to both stores, every schedule_pending runs on
    both and returns both counts; `check` compares the stores, the
    queues, the preemption counters and the SCHED_METRICS."""

    def __init__(self, n_nodes=0, wave=16, **node_kw):
        self.clock = {"jax": FakeClock(), "torch": FakeClock()}
        self.stores = {"jax": JaxStore(), "torch": TorchStore()}
        self.sched = {
            "jax": jsched.Scheduler(self.stores["jax"], wave_size=wave,
                                    clock=self.clock["jax"],
                                    caps=jenc.Caps(**SCHED_CAPS)),
            "torch": TorchScheduler(self.stores["torch"], wave_size=wave,
                                    clock=self.clock["torch"], device="cpu",
                                    caps=tenc.Caps(**SCHED_CAPS)),
        }
        for i in range(n_nodes):
            self.node(f"n{i}", **node_kw)

    @staticmethod
    def pkg(side):
        return "kubernetes_tpu" if side == "jax" else "kubernetes_tpu_torch"

    def create(self, kind, make):
        """make(pkg) -> the object to create in that package's store."""
        for side, store in self.stores.items():
            store.create(kind, make(self.pkg(side)))

    def node(self, name, **kw):
        for side, store in self.stores.items():
            store.create("nodes", plain_node(self.pkg(side), name, **kw))

    def pod(self, name, **kw):
        for side, store in self.stores.items():
            store.create("pods", plain_pod(self.pkg(side), name, **kw))

    def group(self, name, min_member):
        for side, store in self.stores.items():
            store.create("podgroups", pod_group(self.pkg(side), name,
                                                min_member))

    def budget(self, name, match_labels, allowed):
        for side, store in self.stores.items():
            store.create("poddisruptionbudgets",
                         pdb(self.pkg(side), name, match_labels, allowed))

    def delete(self, name):
        for store in self.stores.values():
            store.delete("pods", "default", name)

    def advance(self, d):
        for c in self.clock.values():
            c.advance(d)

    def run(self):
        got = {side: s.schedule_pending() for side, s in self.sched.items()}
        assert got["jax"] == got["torch"], got
        self.check()
        return got["torch"]

    def check(self):
        want, got = (bindings(self.stores[s]) for s in ("jax", "torch"))
        assert got == want  # the same pods alive, on the same nodes
        nominated = [{p.metadata.name: p.status.nominated_node_name
                      for p in self.stores[s].list("pods")}
                     for s in ("jax", "torch")]
        assert nominated[1] == nominated[0]
        j, t = self.sched["jax"], self.sched["torch"]
        assert t.queue.pending_count() == j.queue.pending_count()
        assert t.pipeline_preemptions == j.pipeline_preemptions
        assert metric_state(t.metrics) == metric_state(j.metrics)

    def bound(self, gang):
        return sum(1 for p in self.stores["torch"].list("pods")
                   if p.metadata.annotations.get(
                       "pod-group.scheduling.k8s.io/name") == gang
                   and p.spec.node_name)
