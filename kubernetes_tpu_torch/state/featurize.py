"""Pending-pod wavefront featurization.

Turns a batch of pending pods into the fixed-shape PodBatch encoding
(ops/encoding.py). Featurization is the per-cycle "metadata"
precomputation of the reference (pkg/scheduler/algorithm/predicates/
metadata.go:111 GetMetadata) fused with its equivalence cache
(pkg/scheduler/core/equivalence_cache.go:240 getEquivalenceClassInfo):
pods created by the same controller share an identical spec, so their
feature rows are computed once and cached by equivalence class. The
cache is invalidated when the interning vocabularies grow (a previously
unknown selector operand may have gained an id).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as lbl
from ..api import types as api
from ..ops import encoding as enc
from .snapshot import Snapshot, _parse_label_num
from .vocab import bucket_size

# A "group selector" for spreading: AND of requirements over pod labels.
GroupSelectorsFn = Callable[[api.Pod], List[lbl.Selector]]


def equivalence_class(pod: api.Pod) -> Optional[str]:
    """Feature-row cache key. The reference's equivalence cache keys by
    controller ref alone (equivalence_cache.go:240), betting that siblings
    share spec; we add a cheap spec fingerprint so a same-owner pod with a
    divergent spec (template update mid-rollout) can never silently reuse
    stale features."""
    for ref in pod.metadata.owner_references:
        if ref.controller:
            sig = hash(repr((pod.namespace,
                             tuple(sorted(pod.metadata.labels.items())),
                             pod.spec)))
            return f"{ref.uid}/{sig:x}"
    return None


@dataclass
class _PodRow:
    """Cached per-pod feature columns (everything except host_idx, which
    depends on the node index map)."""

    data: Dict[str, np.ndarray]
    node_name: str
    vocab_version: tuple


class FeaturizeError(Exception):
    pass


class PodFeaturizeError(FeaturizeError):
    """One pod's spec crashed the featurizer — or featurized into
    non-finite planes (a NaN/inf resource quantity would poison the
    device scan's usage carry and shift every later pod's placement).
    Typed and UID-carrying so the caller can name the culprit pod."""

    def __init__(self, pod, cause: Exception):
        self.uid = getattr(pod, "uid", "")
        self.pod_name = (pod.full_name() if hasattr(pod, "full_name")
                         else str(pod))
        super().__init__(
            f"pod {self.pod_name} (uid {self.uid}) poisons featurization: "
            f"{type(cause).__name__}: {cause}")


class PodFeaturizer:
    def __init__(self, snapshot: Snapshot, group_selectors: Optional[GroupSelectorsFn] = None):
        self.snap = snapshot
        self.vocabs = snapshot.vocabs
        self.group_selectors = group_selectors or (lambda pod: [])
        self._cache: Dict[str, _PodRow] = {}

    # -- selector program compilation ----------------------------------------

    def _compile_reqs(
        self, reqs: Sequence[lbl.Requirement], keys, AE: int, AV: int,
        node_space: bool,
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Compile an AND-list of requirements to (key[AE], op[AE],
        vals[AE,AV], num[AE]). Returns None if it doesn't fit caps (caller
        grows and retries).

        Keys and values are INTERNED, not looked up: a freshly interned id
        matches nothing until some entity carries it — identical semantics
        to an unknown id — and, unlike lookup, a program compiled early in
        a batch stays correct when a later pod in the same batch interns
        the same string (the stale -1 operand hazard)."""
        if len(reqs) > AE:
            return None
        key = np.zeros((AE,), np.int32)
        op = np.full((AE,), enc.OP_PAD, np.int32)
        vals = np.full((AE, AV), -1, np.int32)
        num = np.full((AE,), np.nan, np.float32)
        v = self.vocabs
        for i, r in enumerate(reqs):
            if r.key == api.NODE_FIELD_NAME and node_space:
                # matchFields metadata.name -> node-index membership
                if r.op not in (lbl.IN,):
                    # NotIn over node names: rewrite as NODE_NAME_IN inverted is
                    # not supported yet; treat conservatively as always-false.
                    op[i] = enc.OP_FALSE
                    continue
                if len(r.values) > AV:
                    return None
                op[i] = enc.OP_NODE_NAME_IN
                for j, val in enumerate(r.values):
                    vals[i, j] = self.snap.node_index.get(val, -1)
                continue
            kid = keys.intern(r.key)
            if node_space:
                if kid >= self.snap.caps.K:
                    self.snap._grow(K=kid + 1)
            elif kid >= self.snap.caps.KP:
                self.snap._grow(KP=kid + 1)
            key[i] = kid
            op[i] = enc.op_id(r.op)
            if r.op in (lbl.IN, lbl.NOT_IN):
                if len(r.values) > AV:
                    return None
                for j, val in enumerate(r.values):
                    vals[i, j] = v.label_values.intern(val)
            elif r.op in (lbl.GT, lbl.LT):
                num[i] = _parse_label_num(r.values[0]) if r.values else math.nan
        return key, op, vals, num

    # -- featurize one pod ----------------------------------------------------

    def _featurize_pod(self, pod: api.Pod) -> Dict[str, np.ndarray]:
        c = self.snap.caps
        v = self.vocabs
        d: Dict[str, np.ndarray] = {}
        # resources
        req_map = api.get_resource_request(pod)
        from .node_info import Resource

        d["req"] = self.snap._res_vec(Resource.from_map(req_map))
        nz_cpu, nz_mem = api.get_nonzero_requests(pod)
        d["nonzero"] = np.array([nz_cpu, nz_mem], np.float32)
        d["best_effort"] = np.bool_(api.is_best_effort(pod))
        # zero-request fast flag is implicit: req all zeros
        # nodeSelector equality pairs
        ns = pod.spec.node_selector or {}
        if len(ns) > c.NS:
            self.snap._grow(NS=len(ns))
            c = self.snap.caps
        ns_key = np.zeros((c.NS,), np.int32)
        ns_val = np.full((c.NS,), -1, np.int32)
        for i, (k, val) in enumerate(sorted(ns.items())):
            kid = v.label_keys.lookup(k)
            ns_key[i] = kid if kid > 0 else -2  # -2: unknown key, never matches
            ns_val[i] = v.label_values.lookup(val)
        d["ns_key"], d["ns_val"] = ns_key, ns_val
        # required node affinity
        aff = pod.spec.affinity
        na = aff.node_affinity if aff else None
        terms = list(na.required.node_selector_terms) if (na and na.required is not None) else []
        d["has_aff"] = np.bool_(na is not None and na.required is not None)
        while True:
            c = self.snap.caps
            at_valid = np.zeros((c.AT,), bool)
            at_key = np.zeros((c.AT, c.AE), np.int32)
            at_op = np.full((c.AT, c.AE), enc.OP_PAD, np.int32)
            at_vals = np.full((c.AT, c.AE, c.AV), -1, np.int32)
            at_num = np.full((c.AT, c.AE), np.nan, np.float32)
            if len(terms) > c.AT:
                self.snap._grow(AT=len(terms))
                continue
            ok = True
            for ti, term in enumerate(terms):
                reqs = list(term.match_expressions) + list(term.match_fields)
                if not reqs:
                    continue  # empty term matches nothing -> leave invalid
                prog = self._compile_reqs(reqs, v.label_keys, c.AE, c.AV, node_space=True)
                if prog is None:
                    self.snap._grow(AE=len(reqs),
                                    AV=max((len(r.values) for r in reqs), default=0))
                    ok = False
                    break
                at_valid[ti] = True
                at_key[ti], at_op[ti], at_vals[ti], at_num[ti] = prog
            if ok:
                break
        d["at_valid"], d["at_key"], d["at_op"], d["at_vals"], d["at_num"] = (
            at_valid, at_key, at_op, at_vals, at_num)
        # preferred node affinity
        pref = list(na.preferred) if na else []
        pref = [t for t in pref if t.weight != 0]
        while True:
            c = self.snap.caps
            if len(pref) > c.PT:
                self.snap._grow(PT=len(pref))
                continue
            pt_weight = np.zeros((c.PT,), np.float32)
            pt_key = np.zeros((c.PT, c.AE), np.int32)
            pt_op = np.full((c.PT, c.AE), enc.OP_PAD, np.int32)
            pt_vals = np.full((c.PT, c.AE, c.AV), -1, np.int32)
            pt_num = np.full((c.PT, c.AE), np.nan, np.float32)
            ok = True
            for ti, term in enumerate(pref):
                reqs = list(term.preference.match_expressions) + list(term.preference.match_fields)
                prog = self._compile_reqs(reqs, v.label_keys, c.AE, c.AV, node_space=True)
                if prog is None:
                    self.snap._grow(AE=len(reqs),
                                    AV=max((len(r.values) for r in reqs), default=0))
                    ok = False
                    break
                pt_weight[ti] = term.weight
                pt_key[ti], pt_op[ti], pt_vals[ti], pt_num[ti] = prog
            if ok:
                break
        d["pt_weight"], d["pt_key"], d["pt_op"], d["pt_vals"], d["pt_num"] = (
            pt_weight, pt_key, pt_op, pt_vals, pt_num)
        # tolerations
        tols = pod.spec.tolerations
        if len(tols) > self.snap.caps.TL:
            self.snap._grow(TL=len(tols))
        c = self.snap.caps
        tol_key = np.zeros((c.TL,), np.int32)
        tol_val = np.full((c.TL,), -1, np.int32)
        tol_op = np.full((c.TL,), enc.TOL_PAD, np.int32)
        tol_effect = np.zeros((c.TL,), np.int32)
        for i, t in enumerate(tols):
            tol_key[i] = v.taint_keys.lookup(t.key) if t.key else 0  # 0 = all keys
            if t.key and tol_key[i] < 0:
                tol_key[i] = -2  # unknown key: tolerates nothing present
            tol_val[i] = v.taint_values.lookup(t.value)
            tol_op[i] = enc.TOL_EXISTS if t.operator == api.TOLERATION_OP_EXISTS else enc.TOL_EQUAL
            tol_effect[i] = enc.EFFECT_IDS.get(t.effect, 0)
        d["tol_key"], d["tol_val"], d["tol_op"], d["tol_effect"] = (
            tol_key, tol_val, tol_op, tol_effect)
        # host ports
        cports = api.get_container_ports(pod)
        if len(cports) > self.snap.caps.PQ:
            self.snap._grow(PQ=len(cports))
        c = self.snap.caps
        ports = np.zeros((c.PQ,), np.int32)
        for i, p in enumerate(cports):
            pid = v.lookup_port(p.protocol, p.host_port)
            ports[i] = pid if pid > 0 else 0  # unknown port id: no node uses it
        d["ports"] = ports
        # spreading selectors (over pod-label space)
        d["ns_id"] = np.int32(v.namespaces.intern(pod.namespace))
        sels = self.group_selectors(pod)
        while True:
            c = self.snap.caps
            if len(sels) > c.SG:
                self.snap._grow(SG=len(sels))
                continue
            sg_valid = np.zeros((c.SG,), bool)
            sg_key = np.zeros((c.SG, c.SE), np.int32)
            sg_op = np.full((c.SG, c.SE), enc.OP_PAD, np.int32)
            sg_vals = np.full((c.SG, c.SE, c.SV), -1, np.int32)
            sg_num = np.full((c.SG, c.SE), np.nan, np.float32)
            ok = True
            for si, sel in enumerate(sels):
                prog = self._compile_reqs(sel.requirements, v.pod_label_keys,
                                          c.SE, c.SV, node_space=False)
                if prog is None:
                    self.snap._grow(SE=len(sel.requirements),
                                    SV=max((len(r.values) for r in sel.requirements), default=0))
                    ok = False
                    break
                sg_valid[si] = True
                sg_key[si], sg_op[si], sg_vals[si], sg_num[si] = prog
            if ok:
                break
        d["sg_valid"], d["sg_key"], d["sg_op"], d["sg_vals"], d["sg_num"] = (
            sg_valid, sg_key, sg_op, sg_vals, sg_num)
        # topologySpreadConstraints (forward-port; ops/topology.py).
        # Selector programs run over the existing-pod label space, like
        # inter-pod-affinity terms; a nil selector matches nothing
        # (labels.Nothing, same convention as _compile_combined).
        cons = [t for t in pod.spec.topology_spread_constraints
                if t.topology_key]
        while True:
            c = self.snap.caps
            if len(cons) > c.TS:
                self.snap._grow(TS=len(cons))
                continue
            ts_valid = np.zeros((c.TS,), bool)
            ts_hard = np.zeros((c.TS,), bool)
            ts_skew = np.zeros((c.TS,), np.float32)
            ts_tk = np.zeros((c.TS,), np.int32)
            ts_key = np.zeros((c.TS, c.TE), np.int32)
            ts_op = np.full((c.TS, c.TE), enc.OP_PAD, np.int32)
            ts_vals = np.full((c.TS, c.TE, c.TV), -1, np.int32)
            ok = True
            for ti, con in enumerate(cons):
                if con.label_selector is None:
                    prog = "nothing"
                else:
                    reqs = con.label_selector.to_selector().requirements
                    prog = self._compile_reqs(reqs, v.pod_label_keys,
                                              c.TE, c.TV, node_space=False)
                    if prog is None:
                        self.snap._grow(
                            TE=len(reqs),
                            TV=max((len(r.values) for r in reqs), default=0))
                        ok = False
                        break
                ts_valid[ti] = True
                ts_hard[ti] = con.when_unsatisfiable != api.SCHEDULE_ANYWAY
                ts_skew[ti] = max(1, int(con.max_skew))
                ts_tk[ti] = self.snap.label_key_col(con.topology_key)
                if prog == "nothing":
                    ts_op[ti, 0] = enc.OP_FALSE
                else:
                    ts_key[ti], ts_op[ti], ts_vals[ti], _ = prog
            if ok:
                break
        d["ts_valid"], d["ts_hard"], d["ts_skew"], d["ts_tk"] = (
            ts_valid, ts_hard, ts_skew, ts_tk)
        d["ts_key"], d["ts_op"], d["ts_vals"] = ts_key, ts_op, ts_vals
        # inter-pod affinity
        self._featurize_interpod(pod, d)
        # misc
        d["owned"] = np.bool_(any(
            ref.controller and ref.kind in ("ReplicationController", "ReplicaSet")
            for ref in pod.metadata.owner_references))
        imgs = [img for ctr in pod.spec.containers for img in ([getattr(ctr, "image", "")] if getattr(ctr, "image", "") else [])]
        c = self.snap.caps
        img_id = np.zeros((c.PI,), np.int32)
        for i, name in enumerate(imgs[: c.PI]):
            img_id[i] = v.images.lookup(name)
        d["img_id"] = img_id
        d["prio"] = np.int32(api.pod_priority(pod))
        return d

    def _featurize_pod_guarded(self, pod: api.Pod) -> Dict[str, np.ndarray]:
        """_featurize_pod hardened for poison isolation: any crash is
        re-raised as a typed, UID-carrying PodFeaturizeError, and rows
        whose resource columns came out non-finite (a 'NaN'-quantity
        spec parses without error) are rejected HERE — before they can
        reach a device program and poison the whole wave's usage carry."""
        try:
            d = self._featurize_pod(pod)
        except PodFeaturizeError:
            raise
        except (MemoryError, OSError, TimeoutError):
            # environmental, not spec-caused: convicting the pod that
            # HAPPENED to be featurizing when memory ran out would
            # quarantine an innocent — propagate raw, like before
            raise
        except Exception as e:
            raise PodFeaturizeError(pod, e) from e
        if not (np.isfinite(d["req"]).all()
                and np.isfinite(d["nonzero"]).all()):
            raise PodFeaturizeError(
                pod, ValueError("non-finite resource request"))
        return d

    # -- inter-pod affinity ----------------------------------------------------

    @staticmethod
    def needs_host_path(pod: api.Pod) -> bool:
        """True when the pod's required pod-(anti)affinity terms span more
        than one distinct topology key. The device encoding
        (ops/affinity.py) collapses all required terms to one shared
        topology key — the reference semantics
        (predicates.go anyPodsMatchingTopologyTerms: one target node must
        satisfy ALL terms' topologies) need a composite domain otherwise,
        so such pods take an exact host path (the JAX package's
        plugins/golden.py; the port's `_schedule_host_batch`)."""
        aff = pod.spec.affinity
        if aff is None:
            return False
        for group in (aff.pod_affinity, aff.pod_anti_affinity):
            if group is None:
                continue
            tks = {t.topology_key for t in group.required}
            if len(tks) > 1:
                return True
        return False

    def _ns_set(self, pod: api.Pod, terms) -> List[int]:
        """Intersection of the terms' namespace sets (each term: explicit
        list, or the pod's own namespace) as interned ids."""
        v = self.vocabs
        sets_ = []
        for t in terms:
            names = set(t.namespaces) if t.namespaces else {pod.namespace}
            sets_.append(names)
        inter = set.intersection(*sets_) if sets_ else set()
        # inner sorted: intern() MINTS ids in iteration order, so
        # interning in set order would assign namespace ids by the hash
        # seed — vocab contents must be a pure function of input order
        return sorted(v.namespaces.intern(n) for n in sorted(inter))

    def _compile_combined(self, terms, IE: int, IV: int):
        """All required terms' selectors concatenated into one AND program
        (metadata-path semantics: podMatchesAffinityTermProperties matches
        ALL properties). Returns None if caps too small; 'nothing' if any
        selector is nil."""
        reqs = []
        for t in terms:
            if t.label_selector is None:
                return "nothing"
            reqs.extend(t.label_selector.to_selector().requirements)
        if len(reqs) > IE:
            return None
        return self._compile_reqs(reqs, self.vocabs.pod_label_keys, IE, IV,
                                  node_space=False)

    def _featurize_interpod(self, pod: api.Pod, d: Dict[str, np.ndarray]):
        v = self.vocabs
        c = self.snap.caps
        # the pod's own labels in pod-label key space (matched against
        # existing pods' term selectors and wave-internal programs)
        for key in pod.metadata.labels or {}:
            kid = v.pod_label_keys.intern(key)
            if kid >= self.snap.caps.KP:
                self.snap._grow(KP=kid + 1)
        c = self.snap.caps
        pl = np.zeros((c.KP,), np.int32)
        for key, val in (pod.metadata.labels or {}).items():
            pl[v.pod_label_keys.intern(key)] = v.label_values.intern(val)
        d["pl_val"] = pl

        aff = pod.spec.affinity
        pa_terms = []  # (signed weight, term)
        for side, sign in ((aff.pod_affinity if aff else None, 1.0),
                           (aff.pod_anti_affinity if aff else None, -1.0)):
            if side is not None:
                pa_terms.extend((sign * wt.weight, wt.pod_affinity_term)
                                for wt in side.preferred if wt.weight)
        for req_name, side in (("ra", aff.pod_affinity if aff else None),
                               ("rn", aff.pod_anti_affinity if aff else None)):
            terms = list(side.required) if side is not None else []
            d[f"{req_name}_has"] = np.bool_(bool(terms))
            while True:
                c = self.snap.caps
                prog = self._compile_combined(terms, c.IE, c.IV)
                if prog is None:
                    nreq = sum(len(t.label_selector.to_selector().requirements)
                               for t in terms if t.label_selector is not None)
                    nval = max((len(r.values)
                                for t in terms if t.label_selector is not None
                                for r in t.label_selector.to_selector().requirements),
                               default=0)
                    self.snap._grow(IE=max(nreq, c.IE + 1), IV=nval)
                    continue
                break
            c = self.snap.caps
            if prog == "nothing":
                key = np.zeros((c.IE,), np.int32)
                op = np.full((c.IE,), enc.OP_PAD, np.int32)
                op[0] = enc.OP_FALSE
                vals = np.full((c.IE, c.IV), -1, np.int32)
                num = np.full((c.IE,), np.nan, np.float32)
                prog = (key, op, vals, num)
            d[f"{req_name}_key"], d[f"{req_name}_op"], d[f"{req_name}_vals"], _ = prog
            ns_ids = self._ns_set(pod, terms)
            if len(ns_ids) > c.TNS:
                self.snap._grow(TNS=len(ns_ids))
                c = self.snap.caps
            ns_row = np.zeros((c.TNS,), np.int32)
            ns_row[: len(ns_ids)] = ns_ids
            d[f"{req_name}_ns"] = ns_row
            # shared topology key (single-tk fast path; needs_host_path
            # flags multi-tk pods, which the scheduler keeps out of a round)
            tk = terms[0].topology_key if terms else ""
            d[f"{req_name}_tk"] = np.int32(self.snap.label_key_col(tk) if tk else 0)
        # bootstrap rule input: does the pod match its own affinity props?
        ra_terms = list(aff.pod_affinity.required) if (aff and aff.pod_affinity) else []
        self_match = bool(ra_terms)
        for t in ra_terms:
            names = set(t.namespaces) if t.namespaces else {pod.namespace}
            if pod.namespace not in names or t.label_selector is None or \
                    not t.label_selector.matches(pod.metadata.labels):
                self_match = False
                break
        d["ra_self"] = np.bool_(self_match)
        # preferred terms (priority)
        if len(pa_terms) > self.snap.caps.PA:
            self.snap._grow(PA=len(pa_terms))
        c = self.snap.caps
        pa_w = np.zeros((c.PA,), np.float32)
        pa_tk = np.zeros((c.PA,), np.int32)
        pa_ns = np.zeros((c.PA, c.TNS), np.int32)
        pa_key = np.zeros((c.PA, c.TE), np.int32)
        pa_op = np.full((c.PA, c.TE), enc.OP_PAD, np.int32)
        pa_vals = np.full((c.PA, c.TE, c.TV), -1, np.int32)
        for i, (w, term) in enumerate(pa_terms):
            while True:
                c = self.snap.caps
                if term.label_selector is None:
                    prog = "nothing"
                else:
                    reqs = term.label_selector.to_selector().requirements
                    prog = self._compile_reqs(reqs, v.pod_label_keys, c.TE, c.TV,
                                              node_space=False)
                    if prog is None:
                        self.snap._grow(TE=len(reqs),
                                        TV=max((len(r.values) for r in reqs), default=0))
                        # caps grew: restart the whole preferred-term loop with
                        # freshly sized arrays
                        return self._featurize_interpod(pod, d)
                break
            pa_w[i] = w
            pa_tk[i] = self.snap.label_key_col(term.topology_key) if term.topology_key else 0
            ns_ids = self._ns_set(pod, [term])
            if len(ns_ids) > c.TNS:
                self.snap._grow(TNS=len(ns_ids))
                return self._featurize_interpod(pod, d)
            pa_ns[i, : len(ns_ids)] = ns_ids
            if prog == "nothing":
                pa_op[i, 0] = enc.OP_FALSE
            else:
                pa_key[i], pa_op[i], pa_vals[i], _ = prog
        d["pa_w"], d["pa_tk"], d["pa_ns"] = pa_w, pa_tk, pa_ns
        d["pa_key"], d["pa_op"], d["pa_vals"] = pa_key, pa_op, pa_vals

    # -- batch ----------------------------------------------------------------

    def featurize(self, pods: Sequence[api.Pod]) -> enc.PodBatch:
        c0 = self.snap.caps
        P = bucket_size(max(len(pods), 1), c0.P)
        if P > c0.P:
            self.snap.caps.P = P
        ver = self.vocabs.version()
        rows: List[Dict[str, np.ndarray]] = []
        for pod in pods:
            sig = equivalence_class(pod)
            cached = self._cache.get(sig) if sig else None
            if cached is not None and cached.vocab_version == ver and self._caps_match(cached.data):
                d = cached.data
            else:
                d = self._featurize_pod_guarded(pod)
                ver = self.vocabs.version()  # may have grown during featurize
                if sig:
                    self._cache[sig] = _PodRow(d, pod.spec.node_name, ver)
            rows.append(d)
        # capacities may have grown while featurizing later pods: recompute
        # any row that no longer matches current caps
        for i, (pod, d) in enumerate(zip(pods, rows)):
            if not self._caps_match(d):
                rows[i] = self._featurize_pod_guarded(pod)
                sig = equivalence_class(pod)
                if sig:
                    self._cache[sig] = _PodRow(rows[i], pod.spec.node_name, self.vocabs.version())
        c = self.snap.caps
        P = bucket_size(max(len(pods), 1), c.P)

        def stack(name, shape, dtype, fill=0):
            out = np.full((P,) + shape, fill, dtype)
            for i, d in enumerate(rows):
                out[i] = d[name]
            return out

        host_idx = np.full((P,), -1, np.int32)
        for i, pod in enumerate(pods):
            if pod.spec.node_name:
                # -2: pinned to a node we don't know -> matches NO node
                # (reference PodFitsHost fails everywhere, predicates.go:825);
                # -1 means "no nodeName constraint".
                host_idx[i] = self.snap.node_index.get(pod.spec.node_name, -2)
        batch = enc.PodBatch(
            req=stack("req", (c.R,), np.float32),
            nonzero=stack("nonzero", (2,), np.float32),
            best_effort=stack("best_effort", (), bool),
            host_idx=host_idx,
            ns_key=stack("ns_key", (c.NS,), np.int32),
            ns_val=stack("ns_val", (c.NS,), np.int32, -1),
            has_aff=stack("has_aff", (), bool),
            at_valid=stack("at_valid", (c.AT,), bool),
            at_key=stack("at_key", (c.AT, c.AE), np.int32),
            at_op=stack("at_op", (c.AT, c.AE), np.int32, enc.OP_PAD),
            at_vals=stack("at_vals", (c.AT, c.AE, c.AV), np.int32, -1),
            at_num=stack("at_num", (c.AT, c.AE), np.float32, np.nan),
            pt_weight=stack("pt_weight", (c.PT,), np.float32),
            pt_key=stack("pt_key", (c.PT, c.AE), np.int32),
            pt_op=stack("pt_op", (c.PT, c.AE), np.int32, enc.OP_PAD),
            pt_vals=stack("pt_vals", (c.PT, c.AE, c.AV), np.int32, -1),
            pt_num=stack("pt_num", (c.PT, c.AE), np.float32, np.nan),
            tol_key=stack("tol_key", (c.TL,), np.int32),
            tol_val=stack("tol_val", (c.TL,), np.int32, -1),
            tol_op=stack("tol_op", (c.TL,), np.int32, enc.TOL_PAD),
            tol_effect=stack("tol_effect", (c.TL,), np.int32),
            ports=stack("ports", (c.PQ,), np.int32),
            ns_id=stack("ns_id", (), np.int32),
            sg_valid=stack("sg_valid", (c.SG,), bool),
            sg_key=stack("sg_key", (c.SG, c.SE), np.int32),
            sg_op=stack("sg_op", (c.SG, c.SE), np.int32, enc.OP_PAD),
            sg_vals=stack("sg_vals", (c.SG, c.SE, c.SV), np.int32, -1),
            sg_num=stack("sg_num", (c.SG, c.SE), np.float32, np.nan),
            pl_val=stack("pl_val", (c.KP,), np.int32),
            ra_has=stack("ra_has", (), bool),
            ra_key=stack("ra_key", (c.IE,), np.int32),
            ra_op=stack("ra_op", (c.IE,), np.int32, enc.OP_PAD),
            ra_vals=stack("ra_vals", (c.IE, c.IV), np.int32, -1),
            ra_ns=stack("ra_ns", (c.TNS,), np.int32),
            ra_tk=stack("ra_tk", (), np.int32),
            ra_self=stack("ra_self", (), bool),
            rn_has=stack("rn_has", (), bool),
            rn_key=stack("rn_key", (c.IE,), np.int32),
            rn_op=stack("rn_op", (c.IE,), np.int32, enc.OP_PAD),
            rn_vals=stack("rn_vals", (c.IE, c.IV), np.int32, -1),
            rn_ns=stack("rn_ns", (c.TNS,), np.int32),
            rn_tk=stack("rn_tk", (), np.int32),
            pa_w=stack("pa_w", (c.PA,), np.float32),
            pa_tk=stack("pa_tk", (c.PA,), np.int32),
            pa_ns=stack("pa_ns", (c.PA, c.TNS), np.int32),
            pa_key=stack("pa_key", (c.PA, c.TE), np.int32),
            pa_op=stack("pa_op", (c.PA, c.TE), np.int32, enc.OP_PAD),
            pa_vals=stack("pa_vals", (c.PA, c.TE, c.TV), np.int32, -1),
            owned=stack("owned", (), bool),
            img_id=stack("img_id", (c.PI,), np.int32),
            prio=stack("prio", (), np.int32),
            valid=np.arange(P) < len(pods),
            ts_valid=stack("ts_valid", (c.TS,), bool),
            ts_hard=stack("ts_hard", (c.TS,), bool),
            ts_skew=stack("ts_skew", (c.TS,), np.float32),
            ts_tk=stack("ts_tk", (c.TS,), np.int32),
            ts_key=stack("ts_key", (c.TS, c.TE), np.int32),
            ts_op=stack("ts_op", (c.TS, c.TE), np.int32, enc.OP_PAD),
            ts_vals=stack("ts_vals", (c.TS, c.TE, c.TV), np.int32, -1),
            **self._dedup_tables(rows, P),
        )
        return batch

    def _dedup_tables(self, rows, P: int) -> Dict[str, np.ndarray]:
        """Intern the wave's required/preferred pod-affinity programs into
        unique tables (PodBatch.iu_*/pu_* + uid indices). Pods stamped
        from one controller template share programs, so the device side
        evaluates U unique programs against the M existing pods instead
        of P — the difference between O(P*M) and O(U*M) in
        ops/affinity.py incoming_statics. Row 0 of each table is a
        reserved never-matches program (OP_FALSE, tk 0)."""
        c = self.snap.caps
        ra_uid = np.zeros(P, np.int32)
        rn_uid = np.zeros(P, np.int32)
        pa_uid = np.zeros((P, c.PA), np.int32)
        iu_rows: List[tuple] = []
        iu_index: Dict[bytes, int] = {}
        pu_rows: List[tuple] = []
        pu_index: Dict[bytes, int] = {}

        def intern(index, rows_list, parts) -> int:
            key = b"|".join(p.tobytes() for p in parts)
            j = index.get(key)
            if j is None:
                j = len(rows_list) + 1  # +1: row 0 reserved
                index[key] = j
                rows_list.append(parts)
            return j

        for i, d in enumerate(rows):
            if d["ra_has"]:
                ra_uid[i] = intern(iu_index, iu_rows, (
                    d["ra_key"], d["ra_op"], d["ra_vals"], d["ra_ns"],
                    d["ra_tk"]))
            if d["rn_has"]:
                rn_uid[i] = intern(iu_index, iu_rows, (
                    d["rn_key"], d["rn_op"], d["rn_vals"], d["rn_ns"],
                    d["rn_tk"]))
            for t in range(c.PA):
                if d["pa_w"][t] != 0:
                    pa_uid[i, t] = intern(pu_index, pu_rows, (
                        d["pa_key"][t], d["pa_op"][t], d["pa_vals"][t],
                        d["pa_ns"][t], d["pa_tk"][t]))
        if len(iu_rows) + 1 > c.UI:
            self.snap.caps.UI = bucket_size(len(iu_rows) + 1, c.UI)
        if len(pu_rows) + 1 > c.UP:
            self.snap.caps.UP = bucket_size(len(pu_rows) + 1, c.UP)
        c = self.snap.caps

        def table(rows_list, n, e_dim, v_dim):
            key = np.zeros((n, e_dim), np.int32)
            op = np.full((n, e_dim), enc.OP_PAD, np.int32)
            op[:, 0] = enc.OP_FALSE  # reserved/pad rows match nothing
            vals = np.full((n, e_dim, v_dim), -1, np.int32)
            ns = np.zeros((n, c.TNS), np.int32)
            tk = np.zeros((n,), np.int32)
            for j, (k_, o_, v_, n_, t_) in enumerate(rows_list, start=1):
                key[j], op[j], vals[j], ns[j], tk[j] = k_, o_, v_, n_, t_
            return key, op, vals, ns, tk

        iu_key, iu_op, iu_vals, iu_ns, iu_tk = table(
            iu_rows, c.UI, c.IE, c.IV)
        pu_key, pu_op, pu_vals, pu_ns, pu_tk = table(
            pu_rows, c.UP, c.TE, c.TV)
        return dict(ra_uid=ra_uid, rn_uid=rn_uid, pa_uid=pa_uid,
                    iu_key=iu_key, iu_op=iu_op, iu_vals=iu_vals,
                    iu_ns=iu_ns, iu_tk=iu_tk, pu_key=pu_key, pu_op=pu_op,
                    pu_vals=pu_vals, pu_ns=pu_ns, pu_tk=pu_tk)

    def _caps_match(self, d: Dict[str, np.ndarray]) -> bool:
        c = self.snap.caps
        return (
            d["req"].shape == (c.R,)
            and d["ns_key"].shape == (c.NS,)
            and d["at_key"].shape == (c.AT, c.AE)
            and d["at_vals"].shape == (c.AT, c.AE, c.AV)
            and d["pt_key"].shape == (c.PT, c.AE)
            and d["tol_key"].shape == (c.TL,)
            and d["ports"].shape == (c.PQ,)
            and d["sg_key"].shape == (c.SG, c.SE)
            and d["sg_vals"].shape == (c.SG, c.SE, c.SV)
            and d["pl_val"].shape == (c.KP,)
            and d["ra_key"].shape == (c.IE,)
            and d["ra_vals"].shape == (c.IE, c.IV)
            and d["ra_ns"].shape == (c.TNS,)
            and d["pa_key"].shape == (c.PA, c.TE)
            and d["pa_vals"].shape == (c.PA, c.TE, c.TV)
            and d["pa_ns"].shape == (c.PA, c.TNS)
            and d["ts_key"].shape == (c.TS, c.TE)
            and d["ts_vals"].shape == (c.TS, c.TE, c.TV)
        )
