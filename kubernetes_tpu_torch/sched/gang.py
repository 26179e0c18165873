"""Gang (PodGroup) membership directory.

One place that knows which gang a pod belongs to and what its minMember
is. Membership comes from the `pod-group.scheduling.k8s.io/name`
annotation on plain pods; minMember resolves, in order, from the
PodGroup API object, the `min-available` annotation, then 1.

The directory is deliberately cheap for clusters without gangs: `key()`
is one annotation-dict lookup, and `self.active` stays False until the
first gang pod is ever seen — every other gang code path (preemption
guards, victim-gang sweeps) gates on it, so the non-gang hot paths pay
nothing (the mixed5k bench must stay within 5% of its pre-gang rate).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import types as api


class GangDirectory:
    def __init__(self, store):
        self.store = store
        # flips True forever once any gang-annotated pod is observed;
        # gates every O(pods) gang scan elsewhere
        self.active = False

    # -- membership ----------------------------------------------------------

    def key(self, pod: api.Pod) -> Optional[str]:
        """namespace/group-name, or None for ordinary pods."""
        name = api.pod_group_name(pod)
        if name is None:
            return None
        self.active = True
        return f"{pod.namespace}/{name}"

    def min_member(self, pod: api.Pod) -> int:
        """The gang's minMember as seen from one member pod."""
        name = api.pod_group_name(pod)
        if name is None:
            return 1
        pg = self.store.get("podgroups", pod.namespace, name)
        if pg is not None:
            return max(int(pg.spec.min_member), 1)
        m = api.pod_group_min_available(pod)
        return max(m, 1) if m is not None else 1

    def lookup(self, pod: api.Pod) -> Optional[Tuple[str, int]]:
        """(gang key, minMember) or None — the queue's admission hook."""
        key = self.key(pod)
        if key is None:
            return None
        return key, self.min_member(pod)

    # -- placed-member accounting (over the scheduler cache) ------------------

    def placed_members(self, cache, key: str,
                       exclude=()) -> List[api.Pod]:
        """Members of `key` currently holding capacity (bound or
        assumed), from the cache's NodeInfos."""
        ns, _, name = key.partition("/")
        out = []
        for ni in cache.node_infos.values():
            for p in ni.pods:
                if (p.uid not in exclude and p.namespace == ns
                        and api.pod_group_name(p) == name):
                    out.append(p)
        return out

    def bound_count(self, cache, key: str, exclude=()) -> int:
        return len(self.placed_members(cache, key, exclude))

    def placed_by_gang(self, cache) -> Dict[str, List[api.Pod]]:
        """key -> placed members, one pass over the cache (feeds the
        preemption gang guard). Call only when self.active."""
        out: Dict[str, List[api.Pod]] = {}
        for ni in cache.node_infos.values():
            for p in ni.pods:
                k = self.key(p)
                if k is not None:
                    out.setdefault(k, []).append(p)
        return out

    def min_member_by_key(self, key: str,
                          sample: Optional[api.Pod] = None) -> int:
        """minMember for a gang known only by key (victim-side lookups);
        `sample` supplies the annotation fallback."""
        ns, _, name = key.partition("/")
        pg = self.store.get("podgroups", ns, name)
        if pg is not None:
            return max(int(pg.spec.min_member), 1)
        if sample is not None:
            m = api.pod_group_min_available(sample)
            if m is not None:
                return max(m, 1)
        return 1
