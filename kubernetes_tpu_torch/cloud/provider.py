"""Cloud provider: the node groups the cluster autoscaler sizes.

The part of kubernetes_tpu/cloud/provider.py that the autoscaler and its
tests use: the NodeGroup and its template node, the NodeGroups sizing
interface, the CloudProvider accessor for it, and the in-memory
FakeCloud (pkg/cloudprovider/providers/fake/fake.go) with its `joiner`
seam, through which a booted instance registers as a Node, and the
`cloud.resize` fault point before either resize mutates anything. The load
balancer, instance, zone and route interfaces of the reference's
cloud.go are not ported: no ported controller calls them.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..api import types as api
from ..utils import faultpoints

# Stamped by the cloud-node controller from Instances.instance_type;
# the cluster autoscaler infers NodeGroup membership from it.
LABEL_INSTANCE_TYPE = "beta.kubernetes.io/instance-type"
LABEL_HOSTNAME = "kubernetes.io/hostname"


@dataclass
class Zone:
    failure_domain: str = ""
    region: str = ""


@dataclass
class NodeGroup:
    """One elastically sized set of identically shaped machines
    (autoscaler cloudprovider.NodeGroup: MinSize/MaxSize/TargetSize +
    TemplateNodeInfo). `template` is the Node every member boots as —
    allocatable, labels, taints — which is also what the autoscaler
    featurizes into *virtual* snapshot rows for the scale-up what-if.
    Membership of live nodes is inferred from the instance-type label
    the cloud-node controller stamps."""

    name: str
    template: api.Node
    min_size: int = 0
    max_size: int = 10
    target_size: int = 0
    instance_type: str = ""
    price: float = 1.0  # relative per-node cost (cheapest-expansion pick)


def node_from_template(group: NodeGroup, name: str) -> api.Node:
    """Instantiate a member Node from a group's template (autoscaler
    TemplateNodeInfo -> simulated node object): template allocatable /
    labels / taints plus the identity labels a real boot would carry."""
    t = group.template
    labels = dict(t.metadata.labels or {})
    labels[LABEL_INSTANCE_TYPE] = group.instance_type or group.name
    labels[LABEL_HOSTNAME] = name
    alloc = dict(t.status.allocatable)
    return api.Node(
        metadata=api.ObjectMeta(name=name, labels=labels,
                                annotations=dict(t.metadata.annotations or {})),
        spec=api.NodeSpec(taints=copy.deepcopy(t.spec.taints)),
        status=api.NodeStatus(
            capacity=dict(alloc), allocatable=alloc,
            conditions=[api.NodeCondition(api.NODE_READY, api.COND_TRUE)]))


class NodeGroups:
    """Autoscaler-facing sizing interface (autoscaler cloudprovider
    .CloudProvider: NodeGroups()/NodeGroupForNode + per-group
    IncreaseSize/DeleteNodes). Sizes are TARGETS: increase_size returns
    the instance names the cloud is booting; they become Nodes only when
    they register (the joiner seam on the fake)."""

    def groups(self) -> List[NodeGroup]:
        raise NotImplementedError

    def increase_size(self, name: str, delta: int) -> List[str]:
        raise NotImplementedError

    def delete_nodes(self, name: str, node_names: List[str]) -> None:
        raise NotImplementedError


class CloudProvider:
    """cloud.go Interface, reduced to the node-group accessor: None when
    the cloud does not support autoscaling (the Go (iface, bool)
    pair)."""

    def node_groups(self) -> Optional[NodeGroups]:
        return None


# -- fake ----------------------------------------------------------------------


@dataclass
class FakeInstance:
    addresses: List[api.NodeAddress] = field(default_factory=list)
    instance_id: str = ""
    instance_type: str = "fake.small"
    zone: Zone = field(default_factory=Zone)


class FakeCloud(CloudProvider, NodeGroups):
    """In-memory provider recording every mutation (fake.go FakeCloud),
    used by the autoscaler's tests and the smoke run."""

    def __init__(self):
        self._lock = threading.Lock()
        self.default_zone = Zone(failure_domain="z0", region="r0")
        self.instances_by_name: Dict[str, FakeInstance] = {}
        self.calls: List[str] = []
        # monotonic auto-IP counter: `10.1.0.{len+1}` collided with a
        # live instance's address after any delete-then-add sequence
        # (len shrinks back over an issued suffix)
        self._ip_seq = 0
        self.fail_next: Dict[str, Exception] = {}  # call name -> error to raise
        # node groups (autoscaler seam)
        self.groups_by_name: Dict[str, NodeGroup] = {}
        self._instance_group: Dict[str, str] = {}  # instance -> group name
        self._group_seq: Dict[str, int] = {}
        # joiner(group, instance_name): how a booted instance becomes a
        # Node — tests/bench wire this to create the Node object in the
        # store (optionally after a simulated join latency); None means
        # instances boot but never register, which is also a real cloud
        # failure mode the autoscaler must tolerate
        self.joiner: Optional[Callable[[NodeGroup, str], None]] = None

    # test hooks
    def add_instance(self, name: str, internal_ip: str = "",
                     zone: str = "z0", region: str = "r0",
                     instance_type: str = "fake.small"):
        if not internal_ip:
            self._ip_seq += 1
            internal_ip = f"10.1.0.{self._ip_seq}"
        self.instances_by_name[name] = FakeInstance(
            addresses=[api.NodeAddress("InternalIP", internal_ip),
                       api.NodeAddress("Hostname", name)],
            instance_id=f"fake://{name}",
            instance_type=instance_type,
            zone=Zone(failure_domain=zone, region=region))

    def _record(self, call: str):
        self.calls.append(call)
        err = self.fail_next.pop(call, None)
        if err is not None:
            raise err

    # NodeGroups
    def node_groups(self):
        return self if self.groups_by_name else None

    def add_node_group(self, name: str, template: api.Node,
                       min_size: int = 0, max_size: int = 10,
                       price: float = 1.0,
                       instance_type: str = "") -> NodeGroup:
        """Register an elastically sized group whose members boot as
        copies of `template`. instance_type defaults to the group name
        (it is the membership key stamped on every member node)."""
        g = NodeGroup(name=name, template=template, min_size=min_size,
                      max_size=max_size, target_size=0,
                      instance_type=instance_type or name, price=price)
        with self._lock:
            self.groups_by_name[name] = g
        return g

    def groups(self) -> List[NodeGroup]:
        with self._lock:
            return list(self.groups_by_name.values())

    def increase_size(self, name: str, delta: int) -> List[str]:
        """Boot `delta` new instances of the group's shape. A call that
        raises (a `fail_next` entry, a bad delta) mutates nothing:
        target size and instances are untouched."""
        new: List[Tuple[NodeGroup, str]] = []
        with self._lock:
            self._record("increase-size")
            faultpoints.fire("cloud.resize",
                             payload=("increase_size", name, delta))
            g = self.groups_by_name.get(name)
            if g is None:
                raise KeyError(f"node group {name} not found")
            if delta <= 0:
                raise ValueError(f"increase_size delta must be > 0: {delta}")
            if g.target_size + delta > g.max_size:
                raise ValueError(
                    f"group {name}: size {g.target_size}+{delta} would "
                    f"exceed max {g.max_size}")
            for _ in range(delta):
                seq = self._group_seq.get(name, 0)
                self._group_seq[name] = seq + 1
                iname = f"{name}-{seq}"
                self.add_instance(iname, instance_type=g.instance_type,
                                  zone=self.default_zone.failure_domain,
                                  region=self.default_zone.region)
                self._instance_group[iname] = name
                new.append((g, iname))
            g.target_size += delta
        # join OUTSIDE the cloud lock: the joiner typically creates Node
        # objects, whose informer fan-out must not run under it
        if self.joiner is not None:
            for g, iname in new:
                self.joiner(g, iname)
        return [iname for _, iname in new]

    def delete_nodes(self, name: str, node_names: List[str]) -> None:
        """Tear down specific members (autoscaler DeleteNodes). Refuses
        to shrink below min_size or to touch an instance of another
        group; a call that raises mutates nothing."""
        with self._lock:
            self._record("delete-nodes")
            faultpoints.fire("cloud.resize",
                             payload=("delete_nodes", name, tuple(node_names)))
            g = self.groups_by_name.get(name)
            if g is None:
                raise KeyError(f"node group {name} not found")
            if g.target_size - len(node_names) < g.min_size:
                raise ValueError(
                    f"group {name}: deleting {len(node_names)} would drop "
                    f"below min {g.min_size}")
            for n in node_names:
                owner = self._instance_group.get(n)
                inst = self.instances_by_name.get(n)
                member = (owner == name
                          or (owner is None and inst is not None
                              and inst.instance_type == g.instance_type))
                if not member:
                    raise KeyError(f"instance {n} is not a member of {name}")
            for n in node_names:
                self.instances_by_name.pop(n, None)
                self._instance_group.pop(n, None)
            g.target_size -= len(node_names)
