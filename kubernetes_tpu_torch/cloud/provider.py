"""Cloud provider interface + fake implementation.

A copy of kubernetes_tpu/cloud/provider.py; its relative imports
resolve in this package.

Reference: pkg/cloudprovider/cloud.go — the Interface every provider
(aws/azure/gce/...) implements, consumed by the service LB, route and
cloud-node controllers. The reference ships 55k LoC of per-cloud
implementations; here the surface is the interface plus the fake
(pkg/cloudprovider/providers/fake/fake.go), which is what every
reference controller test runs against too. Real TPU-pod deployments
sit behind the same seam: a provider whose Instances are TPU VM workers
and whose Routes program the pod network is a drop-in.
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
class Route:
    """One pod-network route (cloud.go Route): traffic for dest_cidr goes
    to target_node."""

    name: str
    target_node: str
    dest_cidr: str


@dataclass
class Zone:
    failure_domain: str = ""
    region: str = ""


class LoadBalancer:
    """cloud.go LoadBalancer interface."""

    def get_load_balancer(self, cluster: str, service: api.Service
                          ) -> Tuple[Optional[api.LoadBalancerStatus], bool]:
        raise NotImplementedError

    def ensure_load_balancer(self, cluster: str, service: api.Service,
                             nodes: List[api.Node]) -> api.LoadBalancerStatus:
        raise NotImplementedError

    def update_load_balancer(self, cluster: str, service: api.Service,
                             nodes: List[api.Node]) -> None:
        raise NotImplementedError

    def ensure_load_balancer_deleted(self, cluster: str,
                                     service: api.Service) -> None:
        raise NotImplementedError


class Instances:
    """cloud.go Instances interface."""

    def node_addresses(self, name: str) -> List[api.NodeAddress]:
        raise NotImplementedError

    def instance_id(self, name: str) -> str:
        raise NotImplementedError

    def instance_type(self, name: str) -> str:
        raise NotImplementedError

    def instance_exists_by_provider_id(self, provider_id: str) -> bool:
        raise NotImplementedError


class Zones:
    def get_zone_by_node_name(self, name: str) -> Zone:
        raise NotImplementedError

    def get_zone(self) -> Zone:
        """The zone the caller's resources land in by default
        (cloud.go Zones.GetZone — consumed by the PersistentVolumeLabel
        admission plugin)."""
        raise NotImplementedError


class Routes:
    """cloud.go Routes interface."""

    def list_routes(self, cluster: str) -> List[Route]:
        raise NotImplementedError

    def create_route(self, cluster: str, name_hint: str, route: Route) -> None:
        raise NotImplementedError

    def delete_route(self, cluster: str, route: Route) -> None:
        raise NotImplementedError


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

    def group(self, name: str) -> Optional[NodeGroup]:
        return next((g for g in self.groups() if g.name == name), None)

    def increase_size(self, name: str, delta: int) -> List[str]:
        raise NotImplementedError

    def delete_nodes(self, name: str, node_names: List[str]) -> None:
        raise NotImplementedError

    def template_node(self, name: str) -> api.Node:
        g = self.group(name)
        if g is None:
            raise KeyError(f"node group {name} not found")
        return g.template


class CloudProvider:
    """cloud.go Interface: each accessor returns the sub-interface or None
    when the cloud doesn't support that capability (the Go (iface, bool)
    pair)."""

    provider_name = ""

    def load_balancer(self) -> Optional[LoadBalancer]:
        return None

    def instances(self) -> Optional[Instances]:
        return None

    def zones(self) -> Optional[Zones]:
        return None

    def routes(self) -> Optional[Routes]:
        return None

    def node_groups(self) -> Optional[NodeGroups]:
        return None


# -- fake ----------------------------------------------------------------------


@dataclass
class FakeInstance:
    addresses: List[api.NodeAddress] = field(default_factory=list)
    instance_id: str = ""
    instance_type: str = "fake.small"
    zone: Zone = field(default_factory=Zone)


class FakeCloud(CloudProvider, LoadBalancer, Instances, Zones, Routes,
                NodeGroups):
    """In-memory provider recording every mutation (fake.go FakeCloud),
    used by controller tests and the kubemark-style local stack."""

    provider_name = "fake"

    def __init__(self):
        self._lock = threading.Lock()
        self.default_zone = Zone(failure_domain="z0", region="r0")
        self.instances_by_name: Dict[str, FakeInstance] = {}
        self.balancers: Dict[str, Tuple[api.LoadBalancerStatus, List[str]]] = {}
        self.route_table: Dict[str, Route] = {}
        self.calls: List[str] = []
        self.next_ip = 1
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

    # CloudProvider
    def load_balancer(self):
        return self

    def instances(self):
        return self

    def zones(self):
        return self

    def routes(self):
        return self

    # LoadBalancer
    @staticmethod
    def _lb_name(service: api.Service) -> str:
        return f"{service.metadata.namespace}/{service.metadata.name}"

    def get_load_balancer(self, cluster, service):
        with self._lock:
            self._record("get-load-balancer")
            hit = self.balancers.get(self._lb_name(service))
            return (hit[0], True) if hit else (None, False)

    def ensure_load_balancer(self, cluster, service, nodes):
        with self._lock:
            self._record("ensure-load-balancer")
            name = self._lb_name(service)
            if name in self.balancers:
                status = self.balancers[name][0]
            else:
                ip = service.spec.load_balancer_ip or f"203.0.113.{self.next_ip}"
                self.next_ip += 1
                status = api.LoadBalancerStatus(
                    ingress=[api.LoadBalancerIngress(ip=ip)])
            self.balancers[name] = (status, sorted(n.name for n in nodes))
            return status

    def update_load_balancer(self, cluster, service, nodes):
        with self._lock:
            self._record("update-load-balancer")
            name = self._lb_name(service)
            if name in self.balancers:
                self.balancers[name] = (self.balancers[name][0],
                                        sorted(n.name for n in nodes))

    def ensure_load_balancer_deleted(self, cluster, service):
        with self._lock:
            self._record("ensure-load-balancer-deleted")
            self.balancers.pop(self._lb_name(service), None)

    # Instances
    def node_addresses(self, name):
        self._record("node-addresses")
        inst = self.instances_by_name.get(name)
        if inst is None:
            raise KeyError(f"instance {name} not found")
        return list(inst.addresses)

    def instance_id(self, name):
        self._record("instance-id")
        return self.instances_by_name[name].instance_id

    def instance_type(self, name):
        self._record("instance-type")
        return self.instances_by_name[name].instance_type

    def instance_exists_by_provider_id(self, provider_id):
        self._record("instance-exists")
        return any(i.instance_id == provider_id
                   for i in self.instances_by_name.values())

    # Zones
    def get_zone_by_node_name(self, name):
        self._record("get-zone")
        return self.instances_by_name[name].zone

    def get_zone(self):
        self._record("get-zone")
        return self.default_zone

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
        """Boot `delta` new instances of the group's shape. The chaos
        seam fires BEFORE any mutation so a `cloud.resize` raise models
        a rejected API call: target size and instances are untouched."""
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
        group; the chaos seam fires before any mutation."""
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

    # Routes
    def list_routes(self, cluster):
        with self._lock:
            self._record("list-routes")
            return list(self.route_table.values())

    def create_route(self, cluster, name_hint, route):
        with self._lock:
            self._record("create-route")
            self.route_table[f"{route.target_node}:{route.dest_cidr}"] = route

    def delete_route(self, cluster, route):
        with self._lock:
            self._record("delete-route")
            self.route_table.pop(f"{route.target_node}:{route.dest_cidr}", None)
