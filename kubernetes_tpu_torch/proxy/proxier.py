"""Service VIP proxier: change trackers + the rule-sync loop + dataplane.

A copy of kubernetes_tpu/proxy/proxier.py; its relative imports resolve in this
package.

Reference: pkg/proxy/ (11.3k LoC). The structure here mirrors the real
proxier's three layers, rebuilt for an in-process dataplane:

- Change trackers (pkg/proxy/service.go:103 ServiceChangeTracker,
  pkg/proxy/endpoints.go EndpointChangeTracker): informer events record
  {previous, current} pairs per namespaced name; sync applies the pending
  set into live maps and computes staleness (UDP conntrack cleanup) and
  per-service local-endpoint counts (healthcheck).
- syncProxyRules (pkg/proxy/iptables/proxier.go:612): one full-table
  rebuild translating (services x endpoints) into chain-structured rules
  — per service-port "svc chains" reachable via cluster IP, node port,
  external IPs and LB ingress IPs, each pointing at "sep" endpoint
  entries (iptables KUBE-SVC-*/KUBE-SEP-* analog).
- Dataplane lookups: round-robin backend pick (the iptables
  --mode random --probability ladder analog), ClientIP session affinity
  with timeout (iptables `recent` analog, proxier.go:828),
  externalTrafficPolicy=Local filtering (proxier.go:1289), and a
  conntrack flow table whose stale UDP entries are deleted on endpoint
  removal (proxier.go:654 deleteEndpointConnections).

A hollow proxy (kubemark hollow_proxy.go:48) is this table without an
enforcement backend — which is exactly what this is, so kubemark reuses
Proxier directly.
"""

from __future__ import annotations

import itertools
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..api import types as api
from ..runtime.informer import SharedInformer

ServicePortName = Tuple[str, str, str]  # (namespace, service, port name)


@dataclass(frozen=True)
class Endpoint:
    """One backend (a KUBE-SEP chain analog; pkg/proxy/endpoints.go
    endpointsInfo)."""

    ip: str
    port: int
    is_local: bool = False
    ready: bool = True


@dataclass
class ProxyRule:
    """One service-port forwarding entry (a KUBE-SVC chain analog;
    pkg/proxy/service.go BaseServiceInfo)."""

    namespace: str
    service: str
    port_name: str
    cluster_ip: str
    port: int
    protocol: str
    endpoints: List[Endpoint] = field(default_factory=list)
    session_affinity: str = "None"
    affinity_timeout: float = 10800.0
    node_port: int = 0
    external_ips: List[str] = field(default_factory=list)
    lb_ingress_ips: List[str] = field(default_factory=list)
    external_policy_local: bool = False
    health_check_node_port: int = 0
    # False when cluster_ip is a display-only fallback (no allocator ran);
    # such IPs are excluded from VIP routing
    cluster_ip_allocated: bool = True

    @property
    def backends(self) -> List[Tuple[str, int]]:
        """Ready (ip, port) pairs — kept as the stable public view the
        kubemark and CLI layers read."""
        return [(e.ip, e.port) for e in self.endpoints if e.ready]

    def local_endpoints(self) -> List[Endpoint]:
        return [e for e in self.endpoints if e.ready and e.is_local]


class HealthCheckServer:
    """Per-service local-endpoint health state (pkg/proxy/healthcheck/
    healthcheck.go:117 server.SyncServices/SyncEndpoints).

    For every LoadBalancer service with externalTrafficPolicy=Local the
    cloud LB probes healthCheckNodePort; the answer is 200 iff this node
    has ≥1 ready local endpoint. `probe(port)` is that answer.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._ports: Dict[int, Tuple[ServicePortName, int]] = {}

    def sync(self, rules: Dict[ServicePortName, ProxyRule]):
        with self._lock:
            self._ports = {
                r.health_check_node_port: ((r.namespace, r.service,
                                            r.port_name),
                                           len(r.local_endpoints()))
                for r in rules.values()
                if r.external_policy_local and r.health_check_node_port}

    def probe(self, port: int) -> Tuple[int, dict]:
        with self._lock:
            if port not in self._ports:
                return 404, {}
            spn, n = self._ports[port]
            status = 200 if n > 0 else 503
            return status, {"service": "/".join(spn[:2]),
                            "localEndpoints": n}


class Proxier:
    def __init__(self, store, node_name: str = "", min_sync_period: float = 0.0,
                 clock=time.monotonic):
        self.store = store
        self.node_name = node_name
        self.clock = clock
        self._lock = threading.Lock()
        self.rules: Dict[ServicePortName, ProxyRule] = {}
        self._by_vip: Dict[Tuple[str, int, str], ServicePortName] = {}
        self._by_node_port: Dict[Tuple[int, str], ServicePortName] = {}
        self.sync_count = 0
        self._rr = itertools.count()
        # ClientIP session affinity: (spn, client) -> (endpoint, last use)
        self._affinity: Dict[Tuple[ServicePortName, str],
                             Tuple[Endpoint, float]] = {}
        # active flows: (proto, spn, client, ep) -> last-use time.
        # Entries expire by idle timeout at sync (the kernel conntrack
        # timeout analog) so the table is bounded even under TCP churn.
        self._conntrack: Dict[Tuple[str, ServicePortName, str,
                                    Tuple[str, int]], float] = {}
        self.flow_idle_timeout = 300.0
        self.stale_flows_deleted = 0
        self.healthcheck = HealthCheckServer()
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.min_sync_period = min_sync_period

        # informer events only mark the table dirty; the staleness diff is
        # computed old-rules-vs-new-rules at sync. The reference's change
        # trackers diff previous-vs-current *objects*, but this store hands
        # informers live references that controllers mutate in place, so an
        # object-level prev is unreliable — the rule table IS the durable
        # previous state, and diffing it catches exactly the same removals
        # (detectStaleConnections' output) without aliasing hazards.
        for kind in ("services", "endpoints"):
            SharedInformer(store, kind).add_event_handler(
                on_add=lambda o: self._dirty.set(),
                on_update=lambda o, n: self._dirty.set(),
                on_delete=lambda o: self._dirty.set())
        self.sync_proxy_rules()

    # -- the hot loop (syncProxyRules) -----------------------------------------

    def sync_proxy_rules(self):
        """Full table rebuild from informer state (proxier.go:612 — the
        reference also always rebuilds the full rule set; the trackers
        exist for consistency + staleness, not partial rebuilds)."""
        # clear the dirty flag BEFORE reading state: an event landing
        # mid-sync re-arms it so the next wait() syncs again instead of
        # being lost (the reference's async runner has the same contract)
        self._dirty.clear()
        new_rules: Dict[ServicePortName, ProxyRule] = {}
        eps_by_key = {(e.metadata.namespace, e.metadata.name): e
                      for e in self.store.list("endpoints")}
        for svc in self.store.list("services"):
            if svc.spec.type == "ExternalName":
                continue  # no dataplane rules (proxier.go service.go:87)
            ns, name = svc.metadata.namespace, svc.metadata.name
            ep = eps_by_key.get((ns, name))
            lb_ips = [i.ip for i in svc.status.load_balancer.ingress if i.ip]
            ports = svc.spec.ports or [api.ServicePort(port=0)]
            for sp in ports:
                endpoints: List[Endpoint] = []
                if ep is not None:
                    for subset in ep.subsets:
                        tp = next((p.port for p in subset.ports
                                   if p.name == sp.name), None)
                        if tp is None and subset.ports:
                            tp = subset.ports[0].port
                        for addr in subset.addresses:
                            endpoints.append(Endpoint(
                                ip=addr.ip, port=tp or sp.port,
                                is_local=(addr.node_name == self.node_name),
                                ready=True))
                        for addr in subset.not_ready_addresses:
                            endpoints.append(Endpoint(
                                ip=addr.ip, port=tp or sp.port,
                                is_local=(addr.node_name == self.node_name),
                                ready=False))
                # fallback VIP for display when none was allocated: stable
                # across runs (crc32, not seeded hash()); NOT registered as
                # a routing key below — only explicitly-set cluster IPs
                # route, so a crc collision can't misdirect traffic
                crc = zlib.crc32(f"{ns}/{name}".encode())
                new_rules[(ns, name, sp.name)] = ProxyRule(
                    namespace=ns, service=name, port_name=sp.name,
                    cluster_ip=svc.spec.cluster_ip or
                    f"172.16.{crc % 255}.{crc // 255 % 254 + 1}",
                    cluster_ip_allocated=bool(svc.spec.cluster_ip),
                    port=sp.port, protocol=sp.protocol,
                    endpoints=sorted(endpoints, key=lambda e: (e.ip, e.port)),
                    session_affinity=svc.spec.session_affinity,
                    affinity_timeout=float(svc.spec.session_affinity_timeout),
                    node_port=sp.node_port,
                    external_ips=list(svc.spec.external_ips),
                    lb_ingress_ips=lb_ips,
                    external_policy_local=(
                        svc.spec.external_traffic_policy == "Local"),
                    health_check_node_port=svc.spec.health_check_node_port)
        by_vip, by_np = {}, {}
        for spn, r in new_rules.items():
            vips = r.external_ips + r.lb_ingress_ips
            if r.cluster_ip_allocated:
                vips = [r.cluster_ip] + vips
            for ip in vips:
                by_vip[(ip, r.port, r.protocol)] = spn
            if r.node_port:
                by_np[(r.node_port, r.protocol)] = spn
        with self._lock:
            old_rules, self.rules = self.rules, new_rules
            self._by_vip = by_vip
            self._by_node_port = by_np
            self.sync_count += 1
            self._cleanup_stale_locked(old_rules, new_rules)
        self.healthcheck.sync(new_rules)

    def _cleanup_stale_locked(self, old_rules, new_rules):
        """Delete UDP flows made stale by this sync: flows to backend IPs
        that left the rule table (proxier.go:654 deleteEndpointConnections)
        and flows of service ports that no longer exist — deleted or
        type-changed services (deleteServiceConnections). TCP flows die on
        their own via RST; UDP conntrack entries would otherwise blackhole
        the client until timeout. Also drops affinity state of vanished
        rules and expires idle flows/aged affinity entries so both tables
        stay bounded."""
        removed: Dict[ServicePortName, Set[str]] = {}
        for spn, old in old_rules.items():
            cur = new_rules.get(spn)
            # only ready endpoints count on EITHER side: the reference
            # EndpointsMap holds ss.Addresses only, so a ready->notReady
            # transition is stale (proxier.go detectStaleConnections) and
            # a stays-notReady endpoint is absent from both snapshots
            cur_ips = ({e.ip for e in cur.endpoints if e.ready}
                       if cur else set())
            gone = {e.ip for e in old.endpoints if e.ready} - cur_ips
            if gone:
                removed[spn] = gone
        stale = []
        for f in self._conntrack:
            proto, spn, _client, (ip, _port) = f
            if proto != "UDP":
                continue
            if spn not in new_rules or ip in removed.get(spn, ()):
                stale.append(f)
        for f in stale:
            del self._conntrack[f]
            self._affinity.pop((f[1], f[2]), None)
            self.stale_flows_deleted += 1
        now = self.clock()
        # affinity of vanished rules dies with the rule (any protocol);
        # surviving entries expire by their rule's timeout
        for k in [k for k, (_ep, last) in self._affinity.items()
                  if k[0] not in new_rules
                  or now - last > new_rules[k[0]].affinity_timeout]:
            del self._affinity[k]
        # idle expiry (kernel conntrack timeout analog)
        for f in [f for f, ts in self._conntrack.items()
                  if now - ts > self.flow_idle_timeout]:
            del self._conntrack[f]

    # -- dataplane lookups -----------------------------------------------------

    def _pick(self, rule: ProxyRule, spn: ServicePortName,
              client_ip: str, node_local: bool) -> Optional[Tuple[str, int]]:
        pool = (rule.local_endpoints() if node_local
                else [e for e in rule.endpoints if e.ready])
        if not pool:
            return None
        now = self.clock()
        if rule.session_affinity == "ClientIP" and client_ip:
            hit = self._affinity.pop((spn, client_ip), None)
            if hit is not None:
                ep, last = hit
                if now - last <= rule.affinity_timeout and ep in pool:
                    self._affinity[(spn, client_ip)] = (ep, now)
                    return (ep.ip, ep.port)
            ep = pool[next(self._rr) % len(pool)]
            self._affinity[(spn, client_ip)] = (ep, now)
        else:
            ep = pool[next(self._rr) % len(pool)]
        self._conntrack[(rule.protocol, spn, client_ip, (ep.ip, ep.port))] = now
        return (ep.ip, ep.port)

    def resolve(self, namespace: str, service: str, port_name: str = "",
                client_ip: str = "") -> Optional[Tuple[str, int]]:
        """Pick a backend for a new connection arriving at the cluster IP
        (round-robin — the iptables-probability analog), honoring
        ClientIP session affinity when configured."""
        with self._lock:
            spn = (namespace, service, port_name)
            rule = self.rules.get(spn)
            if rule is None:
                return None
            return self._pick(rule, spn, client_ip, node_local=False)

    def resolve_vip(self, ip: str, port: int, protocol: str = "TCP",
                    client_ip: str = "") -> Optional[Tuple[str, int]]:
        """Route a packet addressed to any VIP this proxier programs:
        cluster IP, external IP, or LB ingress IP (the KUBE-SERVICES
        dispatch chain). External/LB traffic respects
        externalTrafficPolicy=Local (proxier.go:1289: the XLB chain only
        DNATs to local endpoints)."""
        with self._lock:
            spn = self._by_vip.get((ip, port, protocol))
            if spn is None:
                return None
            rule = self.rules[spn]
            external = ip != rule.cluster_ip
            local = external and rule.external_policy_local
            return self._pick(rule, spn, client_ip, node_local=local)

    def resolve_node_port(self, port: int, protocol: str = "TCP",
                          client_ip: str = "") -> Optional[Tuple[str, int]]:
        """Route a packet arriving on a node port (KUBE-NODEPORTS chain).
        Under externalTrafficPolicy=Local only this node's endpoints are
        eligible and client source is preserved (no SNAT)."""
        with self._lock:
            spn = self._by_node_port.get((port, protocol))
            if spn is None:
                return None
            rule = self.rules[spn]
            return self._pick(rule, spn, client_ip,
                              node_local=rule.external_policy_local)

    def health(self) -> dict:
        with self._lock:
            return {"rules": len(self.rules), "syncs": self.sync_count,
                    "staleFlowsDeleted": self.stale_flows_deleted}

    # -- background mode -------------------------------------------------------

    def run(self, period: float = 1.0):
        def loop():
            while not self._stop.is_set():
                if self._dirty.wait(period):
                    if self.min_sync_period:
                        time.sleep(self.min_sync_period)
                    self.sync_proxy_rules()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"proxier-{self.node_name}")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
