"""kubernetes_tpu_torch's API server (server/apiserver.py, a copy of the
JAX package's) against kubernetes_tpu's, request by request.

The same sequence of raw HTTP requests goes to a port APIServer and to a
JAX APIServer, each over an empty in-process store: create, get, list
(with a label selector too), a duplicate create (409), a GET and a
DELETE of a missing object (404), the binding subresource and a second
binding to another node (409), a merge patch, a watch from a
resourceVersion, the `410 Gone` of a watch older than the event window,
a malformed selector (400), /healthz, /version and /metrics. The status
codes and the bodies must be equal, apart from uid, creationTimestamp
and resourceVersion, which are masked. The port's RESTClient is then
held against the JAX server: every verb it speaks gets the same answers
as JAX's RESTClient, and the `rest.request` fault point fires as often in
both packages.
"""

import json
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu.client import rest as jrest
from kubernetes_tpu.runtime.store import ObjectStore as JaxStore
from kubernetes_tpu.server import APIServer as JaxAPIServer
from kubernetes_tpu.utils import faultpoints as jfp
from kubernetes_tpu_torch.client import rest as trest
from kubernetes_tpu_torch.runtime.store import ObjectStore as TorchStore
from kubernetes_tpu_torch.server import APIServer as TorchAPIServer
from kubernetes_tpu_torch.utils import faultpoints as tfp

from torch_guard import faults_off  # noqa: F401

MASKED = ("uid", "creationTimestamp", "resourceVersion")


def mask(x):
    """The body with the keys the two servers may differ on masked."""
    if isinstance(x, dict):
        return {k: ("*" if k in MASKED else mask(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [mask(v) for v in x]
    return x


def node_body(name):
    return {"kind": "Node", "apiVersion": "v1",
            "metadata": {"name": name,
                         "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                       "pods": "110"},
                       "conditions": [{"type": "Ready",
                                       "status": "True"}]}}


def pod_body(name, app="web"):
    return {"kind": "Pod", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": "default",
                         "labels": {"app": app}},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "100m", "memory": "64Mi"}}}]}}


def call(url, method, path, body=None, query=""):
    """One request -> (status, parsed body). A watch stream's lines are
    parsed one by one; a non-JSON body is kept as text."""
    full = url + path + (f"?{query}" if query else "")
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(full, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            code, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    text = raw.decode()
    if "watch=true" in query:
        return code, [json.loads(ln) for ln in text.splitlines() if ln]
    try:
        return code, json.loads(text)
    except ValueError:
        return code, text


def sequence(url, broadcaster):
    """The request sequence; returns [(step, status, masked body)]."""
    out = []

    def step(name, method, path, body=None, query=""):
        code, got = call(url, method, path, body, query)
        out.append((name, code, mask(got)))
        return code, got

    pods = "/api/v1/namespaces/default/pods"
    step("healthz", "GET", "/healthz")
    step("version", "GET", "/version")
    step("create node", "POST", "/api/v1/nodes", node_body("n1"))
    step("create pod", "POST", pods, pod_body("p1"))
    _, p2 = step("create pod 2", "POST", pods, pod_body("p2", app="db"))
    step("duplicate create", "POST", pods, pod_body("p1"))
    step("get", "GET", f"{pods}/p1")
    step("get missing", "GET", f"{pods}/nope")
    step("delete missing", "DELETE", f"{pods}/nope")
    step("list", "GET", pods)
    step("list by label", "GET", pods, query="labelSelector=app%3Ddb")
    step("bad selector", "GET", pods, query="labelSelector=app%3D%3D%3D")
    step("list nodes", "GET", "/api/v1/nodes")
    step("bind", "POST", f"{pods}/p1/binding",
         {"kind": "Binding", "apiVersion": "v1",
          "metadata": {"name": "p1"},
          "target": {"kind": "Node", "name": "n1"}})
    step("bind elsewhere", "POST", f"{pods}/p1/binding",
         {"kind": "Binding", "apiVersion": "v1",
          "metadata": {"name": "p1"},
          "target": {"kind": "Node", "name": "n2"}})
    step("get bound", "GET", f"{pods}/p1")
    step("patch", "PATCH", f"{pods}/p2",
         {"metadata": {"labels": {"tier": "backend"}}})
    rv = int(p2["metadata"]["resourceVersion"])
    step("watch from rv", "GET", pods,
         query=f"watch=true&resourceVersion={rv}&timeoutSeconds=0.5")
    step("delete", "DELETE", f"{pods}/p2")
    step("get deleted", "GET", f"{pods}/p2")
    broadcaster._window = 2
    for i in range(6):
        step(f"create filler {i}", "POST", pods, pod_body(f"f{i}"))
    step("watch too old", "GET", pods,
         query="watch=true&resourceVersion=1&timeoutSeconds=0.5")
    step("metrics", "GET", "/metrics")
    return out


@pytest.fixture()
def servers():
    got = {"jax": JaxAPIServer(JaxStore()).start(),
           "torch": TorchAPIServer(TorchStore()).start()}
    yield got
    for srv in got.values():
        srv.stop()


def test_request_sequence_matches_jax(servers):
    want = sequence(servers["jax"].url, servers["jax"].broadcaster)
    got = sequence(servers["torch"].url, servers["torch"].broadcaster)
    assert [s[:2] for s in got] == [s[:2] for s in want]
    for w, g in zip(want, got):
        assert g == w, w[0]
    codes = {name: code for name, code, _ in got}
    assert codes["duplicate create"] == 409
    assert codes["get missing"] == codes["delete missing"] == 404
    assert codes["get deleted"] == 404
    assert codes["bad selector"] == 400
    assert codes["watch too old"] == 410
    bound = dict((name, body) for name, _, body in got)["get bound"]
    assert bound["spec"]["nodeName"] == "n1"
    assert codes["bind elsewhere"] == 409
    events = dict((name, body) for name, _, body in got)["watch from rv"]
    assert [(e["type"], e["object"]["metadata"]["name"]) for e in events] \
        == [("MODIFIED", "p1"), ("MODIFIED", "p2")]


def _client_calls(rest, pkg_api, url):
    """Every verb of one package's RESTClient against `url`; returns
    (step, result or (code, reason)) pairs, objects encoded on the
    wire."""
    scheme = pkg_api["scheme"]
    api = pkg_api["types"]
    c = rest.RESTClient(url)
    out = []

    def step(name, fn):
        try:
            got = fn()
        except rest.APIStatusError as e:
            got = (e.code, e.reason)
        if hasattr(got, "metadata"):
            got = mask(scheme.encode_object(got))
        elif isinstance(got, tuple) and got and isinstance(got[0], list):
            got = ([mask(scheme.encode_object(o)) for o in got[0]], "*")
        out.append((name, got))

    def pod(name):
        return api.Pod(
            metadata=api.ObjectMeta(name=name, uid=f"uid-{name}",
                                    labels={"app": "w"}),
            spec=api.PodSpec(containers=[api.Container(
                resources=api.ResourceRequirements(
                    requests=api.resource_list(cpu="100m",
                                               memory="64Mi")))]))

    node = api.Node(metadata=api.ObjectMeta(name="n1", uid="uid-n1"),
                    status=api.NodeStatus(
                        allocatable=api.resource_list(cpu="4", memory="8Gi",
                                                      pods=110)))
    step("create node", lambda: c.create("nodes", node))
    step("create", lambda: c.create("pods", pod("a")))
    step("create b", lambda: c.create("pods", pod("b")))
    step("duplicate", lambda: c.create("pods", pod("a")))
    step("get", lambda: c.get("pods", "default", "a"))
    step("get missing", lambda: c.get("pods", "default", "zz"))
    step("list", lambda: c.list("pods"))
    step("list paged", lambda: c.list_paged("pods", page_size=1))
    step("list selector", lambda: c.list("pods", label_selector={"app": "w"}))
    step("bind", lambda: c.bind("default", "a", "n1"))
    step("patch", lambda: c.patch("pods", "default", "b",
                                  {"metadata": {"labels": {"x": "y"}}}))
    step("evict", lambda: c.evict("default", "b"))
    step("delete", lambda: c.delete("pods", "default", "a"))
    step("delete missing", lambda: c.delete("pods", "default", "a"))
    step("final list", lambda: c.list("pods"))
    return out


def test_rest_client_matches_jax_against_the_jax_server():
    """The port's RESTClient and JAX's, each against a fresh JAX
    APIServer: the same answers verb for verb, and rest.request firing
    once a round trip in both packages."""
    from kubernetes_tpu.api import scheme as jscheme
    from kubernetes_tpu.api import types as japi
    from kubernetes_tpu_torch.api import scheme as tscheme
    from kubernetes_tpu_torch.api import types as tapi

    got = {}
    for side, rest, mods, fp in (
            ("jax", jrest, {"scheme": jscheme, "types": japi}, jfp),
            ("torch", trest, {"scheme": tscheme, "types": tapi}, tfp)):
        srv = JaxAPIServer(JaxStore()).start()
        try:
            fp.activate("rest.request", "latency", arg=0.0)
            got[side] = (_client_calls(rest, mods, srv.url),
                         fp.hits("rest.request"))
        finally:
            fp.reset()
            srv.stop()
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1] > 0
    codes = dict(got["torch"][0])
    assert codes["duplicate"] == (409, "AlreadyExists")
    assert codes["get missing"][0] == 404


def test_rest_request_drop_fails_the_round_trip_as_in_jax():
    """A `drop`-armed rest.request never reaches the wire: both clients
    raise OSError and the server counts no request."""
    for rest, fp in ((jrest, jfp), (trest, tfp)):
        srv = JaxAPIServer(JaxStore()).start()
        try:
            fp.activate("rest.request", "drop", times=1)
            with pytest.raises(OSError, match="rest.request fault"):
                rest.RESTClient(srv.url).list("pods")
            assert fp.hits("rest.request") == 1
            assert not srv.request_count
            assert rest.RESTClient(srv.url).list("pods")[0] == []
        finally:
            fp.reset()
            srv.stop()
