"""The port's kubeadm (kubernetes_tpu_torch/cli/kubeadm.py, with
cli/kubeconfig.py) against the JAX package's, on the CPU.

Each case runs the JAX package's scenario through both packages, the
port's control plane with device="cpu", and compares what a user of the
cluster sees: exit codes and printed lines (tokens, addresses and
certificate bytes masked), the objects read back over REST, the HTTP
codes of what a credential may and may not do, and where each pod was
bound. The scenarios are tests/test_kubeadm_phases.py (phases,
preflight, the live upgrade), tests/test_bootstrap.py:179 (a cluster
boots and a Deployment's pods are scheduled; its kubectl apply becomes a
REST POST, the port has no kubectl), tests/test_auth.py:330-530 (a
secure join over CSR and mTLS), tests/test_bootstrap_tokens.py (a
forged discovery is rejected; token create, list and delete, TTL 0,
reset and version).

The port differs where it says so: its preflight checks torch and, for
the card, CUDA (JAX's checks jax); `device=None` means the CUDA card
and raises without one; and every path that needs the durable native
store raises NotImplementedError naming ROADMAP.md queue 1 item 2b.
"""

import contextlib
import importlib
import io
import re
import socket
import time

import pytest
import torch

from torch_guard import (faults_off, jax_watchdog_off,  # noqa: F401
                         torch_one_thread)

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")
TODO = "ROADMAP.md queue 1 item 2b"
_MASKS = ((re.compile(r"https?://127\.0\.0\.1:\d+"), "URL"),
          (re.compile(r"admin-[0-9a-f]{16}"), "ADMIN"),
          (re.compile(r"\b[0-9a-z]{6}\.[0-9a-z]{16}\b"), "TOKEN"),
          (re.compile(r"\b[0-9a-z]{6}\.\*{16}"), "TOKEN-ID"),
          (re.compile(r"\d+s\t"), "TTL\t"))


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def kubeadm(pkg):
    return mod(pkg, "cli.kubeadm")


def dev(pkg):
    return {"device": "cpu"} if pkg == "kubernetes_tpu_torch" else {}


def mask(text):
    for pat, sub in _MASKS:
        text = pat.sub(sub, text)
    return text


def run_main(pkg, *argv):
    """kubeadm main in one package: (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = kubeadm(pkg).main(list(argv), **dev(pkg))
    return rc, out.getvalue(), err.getvalue()


def both(run):
    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
    return got["kubernetes_tpu_torch"]


def held_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    return s


def cluster(pkg, **kw):
    c = kubeadm(pkg).Cluster(**dev(pkg), **kw)
    kubeadm(pkg).ensure_bootstrap_objects(c.store)
    return c


def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    return cond()


def web(pkg, replicas):
    api, lbl = mod(pkg, "api.types"), mod(pkg, "api.labels")
    return api.Deployment(
        metadata=api.ObjectMeta(name="web"),
        spec=api.DeploymentSpec(
            replicas=replicas,
            selector=lbl.LabelSelector(match_labels={"app": "web"}),
            template=api.PodTemplateSpec(
                metadata=api.ObjectMeta(labels={"app": "web"}),
                spec=api.PodSpec(containers=[api.Container(
                    name="c", resources=api.ResourceRequirements(
                        requests=api.resource_list(cpu="100m",
                                                   memory="64Mi")))]))))


def web_nodes(store):
    return sorted(p.spec.node_name for p in store.list("pods")
                  if (p.metadata.labels or {}).get("app") == "web")


# -- phases and preflight (tests/test_kubeadm_phases.py) ----------------------


@pytest.mark.parametrize("argv", [("phase", "list"), ("phase", "frobnicate"),
                                  ("phase", "certs"), ("version",)])
def test_a_phase_command_prints_as_in_jax(argv):
    rc, out, err = both(lambda pkg: run_main(pkg, *argv))
    if argv[1:] == ("list",):
        assert rc == 0
        for name in ("preflight", "certs", "bootstrap-objects",
                     "upload-config"):
            assert name in out
    elif argv == ("version",):
        assert rc == 0 and kubeadm(PKGS[1]).CLUSTER_VERSION in out
    else:
        assert rc == 1 and err


def test_preflight_fails_as_in_jax():
    s = held_port()
    port = s.getsockname()[1]
    try:
        errors = both(lambda pkg: kubeadm(pkg).phase_preflight(
            port=port, **dev(pkg)))
        assert any("port" in e for e in errors)
        assert both(lambda pkg: run_main(
            pkg, "phase", "preflight", "--port", str(port)))[0] == 1
        # init is gated on it
        rc, out, err = both(lambda pkg: run_main(
            pkg, "init", "--port", str(port), "--once"))
        assert rc == 1 and "preflight" in err
    finally:
        s.close()
    errors = both(lambda pkg: kubeadm(pkg).phase_preflight(
        data_dir="/proc/nope/kv", **dev(pkg)))
    assert any("writable" in e for e in errors)
    assert both(lambda pkg: kubeadm(pkg).phase_preflight(
        port=0, **dev(pkg))) == []
    assert both(lambda pkg: run_main(pkg, "phase", "preflight")) == \
        (0, "preflight passed\n", "")


def test_preflight_wants_a_card_unless_asked_for_the_cpu(monkeypatch):
    """The port's one change to preflight: torch, and the card for the
    default device."""
    ka = kubeadm("kubernetes_tpu_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    errors = ka.phase_preflight()
    assert len(errors) == 1 and "CUDA" in errors[0]
    assert ka.phase_preflight(device="cpu") == []
    assert ka.phase_preflight(device="cuda") == errors
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert ka.main(["init", "--once"]) == 1
    assert "CUDA" in err.getvalue() and "preflight" in err.getvalue()
    with pytest.raises(RuntimeError, match="CUDA"):
        ka.Cluster()


def test_data_dir_paths_refuse(tmp_path):
    """Every path that needs the native store raises, naming the queue
    item; none writes the directory or falls back to memory."""
    ka = kubeadm("kubernetes_tpu_torch")
    d = tmp_path / "kv"
    with pytest.raises(NotImplementedError, match=TODO):
        ka.Cluster(data_dir=str(d), device="cpu")
    for argv in (["init", "--once", "--data-dir", str(d)],
                 ["phase", "certs", "--data-dir", str(d)],
                 ["phase", "upload-config", "--data-dir", str(d)],
                 ["upgrade", "--data-dir", str(d)]):
        with pytest.raises(NotImplementedError, match=TODO):
            ka.main(argv, device="cpu")
    assert not d.exists()


# -- a cluster (tests/test_bootstrap.py:179) ----------------------------------


def test_init_boots_a_cluster_that_schedules_a_deployment_as_in_jax():
    def run(pkg):
        c = cluster(pkg, hollow_nodes=3)
        c.start()
        try:
            assert c.wait_ready(timeout=15)
            rest = mod(pkg, "client.rest").RESTClient(c.url)
            rest.create("deployments", web(pkg, 3))
            wait_for(lambda: len([n for n in web_nodes(c.store) if n]) == 3)
            return web_nodes(c.store), sorted(
                n.metadata.name for n in c.store.list("nodes"))
        finally:
            c.stop()
    bound, nodes = both(run)
    assert bound == nodes == ["hollow-0", "hollow-1", "hollow-2"]


def test_the_cli_init_once_prints_as_in_jax():
    def run(pkg):
        rc, out, err = run_main(pkg, "init", "--once", "--secure")
        lines = [mask(ln) for ln in out.splitlines()
                 if "kubectl" not in ln]
        return rc, lines
    rc, lines = both(run)
    assert rc == 0 and lines[0] == "control plane ready at URL"
    assert "  bootstrap token: TOKEN" in lines


def test_the_admin_kubeconfig_as_in_jax(tmp_path):
    """admin.conf resolves to the cluster's URL, CA and admin token."""
    def run(pkg):
        c = cluster(pkg, secure=True, reconcile_endpoints=False)
        c.start()
        try:
            path = tmp_path / f"{pkg}.conf"
            c.write_admin_kubeconfig(str(path))
            kc = mod(pkg, "cli.kubeconfig")
            got = kc.resolve(kc.load(str(path)))
            return sorted((k, {c.url: "URL", c.ca.ca_cert_pem: "CA",
                               c.admin_token: "ADMIN"}.get(v, v))
                          for k, v in got.items())
        finally:
            c.stop()
    got = dict(both(run))
    assert (got["server"], got["ca_pem"], got["token"]) == \
        ("URL", "CA", "ADMIN")


# -- a secure join (tests/test_auth.py:330, tests/test_bootstrap_tokens.py:99)


def test_a_secure_join_over_csr_as_in_jax():
    def run(pkg):
        api = mod(pkg, "api.types")
        rest = mod(pkg, "client.rest")
        ka = kubeadm(pkg)
        c = cluster(pkg, secure=True)
        c.start()
        codes = []

        def code(fn):
            try:
                fn()
                codes.append(200)
            except rest.APIStatusError as e:
                codes.append(e.code)
        try:
            assert c.url.startswith("https://")
            ca = ka.fetch_cluster_ca(c.url, token=c.bootstrap_token)
            with pytest.raises(RuntimeError, match="verification FAILED"):
                ka.fetch_cluster_ca(c.url, token="aaaaaa.0123456789abcdef")
            key, cert, ca_pem = ka.join_with_csr(c.url, "n1",
                                                 c.bootstrap_token)
            kubelet = rest.RESTClient(c.url, client_cert_pem=cert,
                                      client_key_pem=key, ca_cert_pem=ca_pem)
            admin = rest.RESTClient(c.url, token=c.admin_token,
                                    ca_cert_pem=ca_pem)
            boot = rest.RESTClient(c.url, token=c.bootstrap_token,
                                   ca_cert_pem=ca_pem)
            thief = rest.RESTClient(c.url, ca_cert_pem=ca_pem)
            code(lambda: kubelet.create("nodes", api.Node(
                metadata=api.ObjectMeta(name="n1", namespace=""))))
            admin.create("nodes", api.Node(
                metadata=api.ObjectMeta(name="n2", namespace="")))
            code(lambda: kubelet.update("nodes",
                                        admin.get("nodes", "", "n2")))
            code(lambda: kubelet.list("clusterroles", None))
            code(lambda: kubelet.list("secrets", "default"))
            code(lambda: kubelet.get("secrets", "kube-system", "cluster-ca"))
            code(lambda: thief.get("nodes", "", "n1"))
            code(lambda: thief.get("configmaps", "kube-public",
                                   "cluster-info"))
            code(lambda: boot.create("nodes", api.Node(
                metadata=api.ObjectMeta(name="n3", namespace=""))))
            key2, cert2, _ = ka.join_with_csr(c.url, "n1", c.bootstrap_token)
            again = rest.RESTClient(c.url, client_cert_pem=cert2,
                                    client_key_pem=key2, ca_cert_pem=ca_pem)
            csrs = c.store.list("certificatesigningrequests")
            return (ca == c.ca.ca_cert_pem, ca_pem == ca,
                    "BEGIN CERTIFICATE" in cert, codes,
                    again.get("nodes", "", "n1").metadata.name,
                    sorted((x.approved, bool(x.status.certificate))
                           for x in csrs))
        finally:
            c.stop()
    got = both(run)
    assert got[:3] == (True, True, True)
    assert got[3] == [200, 403, 403, 403, 403, 403, 200, 403]


def test_the_cli_join_as_in_jax():
    def run(pkg):
        c = cluster(pkg, secure=True, reconcile_endpoints=False)
        c.start()
        try:
            rc, out, err = run_main(pkg, "join", c.url, "--node-name", "j1",
                                    "--bootstrap-token", c.bootstrap_token,
                                    "--once")
            node = wait_for(lambda: any(
                n.metadata.name == "j1" for n in c.store.list("nodes")))
            return rc, mask(out), node
        finally:
            c.stop()
    rc, out, node = both(run)
    assert rc == 0 and node and "joined URL" in out


# -- the live upgrade (tests/test_kubeadm_phases.py:75) -----------------------


def test_the_live_upgrade_keeps_objects_and_scheduling_as_in_jax():
    def run(pkg):
        api = mod(pkg, "api.types")
        rest = mod(pkg, "client.rest")
        ka = kubeadm(pkg)
        c = cluster(pkg, secure=True, reconcile_endpoints=False)
        ka.phase_upload_config(c.store)
        c.start()
        hollow = rstore = None
        try:
            key, cert, ca_pem = ka.join_with_csr(c.url, "up-n1",
                                                 c.bootstrap_token)
            rstore = mod(pkg, "client.reflector").RemoteStore(
                rest.RESTClient(c.url, client_cert_pem=cert,
                                client_key_pem=key, ca_cert_pem=ca_pem))
            for kind in ("pods", "nodes"):
                rstore.mirror(kind)
            rstore.wait_for_sync()
            hollow = mod(pkg, "kubemark.hollow").HollowNode(
                rstore, "up-n1", allocatable=api.resource_list(
                    cpu="8", memory="16Gi", pods=20)).run(period=0.1)
            admin = rest.RESTClient(c.url, token=c.admin_token,
                                    ca_cert_pem=ca_pem)

            def pod(name):
                admin.create("pods", api.Pod(
                    metadata=api.ObjectMeta(name=name),
                    spec=api.PodSpec(containers=[api.Container(
                        resources=api.ResourceRequirements(
                            requests=api.resource_list(
                                cpu="100m", memory="64Mi")))])))
                return wait_for(lambda: admin.get(
                    "pods", "default", name).spec.node_name)
            before = pod("pre-upgrade")
            old = ka.upgrade_cluster(c, "v1.12-tpu.0") is c
            cm = c.store.get("configmaps", "kube-system",
                             ka.CLUSTER_CONFIG_NAME)
            return (before, old, cm.data["clusterVersion"],
                    admin.get("pods", "default",
                              "pre-upgrade").spec.node_name,
                    admin.get("nodes", "", "up-n1").metadata.name,
                    pod("post-upgrade"))
        finally:
            if hollow is not None:
                hollow.stop()
            if rstore is not None:
                rstore.stop()
            c.stop()
    assert both(run) == ("up-n1", True, "v1.12-tpu.0", "up-n1", "up-n1",
                         "up-n1")


# -- tokens, reset, version (tests/test_bootstrap_tokens.py) ------------------


def test_token_create_list_delete_and_ttl_0_as_in_jax():
    def run(pkg):
        store = mod(pkg, "runtime.store").ObjectStore()
        srv = mod(pkg, "server").APIServer(store).start()
        bt = mod(pkg, "controllers.bootstrap")
        try:
            rc1, out1, _ = run_main(pkg, "token", "create", "--server",
                                    srv.url)
            wire = out1.strip()
            tid, _, tsec = wire.partition(".")
            live = bt.lookup_token(store, wire) is not None
            rc2, out2, _ = run_main(pkg, "token", "list", "--server", srv.url)
            leaked = tsec in out2
            rc3, out3, _ = run_main(pkg, "token", "delete", wire,
                                    "--server", srv.url)
            dead = bt.lookup_token(store, wire) is None
            rc4, out4, err4 = run_main(pkg, "token", "delete", "abcdef",
                                       "--server", srv.url)
            rc5, out5, _ = run_main(pkg, "token", "create", "--server",
                                    srv.url, "--ttl", "0")
            sec = store.get("secrets", bt.TOKEN_NAMESPACE,
                            bt.TOKEN_SECRET_PREFIX + out5.strip()[:6])
            return (rc1, len(tid), len(tsec), live, rc2, mask(out2), leaked,
                    rc3, out3.replace(tid, "ID"), dead, rc4, err4, rc5,
                    "expiration" in sec.data)
        finally:
            srv.stop()
    got = both(run)
    assert got[:5] == (0, 6, 16, True, 0) and not got[6]
    assert "authentication" in got[5]
    assert got[7] == 0 and got[9] and got[10] == 1 and got[12] == 0
    assert got[13] is False


def test_reset_as_in_jax(tmp_path):
    def run(pkg):
        d = tmp_path / pkg / "cluster"
        d.mkdir(parents=True)
        (d / "wal").write_bytes(b"x")
        (d / "snapshot").write_bytes(b"y")
        other = tmp_path / pkg / "home"
        other.mkdir()
        (other / "precious.txt").write_text("do not delete")
        seen = [run_main(pkg, "reset", "--data-dir", str(d))[0], d.exists()]
        seen += [run_main(pkg, "reset", "--data-dir", str(d),
                          "--force")[0], d.exists()]
        seen += [run_main(pkg, "reset", "--data-dir", str(other),
                          "--force")[0], (other / "precious.txt").exists()]
        seen.append(run_main(pkg, "reset", "--data-dir",
                             str(tmp_path / "none"), "--force")[0])
        return seen
    assert both(run) == [1, True, 0, False, 1, True, 1]
