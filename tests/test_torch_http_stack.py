"""The whole controller stack over the HTTP transport, the port's held
against the reference's: each package's manager reconciling through its
own ``HttpApiClient`` against its own ``ApiServerProxy``.

Four of tests/test_http_stack.py's seven cases run through each package,
each with the case's own steps and assertions on its side (the
reference's ``build_manager(store=client)``, the port's
``build_manager(client, components="all")``); what each returns, after
``torch_parity.normalise``, must be equal:

- ``test_reconcilers_run_unmodified_over_http``: the "cluster" (store,
  Notebook CRD, the webhooks in process on the apiserver's store, the
  StatefulSet simulator under its own manager, the HTTP apiserver) and a
  manager that reaches it only over HTTP: a Notebook created through a
  second client rolls to a StatefulSet and a pod with the swapped image,
  turns SliceReady, and its deletion cascades. Over the wire a
  reconciler's write returns before its watch event arrives, so the
  echo filter now drops echoes: both sides must drop some;
- ``test_https_transport_with_verified_ca`` on an openssl-minted
  certificate (skipped where openssl is missing);
- ``test_kubeconfig_loading`` (``yaml`` is imported by
  ``from_kubeconfig`` only);
- ``test_manager_recovers_from_apiserver_outage``: a notebook created
  on the store while the apiserver is down is reconciled once it is back
  on the same port, each watch resuming from its last resourceVersion
  (``watch_resumes_total{mode="resume"}``, no relist).

The two subprocess cases, ``slow`` as in the reference (outside
tier-1; chip_smoke.py's phase 24 runs the port's processes on every
chip run): each side's ``python -m ...main`` serving the facade and
exiting 0 on SIGTERM, and two of its processes failing over on one
Lease. The intermittent-fault case waits for the chaos client.
Every manager, client and server stops in a ``finally``; the watch
reconnect delay is 0.05 s, as the reference's outage case sets it.
"""

from __future__ import annotations

import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

from kubeflow_tpu import main as ref_main
from kubeflow_tpu.api import types as ref_api
from kubeflow_tpu.cluster import apiserver as ref_apiserver
from kubeflow_tpu.cluster import echo as ref_echo
from kubeflow_tpu.cluster import http_client as ref_http_client
from kubeflow_tpu.cluster.kubelet import StatefulSetSimulator as RefSim
from kubeflow_tpu.cluster.store import ClusterStore as RefStore
from kubeflow_tpu.controllers.manager import Manager as RefManager
from kubeflow_tpu.utils import k8s as ref_k8s
from kubeflow_tpu.utils.config import ControllerConfig as RefConfig
from kubeflow_tpu.utils.metrics import MetricsRegistry as RefMetrics
from kubeflow_tpu.webhook import (NotebookMutatingWebhook as RefMutating,
                                  NotebookValidatingWebhook as RefValidating)
from kubeflow_tpu_torch import main as port_main
from kubeflow_tpu_torch.api import types as api
from kubeflow_tpu_torch.cluster import apiserver, echo, http_client
from kubeflow_tpu_torch.cluster.kubelet import StatefulSetSimulator
from kubeflow_tpu_torch.cluster.store import ClusterStore
from kubeflow_tpu_torch.controllers.manager import Manager
from kubeflow_tpu_torch.utils import k8s
from kubeflow_tpu_torch.utils.config import ControllerConfig
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
from kubeflow_tpu_torch.webhook import (NotebookMutatingWebhook,
                                       NotebookValidatingWebhook)
from torch_parity import SHAPES, normalise

TIMEOUT = 60.0


def _ref_build(client, config):
    mgr, _ = ref_main.build_manager(store=client, config=config)
    return mgr


def _port_build(client, config):
    mgr, _ = port_main.build_manager(client, config, components="all")
    return mgr


SIDES = {
    "ref": SimpleNamespace(
        side="ref", api=ref_api, k8s=ref_k8s, hc=ref_http_client,
        echo=ref_echo, ClusterStore=RefStore,
        ApiServerProxy=ref_apiserver.ApiServerProxy,
        HttpApiClient=ref_http_client.HttpApiClient, Manager=RefManager,
        Simulator=RefSim, Config=RefConfig, Metrics=RefMetrics,
        Mutating=RefMutating, Validating=RefValidating, build=_ref_build,
        accelerator=lambda shape: shape),
    "port": SimpleNamespace(
        side="port", api=api, k8s=k8s, hc=http_client, echo=echo,
        ClusterStore=ClusterStore, ApiServerProxy=apiserver.ApiServerProxy,
        HttpApiClient=http_client.HttpApiClient, Manager=Manager,
        Simulator=StatefulSetSimulator, Config=ControllerConfig,
        Metrics=MetricsRegistry, Mutating=NotebookMutatingWebhook,
        Validating=NotebookValidatingWebhook, build=_port_build,
        accelerator=SHAPES.get)}


def both(case, *args) -> dict:
    """``case(side, mp, *args)`` on each side under its own MonkeyPatch."""
    out = {}
    for name, s in SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(s.hc, "WATCH_RECONNECT_DELAY_S", 0.05)
            out[name] = case(s, mp, *args)
    return out


def wait_for(fn, timeout=TIMEOUT, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = fn()
        if result:
            return result
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def notebook(name, ns="default", tpu=None):
    md = {"name": name, "namespace": ns}
    if tpu:
        md["annotations"] = {"tpu.kubeflow.org/accelerator": tpu}
    return {"kind": "Notebook", "apiVersion": "kubeflow.org/v1",
            "metadata": md,
            "spec": {"template": {"spec": {"containers": [
                {"name": name, "image": "jupyter/base:latest"}]}}}}


def count_echoes(mp, s) -> list:
    """Patch the side's echo filter to keep every event it drops."""
    dropped: list = []
    is_echo = s.echo.EchoTrackingClient.is_echo

    def counted(self, event):
        out = is_echo(self, event)
        if out:
            dropped.append((event.obj.get("kind"), event.type))
        return out
    mp.setattr(s.echo.EchoTrackingClient, "is_echo", counted)
    return dropped


def cluster(s, config, webhooks=True):
    """The reference's ``cluster_server`` fixture on side ``s``: store,
    Notebook CRD, the webhooks in process (when ``webhooks``), the
    simulator's manager started and the apiserver; returns (store,
    simulator manager, proxy)."""
    store = s.ClusterStore()
    s.api.install_notebook_crd(store)
    if webhooks:
        s.Mutating(store, config).install(store)
        s.Validating(config).install(store)
    sim_mgr = s.Manager(store)
    s.Simulator(store).setup(sim_mgr)
    sim_mgr.start()
    proxy = s.ApiServerProxy(store)
    try:
        proxy.start()
    except BaseException:
        sim_mgr.stop()
        raise
    return store, sim_mgr, proxy


# ------------------------------------------ tests/test_http_stack.py
def test_reconcilers_run_unmodified_over_http():
    def case(s, mp):
        dropped = count_echoes(mp, s)
        config = s.Config()
        store, sim_mgr, proxy = cluster(s, config)
        client = s.HttpApiClient(proxy.url)
        kubectl = s.HttpApiClient(proxy.url)
        mgr = None
        try:
            mgr = s.build(client, config)
            mgr.start()
            kubectl.create(notebook("nb-http", tpu=s.accelerator("v5e-4")))

            def sts_with_pod():
                sts = kubectl.get_or_none("StatefulSet", "default", "nb-http")
                pod = kubectl.get_or_none("Pod", "default", "nb-http-0")
                return sts and pod
            wait_for(sts_with_pod, msg="STS + pod via HTTP reconcile")
            sts = kubectl.get("StatefulSet", "default", "nb-http")
            image = s.k8s.get_in(sts, "spec", "template", "spec",
                                 "containers")[0]["image"]
            assert "jupyter/base" not in image

            def ready():
                nb = kubectl.get("Notebook", "default", "nb-http")
                cond = s.api.get_condition(nb, s.api.CONDITION_SLICE_READY)
                return cond and cond["status"] == "True"
            wait_for(ready, msg="slice-ready condition over HTTP")
            nb = kubectl.get("Notebook", "default", "nb-http")
            kubectl.delete("Notebook", "default", "nb-http")
            wait_for(lambda: kubectl.get_or_none(
                "StatefulSet", "default", "nb-http") is None,
                msg="cascade delete over HTTP")
        finally:
            client.close()
            kubectl.close()
            if mgr is not None:
                mgr.stop()
            proxy.stop()
            sim_mgr.stop()
        # over the wire the write returns before its event arrives
        assert dropped, "the echo filter dropped nothing over HTTP"
        conds = {c["type"]: c["status"]
                 for c in nb.get("status", {}).get("conditions", [])}
        return (normalise(sts, s.side)["spec"]["template"]["spec"],
                normalise(nb, s.side)["spec"], conds["SliceReady"],
                s.k8s.get_annotation(nb, "kubeflow-resource-stopped"))
    got = both(case)
    assert got["port"] == got["ref"]


@pytest.mark.skipif(shutil.which("openssl") is None,
                    reason="openssl is not installed")
def test_https_transport_with_verified_ca(tmp_path):
    cert = tmp_path / "tls.crt"
    key = tmp_path / "tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)

    def case(s, mp):
        proxy = s.ApiServerProxy(s.ClusterStore(), certfile=str(cert),
                                 keyfile=str(key), token="tls-token")
        proxy.start()
        client = None
        try:
            client = s.HttpApiClient(proxy.url, token="tls-token",
                                     ca_cert=str(cert))
            created = client.create({"kind": "ConfigMap",
                                     "metadata": {"name": "tls-cm",
                                                  "namespace": "default"}})
            assert created["metadata"]["uid"]
            got = client.get("ConfigMap", "default", "tls-cm")
            # a client that trusts no CA refuses the certificate
            stranger = s.HttpApiClient(proxy.url, token="tls-token")
            try:
                with pytest.raises(s.hc.TRANSPORT_ERRORS):
                    stranger.get("ConfigMap", "default", "tls-cm")
            finally:
                stranger.close()
        finally:
            if client is not None:
                client.close()
            proxy.stop()
        return normalise(got, s.side), proxy.url.split(":")[0]
    got = both(case)
    assert got["port"] == got["ref"]


def test_kubeconfig_loading(tmp_path):
    def case(s, mp):
        proxy = s.ApiServerProxy(s.ClusterStore(), token="kc-token")
        proxy.start()
        kubeconfig = tmp_path / f"{s.side}-config"
        kubeconfig.write_text(f"""
apiVersion: v1
kind: Config
current-context: test
contexts:
- name: test
  context: {{cluster: c, user: u}}
clusters:
- name: c
  cluster: {{server: "{proxy.url}"}}
users:
- name: u
  user: {{token: kc-token}}
""")
        client = None
        try:
            client = s.HttpApiClient.from_kubeconfig(str(kubeconfig))
            assert client.token == "kc-token" and client.base_url == proxy.url
            client.create({"kind": "ConfigMap",
                           "metadata": {"name": "kc", "namespace": "default"}})
            got = client.get("ConfigMap", "default", "kc")
        finally:
            if client is not None:
                client.close()
            proxy.stop()
        return normalise(got, s.side)
    got = both(case)
    assert got["port"] == got["ref"]


def test_manager_recovers_from_apiserver_outage():
    def case(s, mp):
        config = s.Config()
        store, sim_mgr, proxy = cluster(s, config, webhooks=False)
        port = proxy.port
        registry = s.Metrics()
        client = s.HttpApiClient(proxy.url, metrics=registry)
        mgr = None
        try:
            mgr = s.build(client, config)
            client.attach_metrics(registry)
            mgr.start()
            store.create(notebook("nb-before"))
            wait_for(lambda: store.get_or_none("Pod", "default",
                                               "nb-before-0"),
                     msg="baseline reconcile over HTTP")
            resumes = registry.counter("watch_resumes_total", "")
            before = {m: resumes.sum_where({"mode": m})
                      for m in ("resume", "relist")}
            proxy.stop()  # apiserver outage
            store.create(notebook("nb-during"))
            time.sleep(1.0)
            assert store.get_or_none("StatefulSet", "default",
                                     "nb-during") is None
            proxy = s.ApiServerProxy(store, port=port)
            proxy.start()  # back on the same endpoint
            wait_for(lambda: store.get_or_none("Pod", "default",
                                               "nb-during-0"),
                     msg="outage-time notebook reconciled after recovery")
            after = {m: resumes.sum_where({"mode": m}) - before[m]
                     for m in ("resume", "relist")}
        finally:
            client.close()
            if mgr is not None:
                mgr.stop()
            proxy.stop()
            sim_mgr.stop()
        # every stream that dropped came back from its last rv, no LIST
        assert after["resume"] >= 1 and after["relist"] == 0, after
        sts = store.get("StatefulSet", "default", "nb-during")
        return normalise(sts, s.side)["spec"], after["relist"]
    got = both(case)
    assert got["port"] == got["ref"]


# ------------------------------------------------------------- subprocess
# the reference marks both ``slow``: outside tier-1, as there
REPO_ROOT = str(Path(__file__).resolve().parent.parent)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_manager(s, *args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT
    env.update(env_extra or {})
    module = "kubeflow_tpu.main" if s.side == "ref" \
        else "kubeflow_tpu_torch.main"
    return subprocess.Popen([sys.executable, "-m", module, *args],
                            cwd=REPO_ROOT, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _http_ok(url):
    try:
        with urllib.request.urlopen(url, timeout=1) as resp:
            return resp.status == 200
    except OSError:
        return False


@pytest.mark.slow
def test_main_subprocess_serves_and_exits_on_sigterm():
    """Each side's ``main`` as a real process with the apiserver facade
    and the kubelet simulator: a notebook created over HTTP from outside
    gets its pod; SIGTERM exits 0. Equal StatefulSet specs."""
    def case(s, mp):
        port = _free_port()
        proc = _spawn_manager(s, "--serve-apiserver", str(port),
                              "--simulate-kubelet", "--health-port", "0",
                              "--webhook-port", "0")
        kubectl = None
        try:
            wait_for(lambda: _http_ok(f"http://127.0.0.1:{port}/healthz"),
                     timeout=60, msg="the facade serving")
            kubectl = s.HttpApiClient(f"http://127.0.0.1:{port}")
            kubectl.create(notebook("nb-proc"))
            wait_for(lambda: kubectl.get_or_none("Pod", "default",
                                                 "nb-proc-0"),
                     msg="subprocess manager reconciled the notebook")
            sts = kubectl.get("StatefulSet", "default", "nb-proc")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=30)
        finally:
            if kubectl is not None:
                kubectl.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert rc == 0
        return normalise(sts, s.side)["spec"], rc
    got = both(case)
    assert got["port"] == got["ref"]


@pytest.mark.slow
def test_leader_election_failover_across_processes():
    """Two of each side's manager processes contend on one Lease over
    HTTP; killing the leader hands reconciliation to the standby within
    the lease duration. Equal StatefulSet specs of the notebook each
    leader reconciled."""
    def case(s, mp):
        config = s.Config()
        store, sim_mgr, proxy = cluster(s, config, webhooks=False)
        env = {"LEADER_LEASE_DURATION": "2", "LEADER_RENEW_PERIOD": "0.3"}
        url = proxy.url
        lease_name = "kubeflow-tpu-notebook-controller-leader"
        proc_a = _spawn_manager(s, "--api-server", url, "--leader-elect",
                                "--health-port", "0", "--webhook-port", "0",
                                env_extra=env)
        proc_b = None
        kubectl = None
        try:
            lease_ns = config.controller_namespace
            lease = wait_for(lambda: store.get_or_none(
                "Lease", lease_ns, lease_name),
                msg="process A acquired the lease")
            holder_a = lease["spec"]["holderIdentity"]
            proc_b = _spawn_manager(s, "--api-server", url,
                                    "--leader-elect", "--health-port", "0",
                                    "--webhook-port", "0", env_extra=env)
            kubectl = s.HttpApiClient(url)
            kubectl.create(notebook("nb-a"))
            wait_for(lambda: kubectl.get_or_none("Pod", "default",
                                                 "nb-a-0"),
                     msg="leader reconciled nb-a")
            proc_a.kill()  # no graceful lease release
            proc_a.wait()

            def new_holder():
                cur = store.get_or_none("Lease", lease_ns, lease_name)
                return cur and cur["spec"]["holderIdentity"] != holder_a
            wait_for(new_holder, timeout=30, msg="standby took the lease")
            kubectl.create(notebook("nb-b"))
            wait_for(lambda: kubectl.get_or_none("Pod", "default",
                                                 "nb-b-0"),
                     msg="new leader reconciled nb-b")
            return [normalise(store.get("StatefulSet", "default", n),
                              s.side)["spec"] for n in ("nb-a", "nb-b")]
        finally:
            if kubectl is not None:
                kubectl.close()
            for proc in (proc_a, proc_b):
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
            proxy.stop()
            sim_mgr.stop()
    got = both(case)
    assert got["port"] == got["ref"]
