"""The port's composition root (``main.build_manager`` on
``controllers.setup_controllers``) and its process shell held against
the reference's.

All 4 cases of tests/test_main.py run through both packages, each case's
own body and assertions with the binaries' names swapped
(``torch_wire.binaries_case``; its v5e-4 notebook is the port's h100-4,
the same 4 workers): the full stack reaching SliceReady through the
cached read path with ``notebook_create_total 1`` on ``/metrics``, the
TLS-profile change setting the shutdown event, Secret payloads read live
and never cached, the JSON log format. Every store a case builds must
end with the same objects (``torch_wire.store_views``: the threaded case
each object's key and the notebook's and StatefulSet's specs, the others
every object with the last resourceVersion).

Then the process shell, in process: ``main.build_arg_parser`` parses the
reference's flags to the same namespace; ``main()`` over the in-process
store serves the apiserver facade with a token and refuses a
non-loopback bind without one (exit 2, as the reference's); and
``main()`` against that facade runs a leader-elected core manager that
releases its Lease on SIGTERM's path (the shutdown event) before it
closes its client.
"""

from __future__ import annotations

import socket
import threading
import time

import pytest

import test_main as ref_cases
from kubeflow_tpu import main as ref_main
from kubeflow_tpu_torch import main
from kubeflow_tpu_torch.cluster.http_client import HttpApiClient
from kubeflow_tpu_torch.cluster.store import ClusterStore
from torch_wire import SIDES, binaries_case, store_views

CASES = {"test_build_manager_full_stack_end_to_end": True,
         "test_tls_profile_change_triggers_shutdown_event": False,
         "test_secret_payloads_not_cached_by_manager_client": False,
         "test_json_log_format": False}


def test_every_reference_case_is_run():
    assert sorted(CASES) == sorted(n for n in vars(ref_cases)
                                   if n.startswith("test_"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_case(name):
    got = {}
    for side, s in SIDES.items():
        with pytest.MonkeyPatch.context() as mp:
            made = binaries_case(ref_cases, name, s, mp, inline=("logging",))
        got[side] = store_views(made, side, CASES[name])
    assert got["port"] == got["ref"]


@pytest.fixture
def quiet_logging(monkeypatch):
    """``main()`` in this process leaves the root logger as it was."""
    from kubeflow_tpu.utils import logging as ref_logging
    from kubeflow_tpu_torch.utils import logging as port_logging
    for mod in (ref_logging, port_logging):
        monkeypatch.setattr(mod, "setup_logging", lambda **kw: None)


def test_arg_parser_takes_the_reference_flags():
    argv = ["--leader-elect", "--health-port", "0", "--webhook-port", "0",
            "--components", "core", "--api-server", "http://x:1",
            "--shards", "4", "--max-concurrent-reconciles", "2",
            "--log-format", "json", "--trace-debug", "--otlp-endpoint",
            "http://c:4318", "--serve-apiserver", "7", "--apiserver-bind",
            "0.0.0.0", "--audit-log", "a.ndjson", "--fault-plan", "p.yaml",
            "--apiserver-token", "t", "--cert-dir", "/c",
            "--simulate-kubelet", "--insecure-skip-tls-verify",
            "--debug-log", "--api-token", "k", "--in-cluster",
            "--kubeconfig", "kc"]
    mine = vars(main.build_arg_parser().parse_args(argv))
    theirs = vars(ref_main.build_arg_parser().parse_args(argv))
    assert mine == theirs
    assert vars(main.build_arg_parser().parse_args([])) == \
        vars(ref_main.build_arg_parser().parse_args([]))


def test_main_refuses_a_public_bind_without_a_token(monkeypatch,
                                                    quiet_logging):
    monkeypatch.delenv("APISERVER_TOKEN", raising=False)
    for mod in (main, ref_main):
        assert mod.main(["--serve-apiserver", "0", "--apiserver-bind",
                         "0.0.0.0", "--health-port", "0",
                         "--webhook-port", "0"]) == 2


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait(fn, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def test_main_serves_the_apiserver_and_a_leader_releases_on_shutdown(
        monkeypatch, quiet_logging):
    """``main()`` twice in this process, as two binaries: one serving the
    in-process store over HTTP with a token (``--serve-apiserver``), one a
    leader-elected core manager against it. Setting each shutdown event
    (what SIGTERM does) returns 0; the leader's Lease is released
    (holder cleared, renew time 0) before its client closes."""
    port = _free_port()
    events: list = []
    real_build = main.build_manager

    def build(*a, **kw):
        mgr, shutdown = real_build(*a, **kw)
        events.append((mgr, shutdown))
        return mgr, shutdown
    monkeypatch.setattr(main, "build_manager", build)
    monkeypatch.setattr(main.signal, "signal", lambda *a: None)
    monkeypatch.setenv("LEADER_LEASE_DURATION", "5")
    monkeypatch.setenv("LEADER_RENEW_PERIOD", "0.05")
    rcs: dict = {}
    server = threading.Thread(target=lambda: rcs.setdefault(
        "server", main.main(["--serve-apiserver", str(port),
                             "--apiserver-token", "tok",
                             "--components", "extension",
                             "--health-port", "0", "--webhook-port", "0"])))
    server.start()
    core = None
    client = None
    try:
        _wait(lambda: events, msg="the apiserver binary")
        url = f"http://127.0.0.1:{port}"
        client = HttpApiClient(url, token="tok")
        _wait(lambda: _ping(client), msg="the facade")
        core = threading.Thread(target=lambda: rcs.setdefault(
            "core", main.main(["--api-server", url, "--api-token", "tok",
                               "--components", "core", "--leader-elect",
                               "--health-port", "0",
                               "--webhook-port", "0"])))
        core.start()
        _wait(lambda: len(events) == 2, msg="the core binary")
        ns = events[1][0].leader_elector.namespace
        lease = _wait(lambda: client.get_or_none(
            "Lease", ns, "kubeflow-tpu-notebook-controller-leader"),
            msg="the leader's Lease")
        assert lease["spec"]["holderIdentity"]
        assert events[1][0].breaker is not None
        events[1][1].set()                      # SIGTERM's path
        core.join(timeout=30)
        assert rcs.get("core") == 0
        lease = client.get("Lease", ns,
                           "kubeflow-tpu-notebook-controller-leader")
        assert lease["spec"]["holderIdentity"] == ""
        assert lease["spec"]["renewTime"] == 0.0
    finally:
        for _mgr, shutdown in events:
            shutdown.set()
        if core is not None:
            core.join(timeout=30)
        server.join(timeout=30)
        if client is not None:
            client.close()
    assert rcs.get("server") == 0


def _ping(client) -> bool:
    try:
        client.list("ConfigMap", "default")
        return True
    except Exception:  # noqa: BLE001 — not up yet
        return False


def test_build_manager_defaults_are_the_reference_binaries():
    """``components="all"`` with the webhooks in process (a JAX-imaged
    notebook is stored locked with the CUDA image), the
    ``(manager, shutdown_event)`` return, ``components="core"`` without
    webhooks, and ``webhooks=False`` on ``"all"``."""
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.utils import k8s, names
    store = ClusterStore()
    mgr, shutdown = main.build_manager(store)
    assert not shutdown.is_set()
    assert "extension-controller" in mgr._reconcilers
    nb = store.create(api.new_notebook(
        "nb", "ns", image="jupyter/jax-notebook:latest",
        annotations={names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
    assert k8s.get_annotation(nb, names.STOP_ANNOTATION) == \
        names.RECONCILIATION_LOCK_VALUE
    assert "jax" not in nb["spec"]["template"]["spec"]["containers"][0][
        "image"]
    for kw in ({"components": "core"}, {"webhooks": False}):
        bare = ClusterStore()
        main.build_manager(bare, **kw)
        nb = bare.create(api.new_notebook("nb", "ns"))
        assert k8s.get_annotation(nb, names.STOP_ANNOTATION) is None
