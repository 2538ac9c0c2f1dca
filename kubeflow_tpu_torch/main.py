"""Manager entrypoint: the port's counterpart of the reference's two
main.go binaries (``kubeflow_tpu/main.py``).

The wiring reproduced (notebook-controller/main.go:48-148 and odh
main.go:141-374):

- flag parsing (health port, webhook port and cert dir, leader election,
  log format, transport) and env config (``ControllerConfig.from_env``);
- the bootstrap TLS-profile fetch with its hardened fallback, applied to
  the webhook listener; a ``SecurityProfileWatcher`` sets the shutdown
  event when the cluster's profile changes, so the process restarts with
  it (odh main.go:178-234, 344-367);
- ``controllers.setup_controllers``: the one read cache (Secrets,
  ConfigMaps and Events read live), the CRDs and in-process admission,
  the apiserver breaker on a transport client, sharded ownership, the
  reconcilers, leader election on each binary's own Lease and the
  health endpoints.

``build_manager`` is the composition root every caller uses, tests and
``chip_smoke.py`` included; ``main()`` adds the flags, SIGTERM/SIGINT
and the shutdown order. ``store`` defaults to a fresh in-process
``ClusterStore``; a standalone run with ``--simulate-kubelet`` is a
working control plane on one machine::

    mgr, shutdown = build_manager(simulate_kubelet=True)
    mgr.start()
    mgr.client.create(new_notebook("demo", "ns", image="jupyter/jax-notebook",
        annotations={"tpu.kubeflow.org/accelerator": "h100-32"}))
    # → admitted locked with the CUDA image (the webhooks), unlocked by the
    #   extension reconciler, 4 replicas, SliceReady
    mgr.stop()

    mgr, _ = build_manager(components="core")   # no webhooks, no extension

Over the wire ``store`` is a ``cluster/http_client.py`` ``HttpApiClient``:
nothing is installed in process (the apiserver's side holds the CRDs and
the webhook configurations, whose ``AdmissionServer`` its store calls
over AdmissionReview), and the client reports every transport outcome to
the manager's circuit breaker.

Run the split binaries against one apiserver (the reference's two
Deployments)::

    python -m kubeflow_tpu_torch.main --serve-apiserver 18443 \\
        --components extension --simulate-kubelet --webhook-port 0
    python -m kubeflow_tpu_torch.main --api-server http://127.0.0.1:18443 \\
        --components core --leader-elect --health-port 18084 --trace-debug
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from .cluster.store import ClusterStore
from .controllers import setup_controllers
from .utils import tls_profile
from .utils.config import ControllerConfig
from .webhook.server import AdmissionServer

log = logging.getLogger("kubeflow_tpu_torch.main")

# which binaries each selection runs: (core, extension)
_COMPONENTS = {"core": (True, False), "extension": (False, True),
               "all": (True, True)}


def build_manager(store=None, config: ControllerConfig | None = None, *,
                  leader_elect: bool = False, health_port: int | None = None,
                  webhook_port: int | None = None,
                  cert_dir: str | None = None,
                  simulate_kubelet: bool = False,
                  components: str = "all",
                  max_concurrent_reconciles: int | None = None,
                  shards: int | None = None,
                  on_tls_change=None,
                  webhooks: bool = True,
                  ready_hook=None, prober=None):
    """Compose the production stack; returns ``(manager, shutdown_event)``,
    the manager not started.

    ``components`` mirrors the reference's two manager binaries:
    ``"core"`` the notebook-controller (the core reconciler, the culler,
    slice repair, the SlicePool reconciler and the fleet scheduler),
    ``"extension"`` the odh manager (the extension reconciler and the
    admission webhooks), ``"all"`` both in one process. The webhooks are
    installed in process when the extension runs, unless
    ``webhooks=False``. ``leader_elect`` elects on
    the binary's own Lease; ``health_port`` serves healthz, readyz and
    metrics; ``webhook_port`` (with the extension) builds the HTTPS
    AdmissionServer on ``mgr.webhook_server`` (``cert_dir`` holds
    tls.crt and tls.key; plain HTTP without one) with the cluster's TLS
    profile, not started; ``shards`` sets ``config.shard_count``.
    ``on_tls_change`` defaults to setting the shutdown event.

    The port's own keywords: ``ready_hook(pod) -> bool`` gates the
    simulator's readiness flip of a pod (chip_smoke.py forms and verifies
    the pod's NCCL world there), and ``prober(notebook)`` stands in for
    the culler's HTTP probe of Jupyter.

    ``mgr.client`` and ``mgr.read_cache`` are the ``CachingClient`` over
    ``store``; ``mgr.metrics`` the registry every family went to."""
    store = store if store is not None else ClusterStore()
    config = config or ControllerConfig.from_env()
    if shards is not None:
        # every replica must run the same count: the shard map is
        # computed locally from it
        config.shard_count = shards
    shutdown = threading.Event()
    if components not in _COMPONENTS:
        raise ValueError(f"unknown components selection: {components!r}")
    core, extension = _COMPONENTS[components]
    # setup_controllers owns the one read cache
    mgr = setup_controllers(store, config, prober=prober,
                            leader_elect=leader_elect,
                            health_port=health_port, core=core,
                            extension=extension,
                            webhooks=extension and webhooks,
                            max_concurrent_reconciles=max_concurrent_reconciles)

    profile = tls_profile.fetch_apiserver_tls_profile(store)
    watcher = tls_profile.SecurityProfileWatcher(
        store, profile, on_change=on_tls_change or shutdown.set)
    watcher.setup()

    if webhook_port is not None and extension:
        # the webhook server belongs to the extension manager; it reads
        # and writes the live store, never the cache
        from .webhook import (NotebookMutatingWebhook,
                              NotebookValidatingWebhook)
        certfile = f"{cert_dir}/tls.crt" if cert_dir else None
        keyfile = f"{cert_dir}/tls.key" if cert_dir else None
        mgr.webhook_server = AdmissionServer(
            NotebookMutatingWebhook(store, config),
            NotebookValidatingWebhook(config),
            port=webhook_port, certfile=certfile, keyfile=keyfile,
            tls_profile=profile)
        if mgr.health_server is not None:
            mgr.health_server.add_readyz_check(
                "webhook", lambda: mgr.webhook_server.is_serving())

    if simulate_kubelet:
        from .cluster.kubelet import StatefulSetSimulator
        # pod lookups through the manager's indexed cache
        StatefulSetSimulator(mgr.read_cache,
                             ready_hook=ready_hook).setup(mgr)
    return mgr, shutdown


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leader-elect", action="store_true",
                    help="enable Lease-based leader election")
    ap.add_argument("--health-port", type=int, default=8081,
                    help="healthz/readyz/metrics port (0 disables)")
    ap.add_argument("--webhook-port", type=int, default=8443)
    ap.add_argument("--cert-dir", default=None,
                    help="dir with tls.crt/tls.key for the webhook server "
                         "(absent → plain HTTP, dev only)")
    ap.add_argument("--simulate-kubelet", action="store_true",
                    help="run the StatefulSet/pod simulator (standalone)")
    ap.add_argument("--max-concurrent-reconciles", type=int, default=None,
                    metavar="N",
                    help="dispatch worker-pool size (default from "
                         "MAX_CONCURRENT_RECONCILES env, 4)")
    ap.add_argument("--shards", type=int, default=None, metavar="M",
                    help="shard reconcile ownership by namespace hash into "
                         "M shards (per-shard Lease election; every replica "
                         "runs the same M; SHARD_COUNT env is equivalent, "
                         "SHARD_IDENTITY pins the replica identity)")
    ap.add_argument("--components", choices=tuple(_COMPONENTS),
                    default="all",
                    help="which manager to run: 'core' = the "
                         "notebook-controller binary, 'extension' = the "
                         "odh manager (extension reconciler + webhooks); "
                         "the two cooperate through apiserver state")
    ap.add_argument("--debug-log", action="store_true")
    ap.add_argument("--log-format", choices=("text", "json"), default="text",
                    help="json = one JSON object per line, RFC3339 ts")
    # the transport: one of kubeconfig / api-server / in-cluster, else the
    # in-process store
    ap.add_argument("--kubeconfig", default=None,
                    help="reconcile a real cluster via this kubeconfig")
    ap.add_argument("--api-server", default=None,
                    help="reconcile the cluster at this apiserver URL "
                         "(token via --api-token or SA mount)")
    ap.add_argument("--api-token", default=None)
    ap.add_argument("--in-cluster", action="store_true",
                    help="use the ServiceAccount mount")
    ap.add_argument("--insecure-skip-tls-verify", action="store_true")
    ap.add_argument("--serve-apiserver", type=int, default=None,
                    metavar="PORT",
                    help="standalone mode: expose the in-process store over "
                         "HTTP so other processes share this cluster state")
    ap.add_argument("--apiserver-bind", default="127.0.0.1",
                    help="bind address for --serve-apiserver; non-loopback "
                         "requires --apiserver-token (the facade grants "
                         "full cluster read/write, Secrets included)")
    ap.add_argument("--audit-log", default=None, metavar="PATH",
                    help="with --serve-apiserver: append one NDJSON line "
                         "per mutating request")
    ap.add_argument("--apiserver-token", default=None,
                    help="bearer token required by --serve-apiserver "
                         "(env APISERVER_TOKEN also honored); TLS via "
                         "--cert-dir")
    ap.add_argument("--fault-plan", default=None, metavar="PATH",
                    help="with --serve-apiserver: arm the facade with a "
                         "wire-level FaultPlan (YAML: seed + rules of "
                         "429/503/reset/watch_kill/latency per verb/kind, "
                         "cluster/faults.py)")
    ap.add_argument("--otlp-endpoint", default=None, metavar="URL",
                    help="export admission/controller spans as OTLP/HTTP "
                         "JSON to this collector base URL (POSTs "
                         "{URL}/v1/traces); absent → the no-op provider")
    ap.add_argument("--trace-debug", action="store_true",
                    help="record reconcile traces in the in-process flight "
                         "recorder and serve them at "
                         "/debug/notebooks/<ns>/<name>/trace on the health "
                         "port; combines with --otlp-endpoint")
    return ap


def build_client_from_args(args):
    """Resolve the transport flags to a client, or None for the in-process
    store (client-go's loading order: explicit flag > kubeconfig > SA)."""
    from .cluster.http_client import HttpApiClient
    if args.api_server:
        return HttpApiClient(args.api_server, token=args.api_token,
                             verify=not args.insecure_skip_tls_verify)
    if args.kubeconfig:
        return HttpApiClient.from_kubeconfig(args.kubeconfig)
    if args.in_cluster:
        return HttpApiClient.in_cluster()
    return None


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    from .utils.logging import setup_logging
    setup_logging(debug=args.debug_log, fmt=args.log_format)

    otlp = None
    recorder = None
    if args.otlp_endpoint or args.trace_debug:
        from .utils import tracing
        if args.otlp_endpoint:
            otlp = tracing.OtlpHttpExporter(args.otlp_endpoint)
        exporter = otlp
        if args.trace_debug:
            # the flight recorder in front, teeing every span to OTLP
            recorder = tracing.FlightRecorder(inner=otlp)
            exporter = recorder
        tracing.set_provider(tracing.SDKProvider(exporter))
        log.info("tracing: otlp=%s flight_recorder=%s",
                 args.otlp_endpoint or "off",
                 "on" if recorder is not None else "off")

    client = build_client_from_args(args)
    mgr, shutdown = build_manager(
        store=client,
        leader_elect=args.leader_elect,
        health_port=args.health_port or None,
        webhook_port=args.webhook_port or None,
        cert_dir=args.cert_dir,
        components=args.components,
        max_concurrent_reconciles=args.max_concurrent_reconciles,
        shards=args.shards,
        simulate_kubelet=args.simulate_kubelet and client is None)

    if recorder is not None and mgr.health_server is not None:
        # the cli.py `trace` command reads this endpoint
        mgr.health_server.flight_recorder = recorder

    apiserver = None
    if args.serve_apiserver is not None:
        if client is not None:
            log.error("--serve-apiserver requires the in-process store")
            return 2
        token = args.apiserver_token or os.environ.get("APISERVER_TOKEN")
        if args.apiserver_bind not in ("127.0.0.1", "localhost", "::1") \
                and not token:
            log.error("refusing to serve the apiserver facade on %s without "
                      "--apiserver-token: it grants full cluster read/write "
                      "(Secrets included) to any network peer",
                      args.apiserver_bind)
            return 2
        from .cluster.apiserver import ApiServerProxy
        fault_plan = None
        if args.fault_plan:
            from .cluster.faults import FaultPlan
            fault_plan = FaultPlan.from_file(args.fault_plan)
            log.warning("apiserver facade armed with fault plan %s "
                        "(%d rules)", args.fault_plan, len(fault_plan.rules))
        apiserver = ApiServerProxy(
            mgr.client.store, port=args.serve_apiserver,
            host=args.apiserver_bind, token=token,
            certfile=f"{args.cert_dir}/tls.crt" if args.cert_dir else None,
            keyfile=f"{args.cert_dir}/tls.key" if args.cert_dir else None,
            audit_log=args.audit_log,
            fault_plan=fault_plan)
        apiserver.start()
        log.info("apiserver facade listening on %s (auth=%s)",
                 apiserver.url, "token" if token else "none/loopback")

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: shutdown.set())
    if mgr.webhook_server is not None:
        # started outside the try: stopping a server that never started
        # would wait for ever
        mgr.webhook_server.start()
    try:
        mgr.start()
        log.info("manager started (leader_elect=%s)", args.leader_elect)
        shutdown.wait()
        log.info("shutting down")
    finally:
        if apiserver is not None:
            apiserver.stop()
        if mgr.webhook_server is not None:
            mgr.webhook_server.stop()
        # the manager stops before its transport closes: the graceful
        # shutdown writes (the leader and shard lease releases), which a
        # closed client would turn into transport errors, leaving peers
        # to wait out the leases
        mgr.stop()
        if client is not None:
            client.close()
        if otlp is not None:
            otlp.shutdown()  # the last span flush to the collector
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
