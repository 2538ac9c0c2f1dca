"""kubectl-style CLI against the HTTP apiserver (facade or real cluster).

The port's copy of ``kubeflow_tpu/cli.py``, over the port's own
``HttpApiClient``. The reference's operational surface is kubectl: apply
Notebook CRs, inspect status, set the stop annotation, delete. This
module is that surface for the framework's own transport: it speaks the
same REST protocol, so it works against ``--serve-apiserver`` standalone
clusters and real apiservers alike.

    python -m kubeflow_tpu_torch.cli --server http://127.0.0.1:6443 \\
        apply -f nb.yaml
    python -m kubeflow_tpu_torch.cli -n proj get notebooks
    python -m kubeflow_tpu_torch.cli stop notebook proj/demo
    python -m kubeflow_tpu_torch.cli delete notebook proj/demo
    python -m kubeflow_tpu_torch.cli -n proj trace demo \\
        --debug-server http://127.0.0.1:8081
"""

from __future__ import annotations

import argparse
import json
import sys

from .cluster.errors import ApiError, NotFoundError
from .cluster.http_client import HttpApiClient
from .utils import k8s, names

# plural/short → canonical kind (the CLI analog of kubectl's RESTMapper)
KIND_ALIASES = {
    "notebook": "Notebook", "notebooks": "Notebook", "nb": "Notebook",
    "statefulset": "StatefulSet", "statefulsets": "StatefulSet",
    "sts": "StatefulSet",
    "service": "Service", "services": "Service", "svc": "Service",
    "pod": "Pod", "pods": "Pod", "po": "Pod",
    "configmap": "ConfigMap", "configmaps": "ConfigMap", "cm": "ConfigMap",
    "secret": "Secret", "secrets": "Secret",
    "event": "Event", "events": "Event", "ev": "Event",
    "httproute": "HTTPRoute", "httproutes": "HTTPRoute",
    "referencegrant": "ReferenceGrant", "referencegrants": "ReferenceGrant",
    "networkpolicy": "NetworkPolicy", "networkpolicies": "NetworkPolicy",
    "netpol": "NetworkPolicy",
    "serviceaccount": "ServiceAccount", "serviceaccounts": "ServiceAccount",
    "sa": "ServiceAccount",
    "lease": "Lease", "leases": "Lease",
    "namespace": "Namespace", "namespaces": "Namespace", "ns": "Namespace",
}


def resolve_kind(token: str) -> str:
    kind = KIND_ALIASES.get(token.lower())
    if kind is None:
        # accept exact CamelCase kinds too
        if token[:1].isupper():
            return token
        raise SystemExit(f"error: unknown resource type {token!r}")
    return kind


def split_ref(ref: str, namespace: str) -> tuple[str, str]:
    """'ns/name' or 'name' (+ -n namespace) → (ns, name)."""
    if "/" in ref:
        ns, _, name = ref.partition("/")
        return ns, name
    return namespace, ref


def build_client(args) -> HttpApiClient:
    if args.kubeconfig:
        return HttpApiClient.from_kubeconfig(args.kubeconfig)
    return HttpApiClient(args.server, token=args.token,
                         verify=not args.insecure_skip_tls_verify)


def load_documents(path: str):
    import contextlib

    import yaml
    ctx = contextlib.nullcontext(sys.stdin) if path == "-" else open(path)
    with ctx as stream:
        for doc in yaml.safe_load_all(stream):
            if doc:
                yield doc


# ------------------------------------------------------------------ commands
def cmd_apply(client, args) -> int:
    rc = 0
    for obj in load_documents(args.filename):
        kind, ns, name = k8s.kind(obj), k8s.namespace(obj), k8s.name(obj)
        try:
            existing = client.get_or_none(kind, ns, name) if name else None
            if existing is None:
                created = client.create(obj)
                print(f"{kind.lower()}/{k8s.name(created)} created")
            else:
                obj.setdefault("metadata", {})["resourceVersion"] = \
                    existing["metadata"]["resourceVersion"]
                client.update(obj)
                print(f"{kind.lower()}/{name} configured")
        except ApiError as err:
            print(f"error applying {kind}/{name}: {err.message}",
                  file=sys.stderr)
            rc = 1
        except KeyError as err:  # unmapped kind: keep applying the rest
            print(f"error applying {kind}/{name}: {err.args[0]}",
                  file=sys.stderr)
            rc = 1
    return rc


def _ready_of(obj: dict) -> str:
    from .api import types as api
    if k8s.kind(obj) == "Notebook":
        cond = api.get_condition(obj, api.CONDITION_SLICE_READY)
        if cond:
            return cond["status"]
        return "Stopped" if k8s.get_annotation(
            obj, names.STOP_ANNOTATION) is not None else "Unknown"
    if k8s.kind(obj) == "Pod":
        return k8s.get_in(obj, "status", "phase", default="Unknown")
    return ""


def _get_or_complain(client, kind: str, ns: str, name: str):
    """THE fetch-or-report-not-found step shared by get/describe/delete —
    one place owns the kubectl-style error message."""
    try:
        return client.get(kind, ns, name)
    except NotFoundError:
        print(f"Error: {kind.lower()} {ns}/{name} not found",
              file=sys.stderr)
        return None


def cmd_get(client, args) -> int:
    kind = resolve_kind(args.resource)
    if args.name:
        ns, name = split_ref(args.name, args.namespace)
        obj = _get_or_complain(client, kind, ns, name)
        if obj is None:
            return 1
        _print_objs(args.output, obj, [obj])
        return 0
    objs = client.list(kind, args.namespace or None)
    _print_objs(args.output, {"kind": f"{kind}List", "items": objs}, objs)
    return 0


def _print_objs(output: str, raw, objs) -> None:
    if output == "json":
        print(json.dumps(raw, indent=2))
    elif output == "yaml":
        import yaml
        print(yaml.safe_dump(raw, sort_keys=False), end="")
    else:
        _print_table(objs)


def _print_table(objs) -> None:
    rows = [("NAMESPACE", "NAME", "READY", "AGE")]
    for obj in objs:
        rows.append((k8s.namespace(obj) or "-", k8s.name(obj),
                     _ready_of(obj) or "-",
                     k8s.get_in(obj, "metadata", "creationTimestamp",
                                default="-")))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    for row in rows:
        print("  ".join(cell.ljust(widths[i])
                        for i, cell in enumerate(row)).rstrip())


def cmd_delete(client, args) -> int:
    kind = resolve_kind(args.resource)
    ns, name = split_ref(args.name, args.namespace)
    try:
        client.delete(kind, ns, name)
    except NotFoundError:
        print(f"Error: {kind.lower()} {ns}/{name} not found",
              file=sys.stderr)
        return 1
    print(f"{kind.lower()}/{name} deleted")
    return 0


def cmd_stop(client, args) -> int:
    ns, name = split_ref(args.name, args.namespace)
    client.patch("Notebook", ns, name, {"metadata": {"annotations": {
        names.STOP_ANNOTATION: k8s.now_iso()}}})
    print(f"notebook/{name} stopped")
    return 0


def cmd_resume(client, args) -> int:
    ns, name = split_ref(args.name, args.namespace)
    client.patch("Notebook", ns, name, {"metadata": {"annotations": {
        names.STOP_ANNOTATION: None}}})
    print(f"notebook/{name} resumed")
    return 0


def cmd_restart(client, args) -> int:
    """Set the restart annotation — the reference's dashboard workflow
    (upstream reconciler deletes the pod and strips the annotation,
    notebook_controller.go:259-294); also how parked ``update-pending``
    webhook mutations get applied."""
    ns, name = split_ref(args.name, args.namespace)
    client.patch("Notebook", ns, name, {"metadata": {"annotations": {
        names.RESTART_ANNOTATION: "true"}}})
    print(f"notebook/{name} restart requested")
    return 0


def cmd_describe(client, args) -> int:
    """kubectl-describe analog: metadata, conditions, and the Events whose
    involvedObject is this resource (the reference re-emits pod/STS events
    onto the CR, so this is where slice failures surface)."""
    kind = resolve_kind(args.resource)
    ns, name = split_ref(args.name, args.namespace)
    obj = _get_or_complain(client, kind, ns, name)
    if obj is None:
        return 1
    print(f"Name:         {name}")
    print(f"Namespace:    {ns}")
    print(f"Kind:         {kind}")
    labels = k8s.get_in(obj, "metadata", "labels", default={}) or {}
    anns = k8s.get_in(obj, "metadata", "annotations", default={}) or {}
    print("Labels:       " + (", ".join(f"{k}={v}" for k, v in
                                        sorted(labels.items())) or "<none>"))
    print("Annotations:  " + (", ".join(f"{k}={v}" for k, v in
                                        sorted(anns.items())) or "<none>"))
    conditions = k8s.get_in(obj, "status", "conditions", default=[]) or []
    if conditions:
        print("Conditions:")
        for cond in conditions:
            print(f"  {cond.get('type', '?'):<16} "
                  f"{cond.get('status', '?'):<8} "
                  f"{cond.get('reason', '')} {cond.get('message', '')}"
                  .rstrip())
    events = [ev for ev in client.list("Event", ns)
              if ev.get("involvedObject", {}).get("name") == name
              and ev.get("involvedObject", {}).get("kind") == kind]
    print("Events:" if events else "Events:       <none>")
    for ev in events:
        print(f"  {ev.get('type', ''):<8} {ev.get('reason', ''):<20} "
              f"x{ev.get('count', 1)}  {ev.get('message', '')}".rstrip())
    return 0


def cmd_watch(client, args) -> int:
    """Stream watch events as table rows (kubectl get -w): the resync on
    connect lists current state as ADDED rows, then live changes follow
    until interrupted, the downstream pipe closes (head/less), or
    --timeout (for scripts)."""
    import threading

    kind = resolve_kind(args.resource)
    stop = threading.Event()

    def on_event(ev) -> None:
        if stop.is_set():
            return
        try:
            print(f"{ev.type:<9} {k8s.namespace(ev.obj) or '-':<12} "
                  f"{k8s.name(ev.obj):<24} {_ready_of(ev.obj) or '-'}",
                  flush=True)
        except BrokenPipeError:
            # prints happen on the watch thread — main()'s handler can't
            # see this; signal the wait below instead of letting the
            # delivery loop log-and-retry the same event forever
            stop.set()
    client.watch(kind, on_event, namespace=args.namespace or None)
    try:
        stop.wait(args.timeout)
    except KeyboardInterrupt:
        pass
    return 0


def _critical_path(spans: list[dict]) -> set[str]:
    """Span ids on the latency-critical chain: from the latest-ending root,
    descend at each level into the child that finished last — that chain is
    what determined when the trace finished. (Walking UP from the
    latest-ending span would degenerate to just the root: in a synchronous
    trace the root always ends last.)"""
    if not spans:
        return set()
    by_id = {s["span_id"]: s for s in spans}
    children: dict = {}
    for s in spans:
        children.setdefault(s.get("parent_id"), []).append(s)
    roots = [s for s in spans if s.get("parent_id") not in by_id]
    cur = max(roots or spans, key=lambda s: s["end"])
    path: set[str] = set()
    while cur is not None and cur["span_id"] not in path:
        path.add(cur["span_id"])
        kids = children.get(cur["span_id"], [])
        cur = max(kids, key=lambda s: s["end"]) if kids else None
    return path


def _span_depth(span: dict, by_id: dict) -> int:
    depth, seen = 0, set()
    parent = span.get("parent_id")
    while parent in by_id and parent not in seen:
        seen.add(parent)
        depth += 1
        parent = by_id[parent].get("parent_id")
    return depth


def render_trace(payload: dict, width: int = 32) -> str:
    """CR→Ready timeline for one notebook: each recorded trace (one per
    reconcile dispatch) as an indented span tree with offset/duration
    columns, a proportional bar, ``*`` on the critical path, and a phase
    breakdown footer (queue / APF / wire / reconcile). Pure — testable
    without an HTTP server."""
    from .utils.tracing import trace_phase_breakdown

    traces = payload.get("traces", [])
    out = [f"Notebook:  {payload.get('namespace', '?')}/"
           f"{payload.get('name', '?')}",
           f"Traces:    {len(traces)} recorded (oldest first)"]
    first_start = last_end = None
    for i, trace in enumerate(traces):
        spans = trace.get("spans", [])
        if not spans:
            continue
        t0 = min(s["start"] for s in spans)
        t_end = max(s["end"] for s in spans)
        wall = max(t_end - t0, 1e-9)
        first_start = t0 if first_start is None else min(first_start, t0)
        last_end = t_end if last_end is None else max(last_end, t_end)
        critical = _critical_path(spans)
        by_id = {s["span_id"]: s for s in spans}
        out.append("")
        out.append(f"Trace {i + 1}/{len(traces)}  {trace['trace_id']}  "
                   f"wall {wall:.3f}s")
        for s in spans:
            offset = s["start"] - t0
            bar_from = int(offset / wall * width)
            bar_len = max(int(s["duration_s"] / wall * width), 1)
            bar = (" " * bar_from +
                   "#" * min(bar_len, width - bar_from)).ljust(width)
            mark = "*" if s["span_id"] in critical else " "
            indent = "  " * _span_depth(s, by_id)
            label = s["name"]
            status = s.get("status")
            if status == "ERROR":
                label += " [ERROR]"
            retries = s.get("attributes", {}).get("retries")
            if retries:
                label += f" (retries={retries})"
            out.append(f"  {mark} +{offset:7.3f}s {s['duration_s']:8.3f}s "
                       f"|{bar}| {indent}{label}")
        phases = trace_phase_breakdown(spans)
        out.append(f"    phases: queue {phases['queue']:.3f}s  "
                   f"apf {phases['apf']:.3f}s (within wire)  "
                   f"wire {phases['wire']:.3f}s  "
                   f"reconcile {phases['reconcile']:.3f}s")
    if first_start is not None:
        out.append("")
        out.append(f"Lifecycle: {last_end - first_start:.3f}s from first "
                   f"dispatch to last span end (* = critical path)")
    return "\n".join(out) + "\n"


def cmd_trace(client, args) -> int:
    """Fetch the manager flight recorder's traces for one notebook from
    the health server's debug endpoint and render the timeline."""
    import urllib.error
    import urllib.request

    ns, name = split_ref(args.name, args.namespace)
    url = (f"{args.debug_server.rstrip('/')}"
           f"/debug/notebooks/{ns}/{name}/trace")
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            payload = json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        detail = err.read().decode(errors="replace").strip()
        print(f"Error: HTTP {err.code} from {url}: {detail}",
              file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError) as err:
        print(f"Error: cannot reach debug server {url}: {err}",
              file=sys.stderr)
        return 1
    if args.last:
        payload["traces"] = payload.get("traces", [])[-args.last:]
    if args.output == "json":
        print(json.dumps(payload, indent=2))
    else:
        print(render_trace(payload), end="")
    return 0


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kubeflow-tpu-torch", description=__doc__.splitlines()[0])
    ap.add_argument("--server", default="http://127.0.0.1:6443")
    ap.add_argument("--kubeconfig", default=None)
    ap.add_argument("--token", default=None)
    ap.add_argument("--insecure-skip-tls-verify", action="store_true")
    ap.add_argument("-n", "--namespace", default="default")
    sub = ap.add_subparsers(dest="command", required=True)

    p_apply = sub.add_parser("apply", help="apply YAML manifests")
    p_apply.add_argument("-f", "--filename", required=True,
                         help="path or - for stdin")

    p_get = sub.add_parser("get", help="list/show resources")
    p_get.add_argument("resource")
    p_get.add_argument("name", nargs="?")
    p_get.add_argument("-o", "--output", choices=("table", "json", "yaml"),
                       default="table")

    p_del = sub.add_parser("delete", help="delete a resource")
    p_del.add_argument("resource")
    p_del.add_argument("name")

    for verb in ("stop", "resume", "restart"):
        p = sub.add_parser(verb, help=f"{verb} a notebook (slice-atomic)")
        p.add_argument("resource", choices=("notebook", "nb"))
        p.add_argument("name")

    p_desc = sub.add_parser("describe",
                            help="metadata + conditions + events")
    p_desc.add_argument("resource")
    p_desc.add_argument("name")

    p_watch = sub.add_parser("watch", help="stream watch events (get -w)")
    p_watch.add_argument("resource")
    p_watch.add_argument("--timeout", type=float, default=None,
                         help="exit after N seconds (default: forever)")

    p_trace = sub.add_parser(
        "trace", help="per-notebook reconcile timeline (flight recorder)")
    p_trace.add_argument("name", help="notebook as ns/name or name")
    p_trace.add_argument("--debug-server", default="http://127.0.0.1:8081",
                         help="manager health server base URL")
    p_trace.add_argument("--last", type=int, default=0,
                         help="show only the last N traces (0 = all)")
    p_trace.add_argument("-o", "--output", choices=("timeline", "json"),
                         default="timeline")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    client = build_client(args)
    try:
        return _dispatch(client, args)
    finally:
        # stop any watch threads — an in-process caller (tests, notebooks)
        # would otherwise leak a reconnecting stream past this command
        client.close()


def _dispatch(client, args) -> int:
    handler = {"apply": cmd_apply, "get": cmd_get, "delete": cmd_delete,
               "stop": cmd_stop, "resume": cmd_resume,
               "restart": cmd_restart, "describe": cmd_describe,
               "watch": cmd_watch, "trace": cmd_trace}[args.command]
    try:
        return handler(client, args)
    except ApiError as err:
        print(f"Error from server: {err.message}", file=sys.stderr)
        return 1
    except KeyError as err:  # restmapper: kind without a REST mapping
        print(f"Error: {err.args[0]}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # downstream consumer (head, less) closed the pipe — normal CLI
        # usage, not an error; point stdout at devnull so the interpreter's
        # exit flush doesn't print a second traceback
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
