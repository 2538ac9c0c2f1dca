"""Idle-culling controller with slice-atomic semantics.

The port's copy of ``kubeflow_tpu/controllers/culling.py``, which
re-implements the reference CullingReconciler's annotation state machine
(components/notebook-controller/controllers/culling_controller.go:87-204):

- every notebook re-queues each IDLENESS_CHECK_PERIOD (default 1 min, :33);
- stop-annotation present → strip activity annotations and exit (:105-118);
- no worker-0 pod → strip activity annotations (:120-139);
- first pass initializes ``last-activity`` / ``last_activity_check_timestamp``
  (:141-154,:458-465);
- probes Jupyter ``/api/kernels`` + ``/api/terminals`` over HTTP with a 10s
  timeout (:244-322), on worker 0 only, which runs the slice's one Jupyter
  server;
- busiest kernel/terminal advances last-activity; idle past CULL_IDLE_TIME
  (default 1440 min, :32) → set the stop annotation (:170-197,:484-501);
- every annotation write is conflict-retried (RetryOnConflict, :107,125,144,172).

Beyond the reference, as in the JAX package: a notebook with the
serving-port annotation hosts a model endpoint (``runtime/server.py``),
and requests counted by its ``/healthz`` since the last check are
activity; a slice under repair (``SLICE_HEALTH_ANNOTATION``) pauses the
idle clock; a pool-bound notebook's worker 0 is found in the pool's
namespace.

Slice atomicity: the stop annotation is observed by the core reconciler,
which scales the slice's one StatefulSet to 0, so all workers are reaped
together; replicas are never partially mutated.
"""

from __future__ import annotations

import datetime as dt
import json
import logging
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Callable

from ..api import slicepool as pool_api
from ..api import types as api
from ..cluster import errors
from ..cluster.echo import EchoTrackingClient
from ..utils import k8s, names
from ..utils.config import ControllerConfig
from ..utils.metrics import MetricsRegistry
from .manager import Manager, Request, Result

log = logging.getLogger("kubeflow_tpu_torch.culling")

TIME_FORMAT = "%Y-%m-%dT%H:%M:%SZ"


def format_time(t: float) -> str:
    return time.strftime(TIME_FORMAT, time.gmtime(t))


def parse_time(s: str) -> float:
    return dt.datetime.strptime(s, TIME_FORMAT).replace(
        tzinfo=dt.timezone.utc).timestamp()


@dataclass
class JupyterActivity:
    """Result of probing a notebook's Jupyter API. ``None`` for an endpoint
    means that endpoint was unreachable; the reference updates last-activity
    from kernels and terminals independently (culling_controller.go:244-322),
    so one dead endpoint must not discard the other's data."""
    kernels: list[dict] | None = field(default_factory=list)    # {execution_state, last_activity}
    terminals: list[dict] | None = field(default_factory=list)  # {last_activity}

    @property
    def reachable(self) -> bool:
        return self.kernels is not None or self.terminals is not None

    def any_busy(self) -> bool:
        return any(k.get("execution_state") == "busy"
                   for k in self.kernels or [])

    def latest_activity(self) -> float | None:
        stamps = []
        for item in [*(self.kernels or []), *(self.terminals or [])]:
            raw = item.get("last_activity")
            if not raw:
                continue
            try:
                stamps.append(parse_time(raw.split(".")[0].rstrip("Z") + "Z"))
            except ValueError:
                continue
        return max(stamps) if stamps else None


def http_prober(config: ControllerConfig) -> Callable[[dict], JupyterActivity]:
    """Production prober: GET the Jupyter kernels/terminals APIs through the
    notebook Service (reference URL shape
    ``http://<name>.<ns>.svc.<domain>/notebook/<ns>/<name>/api/kernels``,
    culling_controller.go:244-274). In DEV mode requests route through a
    local apiserver proxy (kubectl proxy) exactly as the reference does
    (culling_controller.go:249-254): ``<dev_proxy_url>/api/v1/namespaces/
    <ns>/services/<name>/proxy<nb_prefix>/api/...``."""
    def probe(notebook: dict) -> JupyterActivity:
        ns, name = k8s.namespace(notebook), k8s.name(notebook)
        if config.dev_mode:
            base = (f"{config.dev_proxy_url}/api/v1/namespaces/{ns}/"
                    f"services/{name}/proxy"
                    f"{names.nb_prefix(ns, name)}/api")
        else:
            base = (f"http://{name}.{ns}.svc.{config.cluster_domain}"
                    f"{names.nb_prefix(ns, name)}/api")
        out = JupyterActivity()
        for endpoint in ("kernels", "terminals"):
            try:
                with urllib.request.urlopen(
                        f"{base}/{endpoint}",
                        timeout=config.jupyter_probe_timeout_s) as resp:
                    body = json.loads(resp.read())
                if not isinstance(body, list) or not all(
                        isinstance(item, dict) for item in body):
                    raise ValueError(f"unexpected {endpoint} shape: "
                                     f"{type(body).__name__}")
                setattr(out, endpoint, body)
            except (urllib.error.URLError, OSError, ValueError) as exc:
                log.debug("probe %s/%s %s failed: %s", ns, name, endpoint, exc)
                setattr(out, endpoint, None)
        return out
    return probe


def serving_requests_prober(config: ControllerConfig) \
        -> Callable[[dict, str], int | None]:
    """Production serving-activity probe: GET the in-pod serving server's
    ``/healthz`` (runtime/server.py) through the notebook Service on the
    annotated port and return its cumulative ``requests_total``. None =
    unreachable (no server yet, or mid-restart) — never an error."""
    def probe(notebook: dict, port: str) -> int | None:
        ns, name = k8s.namespace(notebook), k8s.name(notebook)
        # the annotation is attacker-ish input (any notebook author sets
        # it): k8s.parse_port is the same bound notebook.py applies before
        # exposing the Service port — a bad value must not reach the URL
        port_num = k8s.parse_port(port)
        if port_num is None:
            log.debug("serving probe %s/%s: invalid port %r", ns, name, port)
            return None
        port = str(port_num)
        if config.dev_mode:
            url = (f"{config.dev_proxy_url}/api/v1/namespaces/{ns}/"
                   f"services/{name}:{port}/proxy/healthz")
        else:
            url = (f"http://{name}.{ns}.svc.{config.cluster_domain}:"
                   f"{port}/healthz")
        try:
            with urllib.request.urlopen(
                    url, timeout=config.jupyter_probe_timeout_s) as resp:
                body = json.loads(resp.read())
            if not isinstance(body, dict):
                raise ValueError(f"unexpected healthz shape: "
                                 f"{type(body).__name__}")
            total = body.get("requests_total")
            return int(total) if total is not None else None
        except (urllib.error.URLError, OSError, ValueError,
                TypeError) as exc:
            log.debug("serving probe %s/%s failed: %s", ns, name, exc)
            return None
    return probe


class CullingReconciler:
    name = "culling-controller"

    def __init__(self, client, config: ControllerConfig | None = None,
                 metrics: MetricsRegistry | None = None,
                 prober: Callable[[dict], JupyterActivity] | None = None,
                 clock: Callable[[], float] = time.time,
                 serving_prober: Callable[[dict, str], int | None]
                 | None = None):
        # record write rvs → drop self-echo watch events (cluster/echo.py):
        # the culler's own annotation patches must not re-trigger it (its
        # cadence is the periodic requeue, not its writes)
        client = EchoTrackingClient(client)
        self.client = client
        self.config = config or ControllerConfig()
        self.metrics = metrics or MetricsRegistry()
        self.prober = prober or http_prober(self.config)
        self.serving_prober = serving_prober or \
            serving_requests_prober(self.config)
        self.clock = clock

    def setup(self, mgr: Manager) -> None:
        mgr.register(self)
        mgr.watch(api.KIND, self.name, predicate=self.client.not_echo)

    # ------------------------------------------------------------ reconcile
    def reconcile(self, req: Request) -> Result | None:
        notebook = self.client.get_or_none(api.KIND, req.namespace, req.name)
        if notebook is None or k8s.is_deleting(notebook):
            return None
        period_s = self.config.idleness_check_period_min * 60

        # stopped → annotations cleared, stop polling (reference :105-118)
        if k8s.get_annotation(notebook, names.STOP_ANNOTATION) is not None:
            self._strip_activity_annotations(notebook)
            return None

        # slice under repair (controllers/slicerepair.py): Jupyter being
        # unreachable is EXPECTED — workers are being rolled — so the idle
        # clock must PAUSE, never strip or advance last-activity toward a
        # cull mid-repair (culling a slice because its repair took an hour
        # would turn every incident into a data-loss event)
        repairing = k8s.get_annotation(
            notebook, names.SLICE_HEALTH_ANNOTATION) is not None

        # worker-0 must exist (reference checks pod <name>-0, :120-139)
        pod0 = self._worker0_pod(notebook)
        if pod0 is None:
            if repairing:
                # mid-repair scale-down: freeze the idle clock instead of
                # stripping (a strip would re-initialize last-activity and
                # silently reset accumulated idleness)
                self._pause_idle_clock(notebook)
                return Result(requeue_after=period_s)
            self._strip_activity_annotations(notebook)
            return Result(requeue_after=period_s)

        now = self.clock()
        last_check = k8s.get_annotation(
            notebook, names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION)
        last_activity = k8s.get_annotation(notebook,
                                           names.LAST_ACTIVITY_ANNOTATION)
        if last_check is None or last_activity is None:
            # first pass: initialize (reference :141-154,:458-465)
            self._retry_patch_annotations(notebook, {
                names.LAST_ACTIVITY_ANNOTATION: format_time(now),
                names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: format_time(now),
            })
            return Result(requeue_after=period_s)

        if now - parse_time(last_check) < period_s:
            return Result(requeue_after=period_s)  # reference :156-160

        activity = self.prober(notebook)
        if not activity.reachable and repairing:
            # unreachable probe while Degraded/Repairing/Quarantined: the
            # repair explains the silence; pause the idle clock (a
            # REACHABLE probe mid-repair still carries real data and takes
            # the normal path below)
            self._pause_idle_clock(notebook)
            return Result(requeue_after=period_s)
        updates = {names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION:
                   format_time(now)}
        if activity.reachable:
            if activity.any_busy():
                updates[names.LAST_ACTIVITY_ANNOTATION] = format_time(now)
            else:
                latest = activity.latest_activity()
                if latest is not None and latest > parse_time(last_activity):
                    updates[names.LAST_ACTIVITY_ANNOTATION] = format_time(latest)

        # serving-aware idleness: a notebook with the serving-port
        # annotation hosts a model endpoint (runtime/server.py); request
        # traffic since the previous probe IS activity — an endpoint
        # taking inference load must not be culled for having no Jupyter
        # kernels. The observed cumulative count rides an annotation so
        # the comparison survives controller restarts/failovers.
        serving_port = k8s.get_annotation(notebook,
                                          names.SERVING_PORT_ANNOTATION)
        if serving_port:
            total = self.serving_prober(notebook, serving_port)
            if total is not None:
                seen = k8s.get_annotation(
                    notebook, names.SERVING_REQUESTS_OBSERVED_ANNOTATION)
                try:
                    seen_n = int(seen) if seen is not None else None
                except ValueError:
                    seen_n = None
                if seen_n is None or total != seen_n:
                    if seen_n is not None and total > seen_n:
                        # traffic since the last probe (the first
                        # observation only arms; a DECREASE is a server
                        # restart — re-arm at the new baseline without
                        # crediting activity)
                        updates[names.LAST_ACTIVITY_ANNOTATION] = \
                            format_time(now)
                    updates[names.SERVING_REQUESTS_OBSERVED_ANNOTATION] = \
                        str(total)

        effective_last = parse_time(
            updates.get(names.LAST_ACTIVITY_ANNOTATION, last_activity))
        idle_s = now - effective_last
        if idle_s > self.config.cull_idle_time_min * 60:
            # cull: set stop annotation → core reconciler scales slice STS→0
            # (reference setStopAnnotation, :484-501)
            updates[names.STOP_ANNOTATION] = format_time(now)
            self.metrics.record_culling(req.namespace, req.name)
            log.info("culling %s/%s (idle %.0fs)", req.namespace, req.name,
                     idle_s)
        self._retry_patch_annotations(notebook, updates)
        return Result(requeue_after=period_s)

    # -------------------------------------------------------------- helpers
    def _worker0_pod(self, notebook: dict) -> dict | None:
        """The slice's Jupyter pod. With GenerateName STSs the pod isn't
        ``<nb>-0`` literally, so resolve through the notebook-name label +
        pod-index 0. A pool-BOUND notebook's workers live in the pool
        namespace (controllers/slicepool.py) — probing the notebook's own
        namespace would find nothing and strip the idle clock of a
        perfectly live notebook."""
        bound = pool_api.bound_slice_ref(notebook)
        pods = pool_api.bound_slice_pods(self.client, bound) if bound \
            else self.client.list("Pod", k8s.namespace(notebook),
                                  {names.NOTEBOOK_NAME_LABEL:
                                   k8s.name(notebook)})
        for pod in pods:
            if k8s.get_label(pod, names.POD_INDEX_LABEL, "0") == "0":
                return pod
        return None

    def _pause_idle_clock(self, notebook: dict) -> None:
        """Freeze accumulated idleness across a repair window: shift
        last-activity forward by exactly the time elapsed since the last
        check, so idle_s neither grows nor resets while the slice is being
        repaired. No-op before the clock is initialized, and throttled to
        the check period — repair-state churn fans every Notebook event
        into a culler reconcile, and pausing is always safe to defer
        (the shift lands the same wherever inside the window it runs)."""
        last_check = k8s.get_annotation(
            notebook, names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION)
        last_activity = k8s.get_annotation(notebook,
                                           names.LAST_ACTIVITY_ANNOTATION)
        if last_check is None or last_activity is None:
            return
        now = self.clock()
        elapsed = max(now - parse_time(last_check), 0.0)
        if elapsed < self.config.idleness_check_period_min * 60:
            return
        self._retry_patch_annotations(notebook, {
            names.LAST_ACTIVITY_ANNOTATION:
                format_time(min(parse_time(last_activity) + elapsed, now)),
            names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: format_time(now),
        })

    def _strip_activity_annotations(self, notebook: dict) -> None:
        if all(k8s.get_annotation(notebook, a) is None for a in (
                names.LAST_ACTIVITY_ANNOTATION,
                names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION,
                names.SERVING_REQUESTS_OBSERVED_ANNOTATION)):
            return
        self._retry_patch_annotations(notebook, {
            names.LAST_ACTIVITY_ANNOTATION: None,
            names.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: None,
            names.SERVING_REQUESTS_OBSERVED_ANNOTATION: None,
        })

    def _retry_patch_annotations(self, notebook: dict,
                                 annotations: dict[str, str | None]) -> None:
        """RetryOnConflict analog (merge patch is conflict-free in our store,
        but retry anyway for client symmetry with chaos wrappers)."""
        for attempt in range(5):
            try:
                self.client.patch(api.KIND, k8s.namespace(notebook),
                                  k8s.name(notebook),
                                  {"metadata": {"annotations": annotations}})
                return
            except errors.ConflictError:
                continue
            except errors.NotFoundError:
                return
        log.warning("annotation update for %s/%s kept conflicting",
                    k8s.namespace(notebook), k8s.name(notebook))
