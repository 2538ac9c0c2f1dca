"""The two control-plane stacks the port's parity tests drive side by
side, and the normaliser that compares what they write (a helper module:
pytest collects no tests from it).

``Stack("ref")`` is the reference's store, Manager, NotebookReconciler,
StatefulSet simulator, culler, slice repair reconciler, SlicePool
reconciler, fleet scheduler and extension reconciler; ``Stack("port")``
the port's. A case is a function of one stack that uses the names both
sides share (``api``, ``k8s``, ``names``, ``culling``, ``slicerepair``,
``kubelet``, the extension tier's modules under ``ext``, ...), so the
same code drives both. ``Stack.entry_point`` swaps a stack's manager for
the side's whole composition: the reference's ``setup_controllers(...,
webhooks=False)``, the port's ``build_manager``.

The same Notebook or SlicePool goes to both sides; only its accelerator
request is mapped, to the H100 shape with the same worker count
(``v5e-1`` ↔ ``h100-1``, ``v5e-4`` (1 x 4) ↔ ``h100-4`` (1 x 4), ``v5e-8`` (1 x 8) ↔ ``h100-8``
(1 x 8), ``v5e-16`` (4 x 4) ↔ ``h100-32`` (4 x 8), ``v5e-32`` (8 x 4) ↔
``h100-64`` (8 x 8)).
``normalise`` drops ``uid``, ``resourceVersion`` and timestamps, and maps
only the accelerator seam: the resource key and its per-worker count,
the nodeSelector, the TPU_ACCELERATOR_TYPE and TPU_TOPOLOGY values and
the slice label's value, the request itself (the Notebook's
annotation, a SlicePool's ``spec.accelerator``) and the images the
webhook's swap turns round (``IMAGES``: the image a warm pool slice is
rolled with, each side's ``tpu_default_image``, the reference's JAX
image and the port's CUDA one; the image each side's webhook swaps in;
the image it swaps out, a CUDA image for the reference and a JAX one
for the port; a swap map's pair), each a token for its role wherever
it stands as a value. A warm pool slice's pods
carry no slice label: their shape is read from their container's
TPU_ACCELERATOR_TYPE value. Everything else —
names, generateName suffixes, labels, annotations (the culler's stamps
among them), owner references, env order, replicas, serviceName,
hostnames, condition reasons — must be equal.
"""

from __future__ import annotations

from types import SimpleNamespace

from kubeflow_tpu import webhook as ref_webhook
from kubeflow_tpu.api import schema as ref_schema
from kubeflow_tpu.api import slicepool as ref_pool_api
from kubeflow_tpu.api import tpuquota as ref_quota_api
from kubeflow_tpu.api import types as ref_api
from kubeflow_tpu.cluster import errors as ref_errors
from kubeflow_tpu.cluster import kubelet as ref_kubelet
from kubeflow_tpu.cluster.kubelet import StatefulSetSimulator as RefSimulator
from kubeflow_tpu.cluster.store import ClusterStore as RefStore
from kubeflow_tpu.controllers import auth as ref_auth
from kubeflow_tpu.controllers import cacert as ref_cacert
from kubeflow_tpu.controllers import culling as ref_culling
from kubeflow_tpu.controllers import elyra as ref_elyra
from kubeflow_tpu.controllers import extension as ref_extension
from kubeflow_tpu.controllers import netpol as ref_netpol
from kubeflow_tpu.controllers import oauth as ref_oauth
from kubeflow_tpu.controllers import rbac as ref_rbac
from kubeflow_tpu.controllers import routes as ref_routes
from kubeflow_tpu.controllers import runtime_images as ref_runtime_images
from kubeflow_tpu.controllers import scheduler as ref_scheduler
from kubeflow_tpu.controllers import slicerepair as ref_slicerepair
from kubeflow_tpu.controllers.slicepool import (
    SlicePoolReconciler as RefPoolReconciler)
from kubeflow_tpu.controllers.manager import Manager as RefManager
from kubeflow_tpu.controllers.manager import Request as RefRequest
from kubeflow_tpu.controllers.notebook import (
    NotebookReconciler as RefReconciler)
from kubeflow_tpu.utils import k8s as ref_k8s
from kubeflow_tpu.utils import names as ref_names
from kubeflow_tpu.utils.config import ControllerConfig as RefConfig
from kubeflow_tpu.utils.metrics import MetricsRegistry as RefMetrics
from kubeflow_tpu.webhook import diff as ref_diff
from kubeflow_tpu.webhook import mutating as ref_mutating
from kubeflow_tpu.webhook import server as ref_server
from kubeflow_tpu_torch import webhook
from kubeflow_tpu_torch.api import schema
from kubeflow_tpu_torch.api import slicepool as pool_api
from kubeflow_tpu_torch.api import tpuquota as quota_api
from kubeflow_tpu_torch.api import types as api
from kubeflow_tpu_torch.cluster import errors, kubelet
from kubeflow_tpu_torch.cluster.kubelet import StatefulSetSimulator
from kubeflow_tpu_torch.cluster.store import ClusterStore
from kubeflow_tpu_torch.controllers import (auth, cacert, culling, elyra,
                                            extension, netpol, oauth, rbac,
                                            routes, runtime_images,
                                            scheduler, slicerepair)
from kubeflow_tpu_torch.controllers import (Manager, NotebookReconciler,
                                            Request, SlicePoolReconciler)
from kubeflow_tpu_torch.utils import k8s, names
from kubeflow_tpu_torch.utils.config import ControllerConfig
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
from kubeflow_tpu_torch.webhook import diff, mutating, server

# the extension tier's modules of each side, under the names both share
EXT = {"ref": SimpleNamespace(
           auth=ref_auth, cacert=ref_cacert, elyra=ref_elyra,
           extension=ref_extension, netpol=ref_netpol, oauth=ref_oauth,
           rbac=ref_rbac, routes=ref_routes,
           runtime_images=ref_runtime_images),
       "port": SimpleNamespace(
           auth=auth, cacert=cacert, elyra=elyra, extension=extension,
           netpol=netpol, oauth=oauth, rbac=rbac, routes=routes,
           runtime_images=runtime_images)}
# the admission tier of each side: the webhooks, the diff reporter and
# the AdmissionReview server
WH = {"ref": SimpleNamespace(
          Mutating=ref_webhook.NotebookMutatingWebhook,
          Validating=ref_webhook.NotebookValidatingWebhook,
          AdmissionDenied=ref_webhook.AdmissionDenied,
          mutating=ref_mutating, diff=ref_diff, server=ref_server),
      "port": SimpleNamespace(
          Mutating=webhook.NotebookMutatingWebhook,
          Validating=webhook.NotebookValidatingWebhook,
          AdmissionDenied=webhook.AdmissionDenied,
          mutating=mutating, diff=diff, server=server)}

# each reference request and the port's request with the same workers
SHAPES = {"v5e-1": "h100-1", "v5e-4": "h100-4", "v5e-8": "h100-8", "v5e-16": "h100-32",
          "v5e-32": "h100-64"}
REF_OF = {port: ref for ref, port in SHAPES.items()}
# what each side renders for a shape, written out (not read back from
# either package's topology table)
RENDERED = {
    "v5e-1": {"nodeSelector": {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
        "cloud.google.com/gke-tpu-topology": "1x1"},
        "per_worker": "1", "topology": "1x1"},
    "v5e-4": {"nodeSelector": {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
        "cloud.google.com/gke-tpu-topology": "2x2"},
        "per_worker": "4", "topology": "2x2"},
    "v5e-8": {"nodeSelector": {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
        "cloud.google.com/gke-tpu-topology": "2x4"},
        "per_worker": "8", "topology": "2x4"},
    "v5e-16": {"nodeSelector": {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
        "cloud.google.com/gke-tpu-topology": "4x4"},
        "per_worker": "4", "topology": "4x4"},
    "v5e-32": {"nodeSelector": {
        "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice",
        "cloud.google.com/gke-tpu-topology": "4x8"},
        "per_worker": "4", "topology": "4x8"},
    "h100-1": {"nodeSelector": {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "node.kubernetes.io/instance-type": "a3-highgpu-1g"},
        "per_worker": "1", "topology": "1x1"},
    "h100-4": {"nodeSelector": {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "node.kubernetes.io/instance-type": "a3-highgpu-4g"},
        "per_worker": "4", "topology": "1x4"},
    "h100-8": {"nodeSelector": {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "node.kubernetes.io/instance-type": "a3-highgpu-8g"},
        "per_worker": "8", "topology": "1x8"},
    "h100-32": {"nodeSelector": {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "node.kubernetes.io/instance-type": "a3-highgpu-8g"},
        "per_worker": "8", "topology": "4x8"},
    "h100-64": {"nodeSelector": {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "node.kubernetes.io/instance-type": "a3-highgpu-8g"},
        "per_worker": "8", "topology": "8x8"},
}
RESOURCE_KEY = {"ref": "google.com/tpu", "port": "nvidia.com/gpu"}
# the images the accelerator seam turns round, by role: "warm" the image
# each side rolls its warm pool slices with (its default
# tpu_default_image), "default" the tpu_default_image the webhook cases
# configure, "foreign" an image the side's webhook swaps out (CUDA for
# the reference, JAX for the port) and "foreign-digest" a digest-pinned
# one, "native" one it keeps, "mapped-from"/"mapped-to" a swap map's pair
IMAGES = {
    "ref": {"warm": RefConfig().tpu_default_image,
            "default": "jax-notebook:v1",
            "foreign": "quay.io/jupyter-cuda:2024",
            "foreign-digest": "reg.example.com/cuda-notebook@sha256:"
                              + "c" * 64,
            "native": "my-jax-notebook:latest",
            "mapped-from": "custom:cuda", "mapped-to": "custom:tpu"},
    "port": {"warm": ControllerConfig().tpu_default_image,
             "default": "cuda-notebook:v1",
             "foreign": "quay.io/jupyter-jax:2024",
             "foreign-digest": "reg.example.com/jax-notebook@sha256:"
                               + "c" * 64,
             "native": "my-cuda-notebook:latest",
             "mapped-from": "custom:jax", "mapped-to": "custom:cuda"}}
IMAGE_TOKENS = {side: {image: f"<{role} image>"
                       for role, image in images.items()}
                for side, images in IMAGES.items()}
TIMESTAMP_KEYS = frozenset({
    "creationTimestamp", "deletionTimestamp", "lastTransitionTime",
    "startedAt", "firstTimestamp", "lastTimestamp", "eventTime",
    "timeAdded"})
# where the request itself is written: the slice label, the Notebook's
# accelerator annotation and a SlicePool's spec.accelerator
SLICE_KEYS = (names.TPU_SLICE_LABEL, names.TPU_ACCELERATOR_ANNOTATION,
              "accelerator")


# ------------------------------------------------------------ normaliser
def _shape_of(obj: dict) -> str | None:
    md = obj.get("metadata") or {}
    if obj.get("kind") == pool_api.KIND:
        return (obj.get("spec") or {}).get("accelerator")
    shape = ((md.get("labels") or {}).get(names.TPU_SLICE_LABEL)
             or (md.get("annotations") or {}).get(
                 names.TPU_ACCELERATOR_ANNOTATION))
    if shape is None and obj.get("kind") == "Pod":
        for c in (obj.get("spec") or {}).get("containers") or []:
            for e in c.get("env") or []:
                if e.get("name") == "TPU_ACCELERATOR_TYPE":
                    return e.get("value")
    return shape


def _walk(value, side: str, shape: str | None):
    if isinstance(value, str):
        return IMAGE_TOKENS[side].get(value, value)
    if isinstance(value, list):
        return [_walk(v, side, shape) for v in value]
    if not isinstance(value, dict):
        return value
    pair = (shape if side == "ref" else REF_OF.get(shape)) \
        if shape in RENDERED else None
    want = RENDERED.get(shape)
    if pair is not None and value.get("name") in (
            "TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY") and "value" in value:
        expected = (shape if value["name"] == "TPU_ACCELERATOR_TYPE"
                    else want["topology"])
        if value["value"] == expected:
            return {**value, "value": f"<{value['name']} of {pair}>"}
    out = {}
    for key, val in value.items():
        if key in ("uid", "resourceVersion"):
            continue
        if key in TIMESTAMP_KEYS:
            out[key] = "<time>"
        elif key == "workerUIDs" and isinstance(val, dict):
            out[key] = {n: "<uid>" for n in val}
        elif pair is not None and key == "nodeSelector" \
                and val == want["nodeSelector"]:
            out[key] = f"<node selectors of {pair}>"
        elif pair is not None and key in ("requests", "limits") \
                and isinstance(val, dict):
            out[key] = {
                ("<accelerator resource>" if k == RESOURCE_KEY[side] else k):
                (f"<per-worker count of {pair}>"
                 if k == RESOURCE_KEY[side] and v == want["per_worker"]
                 else _walk(v, side, shape))
                for k, v in val.items()}
        elif pair is not None and key in SLICE_KEYS and val == shape:
            out[key] = f"<slice {pair}>"
        else:
            out[key] = _walk(val, side, shape)
    return out


def normalise(obj: dict, side: str) -> dict:
    """``obj`` with uid, resourceVersion and timestamps dropped and the
    accelerator seam of ``side`` ("ref" or "port") mapped to tokens that
    name the reference's shape."""
    return _walk(obj, side, _shape_of(obj))


def normalise_result(value, side: str):
    """What a parity case returns, after ``normalise``: each object on its
    own (its accelerator request maps its own seam), lists and tuples
    element by element, a bare string through the seam's images."""
    if isinstance(value, dict):
        return normalise(value, side)
    if isinstance(value, (list, tuple)):
        return [normalise_result(v, side) for v in value]
    return _walk(value, side, None)


# ---------------------------------------------------------------- stacks
class Stack:
    """One side's control plane, driven by the case functions below
    through the names they share (``api``, ``k8s``, ``names``, ...)."""

    def __init__(self, side: str):
        self.side = side
        ref = side == "ref"
        self.api = ref_api if ref else api
        self.pool_api = ref_pool_api if ref else pool_api
        self.quota_api = ref_quota_api if ref else quota_api
        self.k8s = ref_k8s if ref else k8s
        self.names = ref_names if ref else names
        self.Request = RefRequest if ref else Request
        self.culling = ref_culling if ref else culling
        self.slicerepair = ref_slicerepair if ref else slicerepair
        self.scheduler_mod = ref_scheduler if ref else scheduler
        self.ext = EXT[side]
        self.wh = WH[side]
        self.schema = ref_schema if ref else schema
        self.errors = ref_errors if ref else errors
        self.kubelet = ref_kubelet if ref else kubelet
        self.Config = RefConfig if ref else ControllerConfig
        self.store = RefStore() if ref else ClusterStore()
        self.config = self.Config()
        self.metrics = RefMetrics() if ref else MetricsRegistry()
        self.manager = (RefManager if ref else Manager)(self.store)
        self.NotebookReconciler = RefReconciler if ref \
            else NotebookReconciler
        self.SlicePoolReconciler = RefPoolReconciler if ref \
            else SlicePoolReconciler
        self._simulator = RefSimulator if ref else StatefulSetSimulator
        self.drains: list[int] = []
        self.timed = False

    def reconciler(self, **kw):
        """The side's NotebookReconciler on this stack's store, config and
        metrics; ``kw`` is its wall clock."""
        rec = self.NotebookReconciler(self.store, self.config, self.metrics,
                                      **kw)
        rec.setup(self.manager)
        return rec

    def simulator(self, **kw):
        """The side's StatefulSet simulator, with no boot delay unless
        ``kw`` gives one; ``kw`` are its boot delay, node grace and ready
        hook."""
        self.timed = True   # pod readiness rides a timed requeue
        kw.setdefault("boot_delay_s", 0.0)
        sim = self._simulator(self.store, **kw)
        sim.setup(self.manager)
        return sim

    def culler(self, **kw):
        """The side's CullingReconciler on this stack's store, config and
        metrics; ``kw`` are its probers and clock."""
        rec = self.culling.CullingReconciler(self.store, self.config,
                                             self.metrics, **kw)
        rec.setup(self.manager)
        return rec

    def repairer(self, **kw):
        """The side's SliceRepairReconciler on this stack's store, config
        and metrics; ``kw`` are its clock and rng."""
        rec = self.slicerepair.SliceRepairReconciler(
            self.store, self.config, self.metrics, **kw)
        rec.setup(self.manager)
        return rec

    def pool(self, **kw):
        """The side's SlicePoolReconciler on this stack's store, config
        and metrics; ``kw`` are its clock and wall clock."""
        rec = self.SlicePoolReconciler(self.store, self.config, self.metrics,
                                       **kw)
        rec.setup(self.manager)
        return rec

    def scheduler(self, **kw):
        """The side's SchedulerReconciler on this stack's store, config
        and metrics; ``kw`` is its wall clock."""
        rec = self.scheduler_mod.SchedulerReconciler(
            self.store, self.config, self.metrics, **kw)
        rec.setup(self.manager)
        return rec

    def extension(self, **kw):
        """The side's ExtensionReconciler on this stack's store, config
        and metrics."""
        rec = self.ext.extension.ExtensionReconciler(
            self.store, self.config, self.metrics, **kw)
        rec.setup(self.manager)
        return rec

    def entry_point(self, simulate_kubelet: bool = False,
                    webhooks: bool = False):
        """Replace this stack's manager with the side's whole control
        plane on its store and config: the reference's
        ``setup_controllers(..., webhooks=webhooks)`` (its simulator added
        as its ``main.build_manager`` adds it), the port's
        ``build_manager(components="all", webhooks=webhooks)``. Each
        installs its own Notebook CRD first, then the SlicePool and
        TPUQuota ones, so both stores count the same creates (uids,
        resourceVersions and generateName suffixes line up). ``self.base``
        is the write count once the stack is built."""
        if self.side == "ref":
            from kubeflow_tpu.controllers import setup_controllers
            self.manager = setup_controllers(self.store, self.config,
                                             webhooks=webhooks)
            if simulate_kubelet:
                self._simulator(self.manager.read_cache).setup(self.manager)
        else:
            from kubeflow_tpu_torch.main import build_manager
            # the webhooks only when asked, as the reference's side
            self.manager, _ = build_manager(
                self.store, self.config, components="all",
                webhooks=webhooks, simulate_kubelet=simulate_kubelet)
        if simulate_kubelet:
            self.timed = True
        self.base = self.store._last_rv
        return self.manager

    def quota(self, name: str, tenant: str, n: int) -> dict:
        """A TPUQuota CR of this side: ``tenant`` may hold ``n`` slices."""
        return self.quota_api.new_tpu_quota(name, tenant, n)

    def slice_pool(self, name: str, ref_shape: str, warm: int, **kw) -> dict:
        """A SlicePool CR of this side for the reference's shape
        ``ref_shape``: its ``spec.accelerator`` is the side's request;
        ``kw`` are its namespace and weights."""
        return self.pool_api.new_slice_pool(name, self.accelerator(ref_shape),
                                            warm, **kw)

    def image(self, role: str) -> str:
        """This side's image of ``role`` (``IMAGES``)."""
        return IMAGES[self.side][role]

    def accelerator(self, ref_shape: str) -> str:
        return ref_shape if self.side == "ref" else SHAPES[ref_shape]

    def rendered(self, ref_shape: str) -> dict:
        return RENDERED[self.accelerator(ref_shape)]

    def drain(self, include_delayed_under: float = 0.0,
              timeout: float = 10.0) -> int:
        n = self.manager.run_until_idle(
            timeout=timeout, include_delayed_under=include_delayed_under)
        self.drains.append(n)
        return n

    def apply(self, nb: dict) -> dict:
        out = self.store.create(nb)
        self.drain()
        return out

    def snapshot(self) -> dict:
        return {(o["kind"], self.k8s.namespace(o), self.k8s.name(o)):
                normalise(o, self.side) for o in self.store.all_objects()}


def assert_parity(ref: Stack, port: Stack) -> None:
    """Every object of both stores equal after ``normalise``; with no
    timed requeue in play, the same writes and the same reconciles too."""
    want, got = ref.snapshot(), port.snapshot()
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        assert got[key] == want[key], key
    if not ref.timed:
        assert port.store._last_rv == ref.store._last_rv   # writes
        assert port.drains == ref.drains                    # reconciles


# ----------------------------------------------------------------- spans
def tracer_name(name: str) -> str:
    """A tracer's name with the reference's package prefix mapped onto
    the port's (``kubeflow_tpu.webhook`` → ``kubeflow_tpu_torch.webhook``)."""
    if name.startswith("kubeflow_tpu."):
        return "kubeflow_tpu_torch." + name[len("kubeflow_tpu."):]
    return name


class Ids:
    """Trace and span ids as ordinal tokens in order of first appearance
    (``<trace 1>``, ``<span 3>``); an int id and its hex form are one id."""

    def __init__(self):
        self._tokens: dict = {}
        self._counts: dict = {}

    def __call__(self, kind: str, value):
        if value is None:
            return None
        if isinstance(value, str):
            value = int(value, 16)
        key = (kind, value)
        if key not in self._tokens:
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._tokens[key] = f"<{kind} {self._counts[kind]}>"
        return self._tokens[key]


def normalise_spans(spans, side: str, ids: Ids | None = None) -> list:
    """Spans (``Span`` objects or the recorder's span dicts) as compared
    across the packages: ids as ordinal tokens, the tracer prefix mapped,
    wall-clock times dropped (start, end, duration, event times), the
    rest through ``normalise_result``."""
    ids = ids if ids is not None else Ids()
    out = []
    for s in spans:
        d = s if isinstance(s, dict) else {
            "name": s.name, "tracer": s.tracer, "trace_id": s.trace_id,
            "span_id": s.span_id, "parent_id": s.parent_id,
            "attributes": s.attributes, "status": s.status,
            "status_description": s.status_description,
            "events": [{"name": e.name, "attributes": e.attributes}
                       for e in s.events]}
        out.append({
            "name": d["name"], "tracer": tracer_name(d["tracer"]),
            "trace_id": ids("trace", d["trace_id"]),
            "span_id": ids("span", d["span_id"]),
            "parent_id": ids("span", d["parent_id"]),
            "attributes": dict(d["attributes"]), "status": d["status"],
            "status_description": d.get("status_description"),
            "events": [{"name": e["name"],
                        "attributes": dict(e["attributes"])}
                       for e in d["events"]]})
    return normalise_result(out, side)
