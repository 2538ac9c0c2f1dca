"""The port's accelerator seams of the control plane against the
reference's: the H100 node table (kubeflow_tpu_torch/gpu/topology.py, on
the forms and errors of tests/test_topology.py), the notebook pod spec
(controllers/notebook.py ``apply_gpu_spec``), the warm pool slice
(controllers/slicepool.py ``warm_slice_statefulset``) and the webhook's
image choice (webhook/mutating.py ``swap_image_for_gpu``).

A notebook's StatefulSet is rendered two ways: by the reference's
``NotebookReconciler.generate_statefulset`` with a TPU slice, and by the
same with no slice followed by the port's ``apply_gpu_spec`` with an
H100 slice of the same worker count (``v5e-4``/``h100-4``: one worker;
``v5e-16``/``h100-32``: four). The two may differ only in the resource
key and quantity, the nodeSelectors, the slice label's value and the
TPU_ACCELERATOR_TYPE/TPU_TOPOLOGY values (the warm slice also in its
image).
"""

from __future__ import annotations

import copy

import pytest

from kubeflow_tpu.api import types as api
from kubeflow_tpu.api.slicepool import new_slice_pool
from kubeflow_tpu.cluster.store import ClusterStore
from kubeflow_tpu.controllers.notebook import NotebookReconciler
from kubeflow_tpu.controllers.slicepool import SlicePoolReconciler
from kubeflow_tpu.tpu import topology as jtopo
from kubeflow_tpu.utils import k8s as jk8s
from kubeflow_tpu.utils import names as jnames
from kubeflow_tpu.utils.config import ControllerConfig
from kubeflow_tpu.webhook import NotebookMutatingWebhook
from kubeflow_tpu.controllers import notebook as jnotebook
from kubeflow_tpu_torch.cluster.errors import InvalidError
from kubeflow_tpu_torch.controllers.notebook import (apply_gpu_spec,
                                                     headless_service_name)
from kubeflow_tpu_torch.controllers.slicepool import (slice_hostnames,
                                                      warm_slice_statefulset)
from kubeflow_tpu_torch.gpu.topology import (GpuRequestError,
                                             parse_short_name,
                                             parse_slice_request,
                                             parse_topology)
from kubeflow_tpu_torch.utils import names
from kubeflow_tpu_torch.webhook.mutating import swap_image_for_gpu

ACC = names.TPU_ACCELERATOR_ANNOTATION
TOPO = names.TPU_TOPOLOGY_ANNOTATION


# --------------------------------------------------------------- node table
@pytest.mark.parametrize("short,workers,per,machine", [
    ("h100-1", 1, 1, "a3-highgpu-1g"), ("h100-2", 1, 2, "a3-highgpu-2g"),
    ("h100-4", 1, 4, "a3-highgpu-4g"), ("h100-8", 1, 8, "a3-highgpu-8g"),
    ("h100-16", 2, 8, "a3-highgpu-8g"), ("h100-32", 4, 8, "a3-highgpu-8g"),
    ("h100-256", 32, 8, "a3-highgpu-8g")])
def test_short_names(short, workers, per, machine):
    s = parse_short_name(short)
    assert (s.num_workers, s.cards_per_worker, s.cards) == \
        (workers, per, workers * per)
    assert s.topology == (workers, per)
    assert s.topology_str == f"{workers}x{per}"
    assert s.short_name == short
    assert s.multi_host == (workers > 1)
    assert s.node_selectors() == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "node.kubernetes.io/instance-type": machine}


@pytest.mark.parametrize("short", ["h100-3", "h100-12", "h100-0", "h100-",
                                   "h100", "H100-8", "v5e-16", "a100-8"])
def test_bad_short_names(short):
    with pytest.raises(GpuRequestError) as err:
        parse_short_name(short)
    assert err.value.reason == "InvalidGPURequest"
    # an API error, as the reference's TpuRequestError (code 422)
    assert isinstance(err.value, InvalidError) and err.value.code == 422


def test_topologies():
    assert parse_topology("h100", "2x8") == parse_short_name("h100-16")
    assert parse_topology("h100", "1x4") == parse_short_name("h100-4")
    # the reference's 2-D v5e and 3-D v4 forms, for the same slots
    assert jtopo.parse_topology("v5e", "2x4").chips == \
        parse_topology("h100", "1x8").cards
    for gen, topo in (("h100", "2x4"), ("h100", "8x1"), ("h100", "4x4x4"),
                      ("h100", "banana"), ("h100", "1x3"), ("v5e", "2x8")):
        with pytest.raises(GpuRequestError):
            parse_topology(gen, topo)


def test_worker_hostnames_match_the_references():
    got = parse_short_name("h100-32").worker_hostnames(
        "mynb", "mynb-workers", "user-ns")
    assert got == jtopo.parse_short_name("v5e-16").worker_hostnames(
        "mynb", "mynb-workers", "user-ns")
    assert got[0] == "mynb-0.mynb-workers.user-ns.svc"
    assert slice_hostnames(parse_short_name("h100-8"), "p-w0", "pools") == \
        "localhost"


def test_parse_slice_request_annotations():
    assert parse_slice_request(None) is None
    assert parse_slice_request({"unrelated": "x"}) is None
    assert parse_slice_request({ACC: "h100-16"}).cards == 16
    s = parse_slice_request({ACC: "h100", TOPO: "2x8"})
    assert (s.cards, s.num_workers) == (16, 2)
    assert parse_slice_request({ACC: "h100"}) == parse_short_name("h100-1")
    for bad in ({TOPO: "2x8"}, {ACC: "v99-4"}, {ACC: "v5e-16"},
                {ACC: "h100-3"}, {ACC: "h100", TOPO: "2x4"}):
        with pytest.raises(GpuRequestError):
            parse_slice_request(bad)
    # the keys are the reference's
    assert (ACC, TOPO) == (jnames.TPU_ACCELERATOR_ANNOTATION,
                           jnames.TPU_TOPOLOGY_ANNOTATION)


@pytest.mark.parametrize("port_shape,ref_shape", [
    ("h100-3", "v5e-3"), ("h100-9", "v5e-9"), ("bogus", "bogus")])
def test_malformed_request_is_an_api_error_as_the_reference(port_shape,
                                                            ref_shape):
    """A malformed request raises an ``InvalidError`` on both sides: code
    422, the reason of each side's error class and a non-empty message
    (the webhook denies admission with it; the slice-repair reconciler
    skips the notebook on the class)."""
    from kubeflow_tpu.cluster.errors import InvalidError as RefInvalid
    got = {}
    for side, parse, shape, base in (
            ("ref", jtopo.parse_slice_request, ref_shape, RefInvalid),
            ("port", parse_slice_request, port_shape, InvalidError)):
        with pytest.raises(base) as err:
            parse({ACC: shape})
        got[side] = (type(err.value).__mro__[1].__name__, err.value.code,
                     bool(err.value.message),
                     err.value.message == str(err.value))
    assert got["port"] == got["ref"] == ("InvalidError", 422, True, True)


# ----------------------------------------------------------------- pod spec
def _normalise(sts: dict, resource_key: str) -> tuple[dict, dict]:
    """``sts`` with the fields the two renderings may differ in replaced,
    and those fields."""
    sts = copy.deepcopy(sts)
    seen: dict = {"slice": set(), "quantity": set(), "env": {}}
    for meta in (sts["metadata"], sts["spec"]["template"]["metadata"]):
        labels = meta.get("labels", {})
        if names.TPU_SLICE_LABEL in labels:
            seen["slice"].add(labels[names.TPU_SLICE_LABEL])
            labels[names.TPU_SLICE_LABEL] = "<slice>"
    pod = sts["spec"]["template"]["spec"]
    seen["selectors"] = pod.pop("nodeSelector", None)
    for c in pod["containers"]:
        for quantities in c.get("resources", {}).values():
            if resource_key in quantities:
                seen["quantity"].add(quantities.pop(resource_key))
                quantities["<key>"] = "<qty>"
        for e in c.get("env", []):
            if e["name"] in ("TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY"):
                seen["env"][e["name"]] = e["value"]
                e["value"] = "<value>"
    return sts, seen


def _both_statefulsets(tpu: str, gpu: str, nb_name: str = "mynb",
                       stopped: bool = False, real_name: str | None = None):
    rec = NotebookReconciler(ClusterStore())
    extra = {jnames.STOP_ANNOTATION: "2024-01-01T00:00:00Z"} if stopped \
        else {}

    def notebook(acc):
        return api.new_notebook(nb_name, "user-ns", image="jupyter:latest",
                                annotations={ACC: acc, **extra})
    ref = rec.generate_statefulset(
        notebook(tpu), jtopo.parse_short_name(tpu), actual_sts_name=real_name)
    nb = notebook(gpu)
    port = rec.generate_statefulset(nb, None)
    sts_name = real_name or port["metadata"].get("name")
    apply_gpu_spec(port, nb, parse_short_name(gpu), sts_name)
    return ref, port


def _env(sts) -> dict:
    return jk8s.env_list_to_dict(
        sts["spec"]["template"]["spec"]["containers"][0]["env"])


@pytest.mark.parametrize("tpu,gpu,nb_name,real_name", [
    ("v5e-4", "h100-4", "mynb", None),
    ("v5e-16", "h100-32", "mynb", None),
    ("v5e-16", "h100-32", "n" * 60, "nb-x7k2q"),   # GenerateName, created
    ("v5e-16", "h100-32", "n" * 60, None),         # GenerateName, first
], ids=["single_host", "multi_host", "generate_name", "generate_name_first"])
def test_notebook_statefulset_differs_only_in_the_accelerator(
        tpu, gpu, nb_name, real_name):
    ref, port = _both_statefulsets(tpu, gpu, nb_name, real_name=real_name)
    ref_n, ref_seen = _normalise(ref, jnames.TPU_RESOURCE_KEY)
    port_n, port_seen = _normalise(port, names.GPU_RESOURCE_KEY)
    assert port_n == ref_n
    spec = parse_short_name(gpu)
    assert port_seen["slice"] == {gpu}
    assert port_seen["quantity"] == {str(spec.cards_per_worker)}
    assert port_seen["selectors"] == spec.node_selectors()
    assert port_seen["env"] == {"TPU_ACCELERATOR_TYPE": gpu,
                                "TPU_TOPOLOGY": spec.topology_str}
    assert port["spec"]["replicas"] == ref["spec"]["replicas"] == \
        spec.num_workers
    env = _env(port)
    if spec.multi_host and real_name is None and nb_name != "mynb":
        assert "TPU_WORKER_HOSTNAMES" not in env   # no name to derive yet
    elif spec.multi_host:
        assert env["TPU_WORKER_HOSTNAMES"] == _env(ref)[
            "TPU_WORKER_HOSTNAMES"]
        headless = headless_service_name(nb_name)
        assert headless == jnotebook.headless_service_name(nb_name)
        assert port["spec"]["serviceName"] == headless
        assert env["TPU_WORKER_HOSTNAMES"].split(",")[0] == \
            f"{real_name or nb_name}-0.{headless}.user-ns.svc"
    else:
        assert env["TPU_WORKER_HOSTNAMES"] == "localhost"


@pytest.mark.parametrize("tpu,gpu", [("v5e-4", "h100-4"),
                                     ("v5e-16", "h100-32")])
def test_stopped_notebook_stays_at_zero_replicas(tpu, gpu):
    ref, port = _both_statefulsets(tpu, gpu, stopped=True)
    assert ref["spec"]["replicas"] == port["spec"]["replicas"] == 0
    assert _normalise(port, names.GPU_RESOURCE_KEY)[0] == \
        _normalise(ref, jnames.TPU_RESOURCE_KEY)[0]


def test_apply_gpu_spec_is_idempotent():
    _, port = _both_statefulsets("v5e-16", "h100-32")
    again = copy.deepcopy(port)
    nb = api.new_notebook("mynb", "user-ns", image="jupyter:latest",
                          annotations={ACC: "h100-32"})
    apply_gpu_spec(again, nb, parse_short_name("h100-32"), "mynb")
    assert again == port


# --------------------------------------------------------------- warm slice
@pytest.mark.parametrize("tpu,gpu", [("v5e-4", "h100-4"),
                                     ("v5e-16", "h100-32")])
def test_warm_slice_differs_only_in_the_accelerator(tpu, gpu):
    store = ClusterStore()
    pool = new_slice_pool("pool-a", tpu, 1)
    name = SlicePoolReconciler(store)._create_warm_slice(
        pool, jtopo.parse_short_name(tpu), "pools", set())
    ref = store.get("StatefulSet", "pools", name)
    ref["metadata"] = {k: ref["metadata"][k] for k in
                       ("name", "namespace", "labels", "annotations")}
    ref.pop("status", None)
    port = warm_slice_statefulset(pool, parse_short_name(gpu), "pools", name,
                                  "jupyter-pytorch-cuda:v1")
    ref_n, _ = _normalise(ref, jnames.TPU_RESOURCE_KEY)
    port_n, seen = _normalise(port, names.GPU_RESOURCE_KEY)
    for sts in (ref_n, port_n):
        sts["spec"]["template"]["spec"]["containers"][0]["image"] = "<image>"
    assert port_n == ref_n
    spec = parse_short_name(gpu)
    assert seen["selectors"] == spec.node_selectors()
    assert seen["quantity"] == {str(spec.cards_per_worker)}
    assert port["spec"]["replicas"] == spec.num_workers
    with pytest.raises(ValueError, match="longer than"):
        warm_slice_statefulset(pool, spec, "pools", "p" * 53, "img")


# ------------------------------------------------------------- image choice
MAPPED = "custom:notebook-v1"
# (name, image, reference annotations, port annotations, reference swaps,
#  port swaps)
IMAGES = [
    ("mapped", MAPPED, {ACC: "v5e-4"}, {ACC: "h100-4"}, True, True),
    ("cuda", "quay.io/jupyter-cuda:2024", {ACC: "v5e-4"}, {ACC: "h100-4"},
     True, False),
    ("jax", "my-jax-notebook:latest", {ACC: "v5e-4"}, {ACC: "h100-4"},
     False, True),
    ("generic", "jupyter/minimal-notebook", {ACC: "v5e-4"}, {ACC: "h100-4"},
     True, True),
    ("rocm", "rocm/pytorch", {ACC: "v5e-4"}, {ACC: "h100-4"}, True, True),
    ("python", "python:3.12", {ACC: "v5e-4"}, {ACC: "h100-4"}, False, False),
    ("no_request", "jupyter/minimal-notebook", {}, {}, False, False),
    ("malformed", "jupyter/minimal-notebook", {ACC: "v5e-3"},
     {ACC: "h100-3"}, False, False),
]


@pytest.fixture(scope="module")
def reference_store():
    """A ClusterStore with the reference's mutating webhook installed, as
    tests/test_webhook.py sets it up (the validating webhook, which denies
    a malformed request, is left out so the mutation shows)."""
    store = ClusterStore()
    config = ControllerConfig(tpu_default_image="jax-notebook:v1",
                              image_swap_map={MAPPED: "custom:tpu"})
    NotebookMutatingWebhook(store, config).install(store)
    return store


@pytest.mark.parametrize("name,image,ref_ann,port_ann,ref_swaps,port_swaps",
                         IMAGES, ids=[i[0] for i in IMAGES])
def test_image_choice(reference_store, name, image, ref_ann, port_ann,
                      ref_swaps, port_swaps):
    nb_name = f"nb-{name.replace('_', '-')}"
    ref = reference_store.create(
        api.new_notebook(nb_name, "ns", image=image, annotations=ref_ann))
    nb = api.new_notebook(nb_name, "ns", image=image, annotations=port_ann)
    kw = dict(swap_map={MAPPED: "custom:h100"},
              default_image="jupyter-pytorch-cuda:v1")
    swapped = swap_image_for_gpu(nb, **kw)
    got = {"ref": api.notebook_container(ref)["image"],
           "port": api.notebook_container(nb)["image"]}
    assert (got["ref"] != image) == ref_swaps, got
    assert (got["port"] != image) == port_swaps == swapped, got
    for which, obj, swaps in (("ref", ref, ref_swaps),
                              ("port", nb, port_swaps)):
        original = jk8s.get_annotation(obj,
                                       names.TPU_ORIGINAL_IMAGE_ANNOTATION)
        assert original == (image if swaps else None), which
    if port_swaps:
        assert got["port"] == ("custom:h100" if name == "mapped"
                               else "jupyter-pytorch-cuda:v1")
        # admitted again, the swapped image is kept
        assert not swap_image_for_gpu(nb, **kw)
        assert api.notebook_container(nb)["image"] == got["port"]
