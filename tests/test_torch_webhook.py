"""The port's admission webhooks held against the reference's, case for
case, on each side's own store.

Every case of tests/test_webhook.py, tests/test_restart_gating.py,
tests/test_image_resolution.py, tests/test_feast_config.py and
tests/test_auth_sidecar_resources.py (each parametrised case on its
own), ``TestEnvInjection`` of tests/test_mlflow.py and ``TestMount`` of
tests/test_runtime_images.py runs through each package: its mutating and
validating webhooks installed on its store (``torch_parity.Stack``), or
its mutating webhook's ``handle`` called directly, as the reference's
case does, each side with the case's own assertions. Then what the case
returns (the admitted objects, each denial's type, code and message),
every object of both stores after ``normalise`` and the writes are
compared.

The accelerator seam is the one divergence, held exactly on each side:
the reference's webhook swaps a CUDA or generic image for its JAX image,
the port's a JAX, TPU, ROCm or generic one for its CUDA image
(``torch_parity.IMAGES`` names each side's image of each role, and
``normalise`` maps each to one token); a slice request is ``v5e-N`` on
the reference's side and ``h100-N`` on the port's, under the same
annotation keys; a malformed or resized request is denied with each
side's own message, asserted word for word.
"""

from __future__ import annotations

import json

import pytest

from torch_parity import Stack, normalise, normalise_result

NS = "proj"
CENTRAL = "kubeflow-tpu-system"
GW_NS = "openshift-ingress"
GW_NAME = "data-science-gateway"
ENV_VARS = ("MLFLOW_TRACKING_URI", "MLFLOW_K8S_INTEGRATION",
            "MLFLOW_TRACKING_AUTH")
DIGEST_OLD = ("image-registry.example.com/ds/jupyter-ds"
              "@sha256:" + "a" * 64)
DIGEST_NEW = ("image-registry.example.com/ds/jupyter-ds"
              "@sha256:" + "b" * 64)
FEAST_VOL = "feast-config"
FEAST_PATH = "/opt/app-root/src/feast-config"
RI_VOL = "runtime-images"


# ------------------------------------------------------------ helpers
def install(s, mutating=True, validating=True, **config):
    """The reference's ``world`` fixtures on stack ``s``: a config, the
    mutating webhook then the validating one on the side's store."""
    s.config = s.Config(**config)
    if mutating:
        s.wh.Mutating(s.store, s.config).install(s.store)
    if validating:
        s.wh.Validating(s.config).install(s.store)
    return s.store


def swap_world(s):
    """tests/test_webhook.py's ``world``: the side's default accelerator
    image and a swap map of one pair."""
    return install(s, tpu_default_image=s.image("default"),
                   image_swap_map={s.image("mapped-from"):
                                   s.image("mapped-to")})


def hook(s, client=None, **config):
    """A mutating webhook of the side on ``client`` (the store)."""
    return s.wh.Mutating(client if client is not None else s.store,
                         s.Config(**config))


def denied(s, fn, exc_type=None, match: str | None = None) -> tuple:
    """``fn()`` is denied with ``exc_type`` (the side's
    ``AdmissionDenied`` when None); its type, code and message."""
    exc_type = exc_type or s.wh.AdmissionDenied
    with pytest.raises(exc_type, match=match) as exc:
        fn()
    return type(exc.value).__name__, exc.value.code, exc.value.message


def container(s, nb) -> dict:
    return s.api.notebook_container(nb)


def env_of(s, nb) -> dict:
    return s.k8s.env_list_to_dict(container(s, nb).get("env", []) or [])


def trust_bundle(s, ns="ns"):
    s.store.create({"apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"name": "workbench-trusted-ca-bundle",
                                 "namespace": ns},
                    "data": {"ca-bundle.crt": "CERT"}})


def unlock(s, ns="ns", name="nb"):
    return s.store.patch(s.api.KIND, ns, name, {"metadata": {
        "annotations": {s.names.STOP_ANNOTATION: None}}})


def annotate(s, anns, ns="ns", name="nb"):
    return s.store.patch(s.api.KIND, ns, name,
                         {"metadata": {"annotations": anns}})


# ------------------------------------------- tests/test_webhook.py
def wh_reconciliation_lock_injected_on_create(s):
    swap_world(s)
    out = s.store.create(s.api.new_notebook("nb", "ns"))
    assert s.k8s.get_annotation(out, s.names.STOP_ANNOTATION) == \
        s.names.RECONCILIATION_LOCK_VALUE
    return out


def wh_lock_not_injected_on_update(s):
    swap_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    cur = s.store.get(s.api.KIND, "ns", "nb")
    s.k8s.remove_annotation(cur, s.names.STOP_ANNOTATION)
    out = s.store.update(cur)
    assert s.k8s.get_annotation(out, s.names.STOP_ANNOTATION) is None
    return out


def wh_image_swap_for_tpu_notebook(s):
    """Turned round: the reference swaps a CUDA image for its JAX one,
    the port a JAX image for its CUDA one; the original is recorded."""
    swap_world(s)
    nb = s.api.new_notebook("nb", "ns", image=s.image("foreign"),
                            annotations={s.names.TPU_ACCELERATOR_ANNOTATION:
                                         s.accelerator("v5e-4")})
    out = s.store.create(nb)
    assert container(s, out)["image"] == s.image("default")
    assert s.k8s.get_annotation(
        out, s.names.TPU_ORIGINAL_IMAGE_ANNOTATION) == s.image("foreign")
    return out


def wh_image_swap_map_takes_priority(s):
    swap_world(s)
    nb = s.api.new_notebook("nb", "ns", image=s.image("mapped-from"),
                            annotations={s.names.TPU_ACCELERATOR_ANNOTATION:
                                         s.accelerator("v5e-1")})
    out = s.store.create(nb)
    assert container(s, out)["image"] == s.image("mapped-to")
    return out


def wh_no_swap_without_tpu_request(s):
    swap_world(s)
    out = s.store.create(s.api.new_notebook("nb", "ns",
                                            image="jupyter-cuda:1"))
    assert container(s, out)["image"] == "jupyter-cuda:1"
    return out


def wh_no_swap_for_tpu_capable_image(s):
    """An image that drives the side's accelerator is kept: JAX for the
    reference, CUDA for the port."""
    swap_world(s)
    nb = s.api.new_notebook("nb", "ns", image=s.image("native"),
                            annotations={s.names.TPU_ACCELERATOR_ANNOTATION:
                                         s.accelerator("v5e-4")})
    out = s.store.create(nb)
    assert container(s, out)["image"] == s.image("native")
    return out


def wh_auth_sidecar_injection_and_removal(s):
    swap_world(s)
    nb = s.api.new_notebook("nb", "ns", annotations={
        s.names.INJECT_AUTH_ANNOTATION: "true"})
    out = s.store.create(nb)
    spec = s.api.notebook_pod_spec(out)
    sidecar = s.k8s.find_container(spec, s.wh.mutating.AUTH_PROXY_CONTAINER)
    assert sidecar is not None
    assert sidecar["resources"]["limits"] == {"cpu": "100m",
                                              "memory": "64Mi"}
    assert sidecar["livenessProbe"]["initialDelaySeconds"] == 30
    assert sidecar["readinessProbe"]["initialDelaySeconds"] == 5
    assert any(v["name"] == "rbac-config" for v in spec["volumes"])
    cur = s.store.get(s.api.KIND, "ns", "nb")
    cur["metadata"]["annotations"][s.names.INJECT_AUTH_ANNOTATION] = "false"
    removed = s.store.update(cur)
    assert s.k8s.find_container(s.api.notebook_pod_spec(removed),
                                s.wh.mutating.AUTH_PROXY_CONTAINER) is None
    return [out, removed]


def wh_sidecar_resources_from_annotations(s):
    swap_world(s)
    out = s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.INJECT_AUTH_ANNOTATION: "true",
        s.names.AUTH_SIDECAR_CPU_ANNOTATION: "250m",
        s.names.AUTH_SIDECAR_MEMORY_ANNOTATION: "128Mi"}))
    sidecar = s.k8s.find_container(s.api.notebook_pod_spec(out),
                                   s.wh.mutating.AUTH_PROXY_CONTAINER)
    assert sidecar["resources"]["requests"] == {"cpu": "250m",
                                                "memory": "128Mi"}
    return out


def wh_ca_bundle_mounted_when_configmap_exists(s):
    swap_world(s)
    trust_bundle(s)
    out = s.store.create(s.api.new_notebook("nb", "ns"))
    c = container(s, out)
    assert env_of(s, out)["SSL_CERT_FILE"].endswith("ca-bundle.crt")
    assert any(m["name"] == "trusted-ca" for m in c["volumeMounts"])
    return out


def wh_restart_gating_parks_webhook_changes_on_running(s):
    swap_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    unlock(s)
    trust_bundle(s)
    cur = s.store.get(s.api.KIND, "ns", "nb")
    s.k8s.labels(cur)["user-label"] = "x"
    out = s.store.update(cur)
    assert s.k8s.get_label(out, "user-label") == "x"
    assert not any(m.get("name") == "trusted-ca"
                   for m in container(s, out).get("volumeMounts", []) or [])
    pending = s.k8s.get_annotation(out, s.names.UPDATE_PENDING_ANNOTATION)
    assert pending and "spec" in pending
    return json.loads(pending)


def wh_restart_gating_applies_when_stopped(s):
    swap_world(s)
    s.store.create(s.api.new_notebook("nb", "ns"))
    trust_bundle(s)
    cur = s.store.get(s.api.KIND, "ns", "nb")
    s.k8s.labels(cur)["poke"] = "1"
    out = s.store.update(cur)
    assert any(m["name"] == "trusted-ca"
               for m in container(s, out).get("volumeMounts", []))
    assert s.k8s.get_annotation(out,
                                s.names.UPDATE_PENDING_ANNOTATION) is None
    return out


def wh_validating_denies_malformed_tpu_request(s):
    """Each side's own message: the port's ``GpuRequestError`` for
    h100-7, the reference's ``TpuRequestError`` for v5e-7."""
    swap_world(s)
    name, code, message = denied(s, lambda: s.store.create(
        s.api.new_notebook("nb", "ns", annotations={
            s.names.TPU_ACCELERATOR_ANNOTATION:
                {"ref": "v5e-7", "port": "h100-7"}[s.side]})))
    assert message == {
        "ref": "invalid TPU request: v5e-7: unsupported chip count; "
               "supported: [1, 4, 8, 16, 32, 64, 128, 256]",
        "port": "invalid GPU request: h100-7: unsupported card count; one "
                "node holds [1, 2, 4, 8] cards, more nodes multiples of "
                "8"}[s.side]
    return name, code


def wh_validating_denies_slice_resize_while_running(s):
    swap_world(s)
    acc = s.names.TPU_ACCELERATOR_ANNOTATION
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        acc: s.accelerator("v5e-4")}))
    unlock(s)
    name, code, message = denied(s, lambda: annotate(
        s, {acc: s.accelerator("v5e-16")}))
    assert message == {
        "ref": "cannot change TPU slice of a running notebook (v5e-4 → "
               "v5e-16); stop it first",
        "port": "cannot change GPU slice of a running notebook (h100-4 → "
                "h100-32); stop it first"}[s.side]
    annotate(s, {s.names.STOP_ANNOTATION: "t"})
    out = annotate(s, {acc: s.accelerator("v5e-16")})
    assert s.k8s.get_annotation(out, acc) == s.accelerator("v5e-16")
    return (name, code), out


def wh_validating_denies_mlflow_annotation_removal_running(s):
    install(s, mlflow_enabled=True, gateway_url="gw.example")
    ann = s.names.MLFLOW_INSTANCE_ANNOTATION
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        ann: "tracking-1"}))
    env = env_of(s, s.store.get(s.api.KIND, "ns", "nb"))
    assert env["MLFLOW_TRACKING_URI"] == \
        "https://gw.example/mlflow-tracking-1"
    unlock(s)
    deny = denied(s, lambda: annotate(s, {ann: None}))
    annotate(s, {s.names.STOP_ANNOTATION: "t"})
    out = annotate(s, {ann: None})
    assert s.k8s.get_annotation(out, ann) is None
    return deny, out


def wh_feast_mount_label_gated(s):
    swap_world(s)
    out = s.store.create(s.api.new_notebook(
        "nb", "ns", labels={s.names.FEAST_LABEL: "true"}))
    assert any(m["name"] == FEAST_VOL
               for m in container(s, out)["volumeMounts"])
    cur = s.store.get(s.api.KIND, "ns", "nb")
    cur["metadata"]["labels"][s.names.FEAST_LABEL] = "false"
    off = s.store.update(cur)
    assert not any(m.get("name") == FEAST_VOL
                   for m in container(s, off).get("volumeMounts", []) or [])
    return [out, off]


def _proxy(s, status):
    s.store.create({"apiVersion": "config.openshift.io/v1", "kind": "Proxy",
                    "metadata": {"name": "cluster", "namespace": ""},
                    "status": status})


def wh_cluster_proxy_env_injected_when_enabled(s):
    _proxy(s, {"httpProxy": "http://proxy:3128",
               "httpsProxy": "https://proxy:3128",
               "noProxy": ".cluster.local,.svc"})
    out = hook(s, inject_cluster_proxy_env=True).handle(
        "CREATE", s.api.new_notebook("p", "ns"), None)
    env = env_of(s, out)
    assert env["HTTP_PROXY"] == "http://proxy:3128"
    assert env["HTTPS_PROXY"] == "https://proxy:3128"
    assert env["NO_PROXY"] == ".cluster.local,.svc"
    return out


def wh_cluster_proxy_env_requires_all_fields_and_never_strips(s):
    _proxy(s, {"httpProxy": "http://proxy:3128"})
    nb = s.api.new_notebook("p", "ns")
    container(s, nb)["env"] = [{"name": "NO_PROXY", "value": ".mine"}]
    out = hook(s, inject_cluster_proxy_env=True).handle("CREATE", nb, None)
    assert env_of(s, out) == {"NO_PROXY": ".mine"}
    return out


def wh_cluster_proxy_env_untouched_when_disabled(s):
    nb = s.api.new_notebook("p", "ns")
    container(s, nb)["env"] = [{"name": "HTTP_PROXY",
                                "value": "http://mine:8080"}]
    out = hook(s).handle("CREATE", nb, None)
    assert env_of(s, out)["HTTP_PROXY"] == "http://mine:8080"
    return out


# ------------------------------------- tests/test_restart_gating.py
def gating_world(s):
    install(s, validating=False, mlflow_enabled=True,
            gateway_url="gw.example.com")


def running_nb(s):
    s.store.create(s.api.new_notebook("nb", NS, image="jupyter/base:latest"))
    return unlock(s, NS)


def pending_of(s, nb):
    raw = s.k8s.get_annotation(nb, s.names.UPDATE_PENDING_ANNOTATION)
    return json.loads(raw) if raw else None


def rg_user_change_passes_through(s):
    gating_world(s)
    running_nb(s)
    out = s.store.patch(s.api.KIND, NS, "nb", {"spec": {"template": {
        "spec": {"containers": [{"name": "nb",
                                 "image": "jupyter/base:2024b"}]}}}})
    assert container(s, out)["image"] == "jupyter/base:2024b"
    assert pending_of(s, out) is None
    return out


def rg_webhook_mutation_parked_with_diff(s):
    gating_world(s)
    running_nb(s)
    out = annotate(s, {s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}, NS)
    assert "MLFLOW_TRACKING_URI" not in env_of(s, out)
    diffs = pending_of(s, out)
    assert diffs and any("env" in d for d in diffs)
    return out


def rg_mixed_change_applies_user_part_parks_webhook_part(s):
    gating_world(s)
    running_nb(s)
    out = s.store.patch(s.api.KIND, NS, "nb", {
        "metadata": {"annotations": {
            s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}},
        "spec": {"template": {"spec": {"containers": [
            {"name": "nb", "image": "jupyter/base:2024c"}]}}}})
    assert container(s, out)["image"] == "jupyter/base:2024c"
    assert "MLFLOW_TRACKING_URI" not in env_of(s, out)
    assert pending_of(s, out)
    return out


def rg_auth_sidecar_injection_parked_on_running(s):
    gating_world(s)
    running_nb(s)
    out = annotate(s, {s.names.INJECT_AUTH_ANNOTATION: "true"}, NS)
    assert "kube-rbac-proxy" not in {
        c["name"] for c in s.api.notebook_pod_spec(out)["containers"]}
    assert pending_of(s, out)
    return out


def rg_stopped_takes_webhook_mutations_and_clears_pending(s):
    gating_world(s)
    running_nb(s)
    parked = annotate(s, {s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}, NS)
    assert pending_of(s, parked)
    out = annotate(s, {s.names.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}, NS)
    assert "MLFLOW_TRACKING_URI" in env_of(s, out)
    assert pending_of(s, out) is None
    return [parked, out]


def rg_no_spurious_pending_on_noop_update(s):
    gating_world(s)
    running_nb(s)
    out = s.store.patch(s.api.KIND, NS, "nb",
                        {"metadata": {"labels": {"touch": "1"}}})
    assert pending_of(s, out) is None
    return out


# ----------------------------------- tests/test_image_resolution.py
def imagestream(name, ns=CENTRAL, tags=None):
    return {"kind": "ImageStream", "apiVersion": "image.openshift.io/v1",
            "metadata": {"name": name, "namespace": ns},
            "status": {"tags": tags if tags is not None else [{
                "tag": "2024.2",
                "items": [
                    {"created": "2024-01-01T00:00:00Z",
                     "dockerImageReference": DIGEST_OLD},
                    {"created": "2024-06-01T00:00:00Z",
                     "dockerImageReference": DIGEST_NEW},
                ],
            }]}}


def ir_world(s):
    install(s, validating=False, controller_namespace=CENTRAL)


def nb_with_selection(s, selection="jupyter-ds:2024.2",
                      image="placeholder:latest", extra_annotations=None,
                      env=None):
    annotations = {s.names.IMAGE_SELECTION_ANNOTATION: selection}
    annotations.update(extra_annotations or {})
    containers = [{"name": "nb", "image": image}]
    if env:
        containers[0]["env"] = env
    return s.api.new_notebook("nb", "ns", annotations=annotations,
                              containers=containers)


def ir_selection_resolves_to_newest_digest(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds"))
    out = s.store.create(nb_with_selection(s))
    assert container(s, out)["image"] == DIGEST_NEW
    return out


def ir_resolution_is_digest_stable_across_readmissions(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds"))
    out = s.store.create(nb_with_selection(s))
    out["metadata"]["labels"] = {"touch": "1"}
    out2 = s.store.update(out)
    assert container(s, out2)["image"] == DIGEST_NEW
    return out2


def ir_internal_registry_image_left_alone(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds"))
    internal = "image-registry.openshift-image-registry.svc:5000/ns/img:tag"
    out = s.store.create(nb_with_selection(s, image=internal))
    assert container(s, out)["image"] == internal
    return out


def ir_namespace_annotation_overrides_lookup_ns(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds", ns="custom-ns"))
    out = s.store.create(nb_with_selection(s, extra_annotations={
        s.names.WORKBENCH_IMAGE_NAMESPACE_ANNOTATION: "custom-ns"}))
    assert container(s, out)["image"] == DIGEST_NEW
    return out


def ir_empty_namespace_annotation_falls_back_to_controller_ns(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds"))
    out = s.store.create(nb_with_selection(s, extra_annotations={
        s.names.WORKBENCH_IMAGE_NAMESPACE_ANNOTATION: "  "}))
    assert container(s, out)["image"] == DIGEST_NEW
    return out


def ir_jupyter_image_env_updated_to_selection(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds"))
    out = s.store.create(nb_with_selection(
        s, env=[{"name": "JUPYTER_IMAGE", "value": "old"}]))
    assert env_of(s, out)["JUPYTER_IMAGE"] == "jupyter-ds:2024.2"
    return out


def ir_missing_imagestream_leaves_image(s):
    ir_world(s)
    out = s.store.create(nb_with_selection(s))
    assert container(s, out)["image"] == "placeholder:latest"
    return out


def ir_missing_tag_leaves_image(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds"))
    out = s.store.create(nb_with_selection(s, selection="jupyter-ds:other"))
    assert container(s, out)["image"] == "placeholder:latest"
    return out


def ir_imagestream_without_tags_denied(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds", tags=[]))
    return denied(s, lambda: s.store.create(nb_with_selection(s)),
                  s.errors.InvalidError, "no status or tags")


def ir_malformed_selection_denied(s):
    ir_world(s)
    return denied(s, lambda: s.store.create(nb_with_selection(
        s, selection="registry.io/a:b:c")), s.errors.InvalidError,
        "invalid image selection")


def ir_selection_without_any_container_denied(s):
    ir_world(s)
    nb = {"kind": "Notebook", "apiVersion": "kubeflow.org/v1",
          "metadata": {"name": "nb", "namespace": "ns", "annotations": {
              s.names.IMAGE_SELECTION_ANNOTATION: "jupyter-ds:2024.2"}},
          "spec": {"template": {"spec": {"containers": []}}}}
    return denied(s, lambda: s.store.create(nb), s.errors.InvalidError)


def ir_resolution_then_tpu_swap_composes(s):
    """Turned round: a selected stream of an image the side cannot drive
    (CUDA for the reference, JAX for the port) resolves to its digest,
    then the swap replaces it and records the digest."""
    ir_world(s)
    s.store.create(imagestream("foreign-stream", tags=[{
        "tag": "1.0", "items": [{"created": "2024-01-01T00:00:00Z",
                                 "dockerImageReference":
                                     s.image("foreign-digest")}]}]))
    out = s.store.create(nb_with_selection(
        s, selection="foreign-stream:1.0",
        extra_annotations={s.names.TPU_ACCELERATOR_ANNOTATION:
                           s.accelerator("v5e-4")}))
    assert container(s, out)["image"] == s.config.tpu_default_image
    assert s.k8s.get_annotation(
        out, s.names.TPU_ORIGINAL_IMAGE_ANNOTATION) == \
        s.image("foreign-digest")
    return out


def ir_resolution_parked_on_running_notebook(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds"))
    s.store.create(s.api.new_notebook(
        "nb", "ns", containers=[{"name": "nb", "image": "placeholder:1"}]))
    running = s.store.get(s.api.KIND, "ns", "nb")
    s.k8s.remove_annotation(running, s.names.STOP_ANNOTATION)
    running = s.store.update(running)
    s.k8s.set_annotation(running, s.names.IMAGE_SELECTION_ANNOTATION,
                         "jupyter-ds:2024.2")
    out = s.store.update(running)
    assert container(s, out)["image"] == "placeholder:1"
    assert s.k8s.get_annotation(out, s.names.UPDATE_PENDING_ANNOTATION)
    return out


def ir_legacy_malformed_selection_does_not_brick_updates(s):
    ir_world(s)
    created = s.store.create(s.api.new_notebook("nb", "ns"))
    s.k8s.set_annotation(created, s.names.IMAGE_SELECTION_ANNOTATION,
                         "registry.local:5000/cuda:2024")
    updated = s.store.update(created)
    annotate(s, {s.names.STOP_ANNOTATION: "2026-01-01T00:00:00Z"})
    assert s.k8s.get_annotation(s.store.get(s.api.KIND, "ns", "nb"),
                                s.names.STOP_ANNOTATION)
    assert container(s, updated)["image"] == "jupyter-minimal:latest"
    return updated


def ir_selection_targets_first_container_when_name_differs(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds"))
    out = s.store.create(s.api.new_notebook(
        "nb", "ns",
        annotations={s.names.IMAGE_SELECTION_ANNOTATION: "jupyter-ds:2024.2"},
        containers=[{"name": "main", "image": "placeholder:latest"}]))
    assert out["spec"]["template"]["spec"]["containers"][0]["image"] == \
        DIGEST_NEW
    return out


def ir_tag_with_empty_items_leaves_image(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds",
                               tags=[{"tag": "2024.2", "items": []}]))
    out = s.store.create(nb_with_selection(s))
    assert container(s, out)["image"] == "placeholder:latest"
    return out


def ir_item_without_docker_reference_skipped(s):
    ir_world(s)
    s.store.create(imagestream("jupyter-ds", tags=[{
        "tag": "2024.2", "items": [{"created": "2024-06-01T00:00:00Z"}]}]))
    out = s.store.create(nb_with_selection(s))
    assert container(s, out)["image"] == "placeholder:latest"
    return out


# -------------------------------------- tests/test_feast_config.py
def feast_nb(name="nb", labels=None, containers=None, volumes=None,
             annotations=None):
    spec = {"containers": containers if containers is not None else
            [{"name": name, "image": "img"}]}
    if volumes is not None:
        spec["volumes"] = volumes
    nb = {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
          "metadata": {"name": name, "namespace": NS},
          "spec": {"template": {"spec": spec}}}
    if labels is not None:
        nb["metadata"]["labels"] = labels
    if annotations is not None:
        nb["metadata"]["annotations"] = annotations
    return nb


def admit(s, nb, operation="CREATE", old=None):
    return hook(s).handle(operation, nb, old)


def feast_volume(s, nb):
    return [v for v in s.api.notebook_pod_spec(nb).get("volumes", [])
            if v["name"] == FEAST_VOL]


def feast_mounts(c):
    return [m for m in c.get("volumeMounts", []) if m["name"] == FEAST_VOL]


def fe_label_absent(s):
    out = admit(s, feast_nb())
    assert not feast_volume(s, out)
    return out


def fe_nil_labels(s):
    out = admit(s, feast_nb(labels=None))
    assert not feast_volume(s, out)
    return out


def fe_label_true(s):
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "true"}))
    assert feast_volume(s, out)
    return out


def fe_label_false(s):
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "false"}))
    assert not feast_volume(s, out)
    return out


def _fe_label_invalid(value):
    def case(s):
        out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: value}))
        assert not feast_volume(s, out)
        return out
    case.__name__ = f"fe_label_invalid_values[{value}]"
    return case


def fm_adds_volume_and_mount(s):
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "true"}))
    assert feast_volume(s, out)[0]["configMap"] == {"name": "nb-feast-config"}
    mount = feast_mounts(container(s, out))[0]
    assert mount["mountPath"] == FEAST_PATH and mount["readOnly"] is True
    return out


def fm_updates_existing_stale_volume(s):
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "true"},
                            volumes=[{"name": FEAST_VOL, "configMap": {
                                "name": "stale-config"}}]))
    vols = feast_volume(s, out)
    assert len(vols) == 1
    assert vols[0]["configMap"]["name"] == "nb-feast-config"
    return out


def fm_updates_existing_stale_mount(s):
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "true"},
                            containers=[{"name": "nb", "image": "img",
                                         "volumeMounts": [{
                                             "name": FEAST_VOL,
                                             "mountPath": FEAST_PATH,
                                             "readOnly": False}]}]))
    mounts = feast_mounts(container(s, out))
    assert len(mounts) == 1 and mounts[0]["readOnly"] is True
    return out


def fm_multiple_containers_only_notebook_container_mounted(s):
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "true"},
                            containers=[{"name": "sidecar", "image": "proxy"},
                                        {"name": "nb", "image": "img"}]))
    by_name = {c["name"]: c for c in s.api.notebook_pod_spec(out)[
        "containers"]}
    assert feast_mounts(by_name["nb"])
    assert not feast_mounts(by_name["sidecar"])
    return out


def fm_mount_idempotent_across_admissions(s):
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "true"}))
    out2 = admit(s, out, operation="UPDATE", old=out)
    assert len(feast_volume(s, out2)) == 1
    assert len(feast_mounts(container(s, out2))) == 1
    return out2


def fm_no_name_matching_container_falls_back_to_first(s):
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "true"},
                            containers=[{"name": "custom", "image": "img"}]))
    assert feast_mounts(s.api.notebook_pod_spec(out)["containers"][0])
    return out


def _stopped(s, **kw):
    return feast_nb(annotations={
        s.names.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}, **kw)


def fu_removes_volume_and_mount(s):
    mounted = admit(s, _stopped(s, labels={s.names.FEAST_LABEL: "true"}))
    assert feast_volume(s, mounted)
    mounted["metadata"]["labels"][s.names.FEAST_LABEL] = "false"
    out = admit(s, mounted, operation="UPDATE", old=mounted)
    assert not feast_volume(s, out)
    assert not feast_mounts(container(s, out))
    return out


def fu_label_removed_entirely_unmounts(s):
    mounted = admit(s, _stopped(s, labels={s.names.FEAST_LABEL: "true"}))
    del mounted["metadata"]["labels"][s.names.FEAST_LABEL]
    out = admit(s, mounted, operation="UPDATE", old=mounted)
    assert not feast_volume(s, out)
    return out


def fu_graceful_without_feast_config(s):
    out = admit(s, _stopped(s))
    assert not feast_volume(s, out)
    assert not feast_mounts(container(s, out))
    return out


def fu_premounted_volume_with_label_off_on_create(s):
    out = admit(s, feast_nb(volumes=[{"name": FEAST_VOL, "configMap": {
        "name": "nb-feast-config"}}], containers=[{
            "name": "nb", "image": "img", "volumeMounts": [{
                "name": FEAST_VOL, "mountPath": FEAST_PATH}]}]))
    assert not feast_volume(s, out)
    assert not feast_mounts(container(s, out))
    return out


def fu_other_volumes_untouched_by_unmount(s):
    out = admit(s, _stopped(
        s, volumes=[{"name": "data", "emptyDir": {}},
                    {"name": FEAST_VOL,
                     "configMap": {"name": "nb-feast-config"}}],
        containers=[{"name": "nb", "image": "img", "volumeMounts": [
            {"name": "data", "mountPath": "/data"},
            {"name": FEAST_VOL, "mountPath": FEAST_PATH}]}]))
    assert [v["name"] for v in s.api.notebook_pod_spec(out)["volumes"]] == \
        ["data"]
    assert [m["name"] for m in container(s, out)["volumeMounts"]] == ["data"]
    return out


def fi_mounts_when_configmap_exists(s):
    s.store.create({"kind": "ConfigMap", "apiVersion": "v1",
                    "metadata": {"name": "nb-feast-config", "namespace": NS},
                    "data": {"feature_store.yaml": "project: demo"}})
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "true"}))
    assert feast_volume(s, out)
    return out


def fi_mounts_even_when_configmap_missing(s):
    out = admit(s, feast_nb(labels={s.names.FEAST_LABEL: "true"}))
    assert "optional" not in feast_volume(s, out)[0]["configMap"]
    return out


# ------------------------------- tests/test_auth_sidecar_resources.py
def _pq_valid(raw, expected):
    def case(s):
        assert s.k8s.parse_quantity(raw) == pytest.approx(expected)
        return s.k8s.parse_quantity(raw)
    case.__name__ = f"pq_valid[{raw}]"
    return case


def _pq_invalid(raw):
    def case(s):
        with pytest.raises(ValueError) as exc:
            s.k8s.parse_quantity(raw)
        return str(exc.value)
    case.__name__ = f"pq_invalid[{raw}]"
    return case


def pq_negative_parses_as_negative(s):
    assert s.k8s.parse_quantity("-100m") == pytest.approx(-0.1)
    return s.k8s.parse_quantity("-100m")


def auth_nb(s, annotations=None):
    ann = {s.names.INJECT_AUTH_ANNOTATION: "true"}
    ann.update(annotations or {})
    return {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
            "metadata": {"name": "nb", "namespace": "ns",
                         "annotations": ann},
            "spec": {"template": {"spec": {"containers": [
                {"name": "nb", "image": "img"}]}}}}


def sidecar_resources(s, out):
    sidecar = s.k8s.find_container(s.api.notebook_pod_spec(out),
                                   s.wh.mutating.AUTH_PROXY_CONTAINER)
    assert sidecar is not None
    return sidecar["resources"]


def sidecar_of(s, annotations):
    """Resolve the annotation table's names (``cpu-request``, ...) to the
    side's keys and admit a notebook carrying them."""
    keys = {"cpu-request": s.names.AUTH_SIDECAR_CPU_REQUEST_ANNOTATION,
            "cpu-limit": s.names.AUTH_SIDECAR_CPU_LIMIT_ANNOTATION,
            "memory-request": s.names.AUTH_SIDECAR_MEMORY_REQUEST_ANNOTATION,
            "memory-limit": s.names.AUTH_SIDECAR_MEMORY_LIMIT_ANNOTATION,
            "cpu": s.names.AUTH_SIDECAR_CPU_ANNOTATION,
            "memory": s.names.AUTH_SIDECAR_MEMORY_ANNOTATION}
    return {keys[k]: v for k, v in annotations.items()}


def ra_no_annotations_all_defaults(s):
    res = sidecar_resources(s, admit(s, auth_nb(s)))
    assert res == {"requests": {"cpu": "100m", "memory": "64Mi"},
                   "limits": {"cpu": "100m", "memory": "64Mi"}}
    return res


def ra_all_custom_values(s):
    res = sidecar_resources(s, admit(s, auth_nb(s, sidecar_of(s, {
        "cpu-request": "250m", "cpu-limit": "500m",
        "memory-request": "128Mi", "memory-limit": "256Mi"}))))
    assert res == {"requests": {"cpu": "250m", "memory": "128Mi"},
                   "limits": {"cpu": "500m", "memory": "256Mi"}}
    return res


def ra_partial_annotations_keep_defaults(s):
    res = sidecar_resources(s, admit(s, auth_nb(s, sidecar_of(s, {
        "memory-limit": "256Mi"}))))
    assert res == {"requests": {"cpu": "100m", "memory": "64Mi"},
                   "limits": {"cpu": "100m", "memory": "256Mi"}}
    return res


def ra_whitespace_trimmed(s):
    res = sidecar_resources(s, admit(s, auth_nb(s, sidecar_of(s, {
        "cpu-request": "  50m  "}))))
    assert res["requests"]["cpu"] == "50m"
    return res


def ra_equal_requests_and_limits_allowed(s):
    res = sidecar_resources(s, admit(s, auth_nb(s, sidecar_of(s, {
        "cpu-request": "200m", "cpu-limit": "200m"}))))
    assert res["limits"]["cpu"] == "200m"
    return res


def ra_legacy_combined_annotation_sets_both(s):
    res = sidecar_resources(s, admit(s, auth_nb(s, sidecar_of(s, {
        "cpu": "300m"}))))
    assert res["requests"]["cpu"] == res["limits"]["cpu"] == "300m"
    return res


def ra_explicit_wins_over_legacy(s):
    res = sidecar_resources(s, admit(s, auth_nb(s, sidecar_of(s, {
        "cpu": "300m", "cpu-limit": "600m"}))))
    assert res["requests"]["cpu"] == "300m"
    assert res["limits"]["cpu"] == "600m"
    return res


def _ra_invalid(key, value, fragment):
    def case(s):
        return denied(s, lambda: admit(s, auth_nb(s, sidecar_of(
            s, {key: value}))), match=fragment)
    case.__name__ = f"ra_invalid_values_denied[{key}-{value}]"
    return case


def _ra_request_over_limit(annotations, fragment):
    def case(s):
        return denied(s, lambda: admit(s, auth_nb(s, sidecar_of(
            s, annotations))), match=fragment)
    label = "-".join(f"{k}={v}" for k, v in annotations.items())
    case.__name__ = f"ra_request_greater_than_limit_denied[{label}]"
    return case


def ra_empty_annotation_treated_as_absent(s):
    res = sidecar_resources(s, admit(s, auth_nb(s, sidecar_of(s, {
        "cpu-request": ""}))))
    assert res["requests"]["cpu"] == "100m"
    deny = denied(s, lambda: admit(s, auth_nb(s, sidecar_of(s, {
        "cpu-request": "   "}))))
    return res, deny


def ra_units_compared_semantically_not_textually(s):
    res = sidecar_resources(s, admit(s, auth_nb(s, sidecar_of(s, {
        "cpu-request": "0.2", "cpu-limit": "500m",
        "memory-request": "100Mi", "memory-limit": "1Gi"}))))
    assert res["requests"]["cpu"] == "0.2"
    return res


def fe_invalid_resources_deny_create_through_admission(s):
    install(s)
    deny = denied(s, lambda: s.store.create(s.api.new_notebook(
        "nb", "ns", annotations={
            s.names.INJECT_AUTH_ANNOTATION: "true",
            s.names.AUTH_SIDECAR_CPU_REQUEST_ANNOTATION: "totally-invalid"})))
    assert s.store.get_or_none(s.api.KIND, "ns", "nb") is None
    return deny


def fe_invalid_resources_deny_update_preserving_original(s):
    install(s)
    req = s.names.AUTH_SIDECAR_CPU_REQUEST_ANNOTATION
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.INJECT_AUTH_ANNOTATION: "true"}))
    deny = denied(s, lambda: annotate(s, {req: "900m"}))
    current = s.store.get(s.api.KIND, "ns", "nb")
    assert s.k8s.get_annotation(current, req) is None
    assert sidecar_resources(s, current)["requests"]["cpu"] == "100m"
    return deny, current


def fe_valid_custom_resources_through_admission(s):
    install(s, validating=False)
    s.store.create(s.api.new_notebook("nb", "ns", annotations={
        s.names.INJECT_AUTH_ANNOTATION: "true",
        **sidecar_of(s, {"cpu-request": "250m", "cpu-limit": "1",
                         "memory-request": "128Mi",
                         "memory-limit": "512Mi"})}))
    res = sidecar_resources(s, s.store.get(s.api.KIND, "ns", "nb"))
    assert res == {"requests": {"cpu": "250m", "memory": "128Mi"},
                   "limits": {"cpu": "1", "memory": "512Mi"}}
    return res


# ------------------------- tests/test_mlflow.py TestEnvInjection
def ml_config(s, **kw):
    kw.setdefault("mlflow_enabled", True)
    return s.Config(gateway_name=GW_NAME, gateway_namespace=GW_NS, **kw)


def ml_nb(s, name="nb", annotations=None):
    nb = {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
          "metadata": {"name": name, "namespace": NS},
          "spec": {"template": {"spec": {
              "containers": [{"name": name, "image": "img"}]}}}}
    if annotations:
        nb["metadata"]["annotations"] = annotations
    return nb


def gateway(s, hostname="gw.apps.example.com"):
    s.store.create({"kind": "Gateway",
                    "apiVersion": "gateway.networking.k8s.io/v1",
                    "metadata": {"name": GW_NAME, "namespace": GW_NS},
                    "spec": {"listeners": [{"hostname": hostname}]}})


def ml_admit(s, nb, cfg=None, client=None):
    return s.wh.Mutating(client if client is not None else s.store,
                         cfg or ml_config(s)).handle("CREATE", nb, None)


def mlflow_env(s, out) -> dict:
    return {k: v for k, v in env_of(s, out).items() if k in ENV_VARS}


def me_no_annotation_no_env(s):
    out = ml_admit(s, ml_nb(s))
    assert not mlflow_env(s, out)
    return out


def me_empty_annotation_value_no_env(s):
    out = ml_admit(s, ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: ""}))
    assert not mlflow_env(s, out)
    return out


def me_whitespace_annotation_value_no_env(s):
    out = ml_admit(s, ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: "   "}))
    assert not mlflow_env(s, out)
    return out


def me_integration_and_auth_vars_injected(s):
    out = ml_admit(s, ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}))
    env = env_of(s, out)
    assert env["MLFLOW_K8S_INTEGRATION"] == "true"
    assert env["MLFLOW_TRACKING_AUTH"] == "kubernetes-namespaced"
    return out


def me_no_tracking_uri_without_hostname(s):
    out = ml_admit(s, ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}))
    env = env_of(s, out)
    assert "MLFLOW_TRACKING_URI" not in env
    assert env["MLFLOW_K8S_INTEGRATION"] == "true"
    return out


def me_tracking_uri_via_gateway_lookup(s):
    gateway(s)
    out = ml_admit(s, ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}))
    assert env_of(s, out)["MLFLOW_TRACKING_URI"] == \
        "https://gw.apps.example.com/mlflow"
    return out


def me_tracking_uri_prefers_configured_gateway_url(s):
    gateway(s, hostname="from-gateway.example.com")
    out = ml_admit(s, ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}),
        cfg=ml_config(s, gateway_url="configured.example.com"))
    assert env_of(s, out)["MLFLOW_TRACKING_URI"] == \
        "https://configured.example.com/mlflow"
    return out


def me_non_default_instance_uri(s):
    gateway(s)
    out = ml_admit(s, ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: "tracking-1"}))
    assert env_of(s, out)["MLFLOW_TRACKING_URI"] == \
        "https://gw.apps.example.com/mlflow-tracking-1"
    return out


def me_annotation_removed_cleans_env(s):
    gateway(s)
    webhook = s.wh.Mutating(s.store, ml_config(s))
    mounted = webhook.handle("CREATE", ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow",
        s.names.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}), None)
    assert mlflow_env(s, mounted)
    del mounted["metadata"]["annotations"][
        s.names.MLFLOW_INSTANCE_ANNOTATION]
    out = webhook.handle("UPDATE", mounted, mounted)
    assert not mlflow_env(s, out)
    return out


def me_mlflow_disabled_config_no_env(s):
    gateway(s)
    out = ml_admit(s, ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}),
        cfg=ml_config(s, mlflow_enabled=False))
    assert not mlflow_env(s, out)
    return out


class _RouteForbidden:
    """The side's store with a Route LIST that is forbidden."""

    def __init__(self, s):
        self._s = s

    def __getattr__(self, attr):
        return getattr(self._s.store, attr)

    def list(self, kind, *a, **kw):
        if kind == "Route":
            raise self._s.errors.ForbiddenError("routes is forbidden")
        return self._s.store.list(kind, *a, **kw)


def me_failed_route_lookup_never_denies_admission(s):
    s.store.create({"kind": "Gateway",
                    "apiVersion": "gateway.networking.k8s.io/v1",
                    "metadata": {"name": GW_NAME, "namespace": GW_NS,
                                 "ownerReferences": [
                                     {"kind": "GatewayConfig",
                                      "name": "gc", "uid": "u"}]},
                    "spec": {"listeners": [{}]}})
    out = ml_admit(s, ml_nb(s, annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"}),
        client=_RouteForbidden(s))
    env = env_of(s, out)
    assert env["MLFLOW_K8S_INTEGRATION"] == "true"
    assert "MLFLOW_TRACKING_URI" not in env
    return out


def me_user_env_preserved_alongside_injection(s):
    gateway(s)
    nb = ml_nb(s, annotations={s.names.MLFLOW_INSTANCE_ANNOTATION: "mlflow"})
    nb["spec"]["template"]["spec"]["containers"][0]["env"] = [
        {"name": "USER_VAR", "value": "keep"}]
    out = ml_admit(s, nb)
    env = env_of(s, out)
    assert env["USER_VAR"] == "keep"
    assert env["MLFLOW_K8S_INTEGRATION"] == "true"
    return out


# ------------------------- tests/test_runtime_images.py TestMount
def ri_admit(s, nb=None):
    nb = nb or {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
                "metadata": {"name": "nb", "namespace": NS},
                "spec": {"template": {"spec": {"containers": [
                    {"name": "nb", "image": "img"}]}}}}
    return hook(s).handle("CREATE", nb, None)


def ri_volumes(s, nb):
    return [v for v in s.api.notebook_pod_spec(nb).get("volumes", [])
            if v["name"] == RI_VOL]


def ri_mounts(s, nb):
    return [m for m in container(s, nb).get("volumeMounts", [])
            if m["name"] == RI_VOL]


def ri_configmap(s, data):
    s.store.create({"kind": "ConfigMap", "apiVersion": "v1",
                    "metadata": {"name": s.ext.runtime_images.CONFIGMAP_NAME,
                                 "namespace": NS},
                    "data": data})


def rm_mounts_when_data_present(s):
    ri_configmap(s, {"ds.json": "{}"})
    out = ri_admit(s)
    assert ri_volumes(s, out)[0]["configMap"] == {
        "name": s.ext.runtime_images.CONFIGMAP_NAME, "optional": True}
    assert ri_mounts(s, out)[0]["mountPath"] == \
        "/opt/app-root/pipeline-runtimes"
    return out


def rm_skips_empty_configmap(s):
    ri_configmap(s, {})
    out = ri_admit(s)
    assert not ri_volumes(s, out) and not ri_mounts(s, out)
    return out


def rm_skips_missing_configmap(s):
    out = ri_admit(s)
    assert not ri_volumes(s, out) and not ri_mounts(s, out)
    return out


def rm_mount_idempotent(s):
    ri_configmap(s, {"ds.json": "{}"})
    out = ri_admit(s)
    out2 = ri_admit(s, out)
    assert len(ri_volumes(s, out2)) == 1 and len(ri_mounts(s, out2)) == 1
    return out2


# ------------------------------------------------------ the registry
def _cases(prefix: str, fns) -> dict:
    return {f"{prefix}.{fn.__name__.split('_', 1)[1]}": fn for fn in fns}


CASES = {}
CASES.update(_cases("test_webhook", (
    wh_reconciliation_lock_injected_on_create, wh_lock_not_injected_on_update,
    wh_image_swap_for_tpu_notebook, wh_image_swap_map_takes_priority,
    wh_no_swap_without_tpu_request, wh_no_swap_for_tpu_capable_image,
    wh_auth_sidecar_injection_and_removal,
    wh_sidecar_resources_from_annotations,
    wh_ca_bundle_mounted_when_configmap_exists,
    wh_restart_gating_parks_webhook_changes_on_running,
    wh_restart_gating_applies_when_stopped,
    wh_validating_denies_malformed_tpu_request,
    wh_validating_denies_slice_resize_while_running,
    wh_validating_denies_mlflow_annotation_removal_running,
    wh_feast_mount_label_gated, wh_cluster_proxy_env_injected_when_enabled,
    wh_cluster_proxy_env_requires_all_fields_and_never_strips,
    wh_cluster_proxy_env_untouched_when_disabled)))
CASES.update(_cases("test_restart_gating", (
    rg_user_change_passes_through, rg_webhook_mutation_parked_with_diff,
    rg_mixed_change_applies_user_part_parks_webhook_part,
    rg_auth_sidecar_injection_parked_on_running,
    rg_stopped_takes_webhook_mutations_and_clears_pending,
    rg_no_spurious_pending_on_noop_update)))
CASES.update(_cases("test_image_resolution", (
    ir_selection_resolves_to_newest_digest,
    ir_resolution_is_digest_stable_across_readmissions,
    ir_internal_registry_image_left_alone,
    ir_namespace_annotation_overrides_lookup_ns,
    ir_empty_namespace_annotation_falls_back_to_controller_ns,
    ir_jupyter_image_env_updated_to_selection,
    ir_missing_imagestream_leaves_image, ir_missing_tag_leaves_image,
    ir_imagestream_without_tags_denied, ir_malformed_selection_denied,
    ir_selection_without_any_container_denied,
    ir_resolution_then_tpu_swap_composes,
    ir_resolution_parked_on_running_notebook,
    ir_legacy_malformed_selection_does_not_brick_updates,
    ir_selection_targets_first_container_when_name_differs,
    ir_tag_with_empty_items_leaves_image,
    ir_item_without_docker_reference_skipped)))
CASES.update(_cases("test_feast_config.TestFeastEnabled", (
    fe_label_absent, fe_nil_labels, fe_label_true, fe_label_false,
    *(_fe_label_invalid(v)
      for v in ("True", "TRUE", "yes", "1", "enabled", "")))))
CASES.update(_cases("test_feast_config.TestMount", (
    fm_adds_volume_and_mount, fm_updates_existing_stale_volume,
    fm_updates_existing_stale_mount,
    fm_multiple_containers_only_notebook_container_mounted,
    fm_mount_idempotent_across_admissions,
    fm_no_name_matching_container_falls_back_to_first)))
CASES.update(_cases("test_feast_config.TestUnmount", (
    fu_removes_volume_and_mount, fu_label_removed_entirely_unmounts,
    fu_graceful_without_feast_config,
    fu_premounted_volume_with_label_off_on_create,
    fu_other_volumes_untouched_by_unmount)))
CASES.update(_cases("test_feast_config.TestIntegration", (
    fi_mounts_when_configmap_exists, fi_mounts_even_when_configmap_missing)))
CASES.update(_cases("test_auth_sidecar_resources.TestParseQuantity", (
    *(_pq_valid(raw, want) for raw, want in (
        ("100m", 0.1), ("1", 1.0), ("2.5", 2.5), ("64Mi", 64 * 2**20),
        ("1Gi", 2**30), ("128k", 128e3), ("1e3", 1000.0),
        (" 250m ", 0.25), ("2E", 2e18), ("1E3", 1000.0), ("100n", 1e-7),
        ("500u", 5e-4))),
    *(_pq_invalid(raw) for raw in ("abc", "100x", "Mi", "", "1.2.3",
                                   "100 m", "1e3Ki")),
    pq_negative_parses_as_negative)))
CASES.update(_cases("test_auth_sidecar_resources.TestResourceAnnotations", (
    ra_no_annotations_all_defaults, ra_all_custom_values,
    ra_partial_annotations_keep_defaults, ra_whitespace_trimmed,
    ra_equal_requests_and_limits_allowed,
    ra_legacy_combined_annotation_sets_both, ra_explicit_wins_over_legacy,
    *(_ra_invalid(k, v, f) for k, v, f in (
        ("cpu-request", "invalid", "invalid value"),
        ("memory-request", "64Zi", "invalid value"),
        ("cpu-limit", "10cores", "invalid value"),
        ("memory-limit", "##", "invalid value"),
        ("cpu-request", "-100m", "negative"),
        ("memory-request", "-64Mi", "negative"),
        ("cpu-limit", "-1", "negative"),
        ("memory-limit", "-1Gi", "negative"))),
    *(_ra_request_over_limit(a, f) for a, f in (
        ({"cpu-request": "500m", "cpu-limit": "250m"}, "cpu request"),
        ({"memory-request": "256Mi", "memory-limit": "128Mi"},
         "memory request"),
        ({"cpu-request": "2"}, "cpu request"),
        ({"memory-request": "1Gi"}, "memory request"))),
    ra_empty_annotation_treated_as_absent,
    ra_units_compared_semantically_not_textually)))
CASES.update(_cases("test_auth_sidecar_resources.TestFailEarly", (
    fe_invalid_resources_deny_create_through_admission,
    fe_invalid_resources_deny_update_preserving_original,
    fe_valid_custom_resources_through_admission)))
CASES.update(_cases("test_mlflow.TestEnvInjection", (
    me_no_annotation_no_env, me_empty_annotation_value_no_env,
    me_whitespace_annotation_value_no_env,
    me_integration_and_auth_vars_injected,
    me_no_tracking_uri_without_hostname, me_tracking_uri_via_gateway_lookup,
    me_tracking_uri_prefers_configured_gateway_url,
    me_non_default_instance_uri, me_annotation_removed_cleans_env,
    me_mlflow_disabled_config_no_env,
    me_failed_route_lookup_never_denies_admission,
    me_user_env_preserved_alongside_injection)))
CASES.update(_cases("test_runtime_images.TestMount", (
    rm_mounts_when_data_present, rm_skips_empty_configmap,
    rm_skips_missing_configmap, rm_mount_idempotent)))


def _snapshot(s) -> dict:
    return {(o["kind"], s.k8s.namespace(o), s.k8s.name(o)):
            normalise(o, s.side) for o in s.store.all_objects()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_webhook_case_through_both_packages(case):
    got, stores, writes = {}, {}, {}
    for s in (Stack("ref"), Stack("port")):
        got[s.side] = normalise_result(CASES[case](s), s.side)
        stores[s.side] = _snapshot(s)
        writes[s.side] = s.store._last_rv
    assert got["port"] == got["ref"]
    assert sorted(stores["port"]) == sorted(stores["ref"])
    for key in sorted(stores["ref"]):
        assert stores["port"][key] == stores["ref"][key], key
    assert writes["port"] == writes["ref"]


def test_the_cases_cover_the_reference_files():
    """The reference test files this module mirrors, case for case: 18
    functions of tests/test_webhook.py, 6 of test_restart_gating.py, 17
    of test_image_resolution.py, 18 of test_feast_config.py (23 cases),
    17 of test_auth_sidecar_resources.py (44 cases), 12 of
    test_mlflow.py's TestEnvInjection and 4 of test_runtime_images.py's
    TestMount."""
    counts = {}
    for key in CASES:
        counts[key.split(".")[0]] = counts.get(key.split(".")[0], 0) + 1
    assert counts == {"test_webhook": 18, "test_restart_gating": 6,
                      "test_image_resolution": 17, "test_feast_config": 23,
                      "test_auth_sidecar_resources": 44, "test_mlflow": 12,
                      "test_runtime_images": 4}


# ------------------------------------------------------ the image stage
@pytest.mark.parametrize("image,swapped", [
    ("jupyter/jax-notebook:latest", True),
    ("us-docker.pkg.dev/x/libtpu-runtime:1", True),
    ("rocm/pytorch:latest", True),
    ("quay.io/jupyter/minimal-notebook", True),
    ("kubeflownotebookswg/jupyter-pytorch-cuda-full:v1.9.0", False),
    ("nvcr.io/nvidia/pytorch:24.01-py3", False),
    ("my-gpu-workbench:2", False),
    ("busybox:latest", False),
])
def test_port_swap_is_the_reference_turned_round(image, swapped):
    """The port's image stage held exactly: an image that cannot drive an
    NVIDIA card (JAX, libtpu, ROCm, a generic notebook) is replaced by
    ``DEFAULT_GPU_IMAGE`` with the original recorded, a CUDA one and a
    non-notebook one are kept; the same admission through
    ``build_manager(components="extension")``'s store."""
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.utils.config import DEFAULT_GPU_IMAGE
    port = Stack("port")
    build_manager(port.store, port.Config(), components="extension")
    out = port.store.create(port.api.new_notebook(
        "nb", "ns", image=image, annotations={
            port.names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
    want = DEFAULT_GPU_IMAGE if swapped else image
    assert container(port, out)["image"] == want
    assert port.k8s.get_annotation(
        out, port.names.TPU_ORIGINAL_IMAGE_ANNOTATION) == \
        (image if swapped else None)
    nb = port.api.new_notebook("nb", "ns", image=image, annotations={
        port.names.TPU_ACCELERATOR_ANNOTATION: "h100-1"})
    assert port.wh.mutating.swap_image_for_gpu(nb) is swapped
    assert container(port, nb)["image"] == want


def test_admission_spans_match_the_reference():
    """The mutating webhook's spans on both packages, each under a
    recording provider: one ``notebook-mutating-webhook`` span per
    admission with the notebook, namespace and operation; the
    ``image-swapped`` event (a foreign image in, the side's default
    out), ``image-swap-skipped`` for a native image, and the
    ``maybe-restart-running-notebook`` child with ``updates-parked`` on a
    running notebook's parked change."""
    from kubeflow_tpu.utils import tracing as ref_tracing
    from kubeflow_tpu_torch.utils import tracing
    seen = {}
    for s, tr in ((Stack("ref"), ref_tracing), (Stack("port"), tracing)):
        exporter = tr.InMemorySpanExporter()
        before = tr.get_provider()
        tr.set_provider(tr.SDKProvider(exporter))
        try:
            swap_world(s)
            for name, role in (("a", "foreign"), ("b", "native")):
                s.store.create(s.api.new_notebook(
                    name, "ns", image=s.image(role), annotations={
                        s.names.TPU_ACCELERATOR_ANNOTATION:
                            s.accelerator("v5e-4")}))
            unlock(s, name="a")
            trust_bundle(s)
            s.store.patch(s.api.KIND, "ns", "a",
                          {"metadata": {"labels": {"touch": "1"}}})
        finally:
            tr.set_provider(before)
        seen[s.side] = normalise_result([
            {"name": sp.name, "attributes": sp.attributes,
             "events": [{"name": e.name, "attributes": e.attributes}
                        for e in sp.events],
             "parent": sp.parent_id is not None,
             "status": sp.status} for sp in exporter.spans], s.side)
    assert seen["port"] == seen["ref"]
    events = [e["name"] for sp in seen["port"] for e in sp["events"]]
    # a's create, b's create, a's unlock, then a's parked touch: its
    # child span ends (and is exported) before the admission's own
    assert events == ["image-swapped", "image-swap-skipped",
                      "image-swap-skipped", "updates-parked",
                      "image-swap-skipped"]
