"""The extension tier's function-level modules of the port held against
the reference's, case for case, on the same inputs.

Every case of tests/test_runtime_images.py but ``TestMount`` (the
webhook's mount, ROADMAP.md queue A item 6), of tests/test_elyra_dspa.py,
of tests/test_dspa_discovery.py, ``TestReconcileRoleBinding`` and
``TestTrackingURI`` of tests/test_mlflow.py (``TestEnvInjection`` is the
webhook's) and tests/test_extension.py's PEM case run against each
package's module on a store of its own (``torch_parity.Stack``), each
side with the case's own assertions; then what the case returns (values,
error messages), every object of both stores after ``normalise`` and the
writes are compared.

Last, the same functions of both packages on inputs drawn with numpy
from one seed: PEM blobs (valid blocks, garbage, bad base64, missing
END markers), runtime-image display names and metadata, DSPA specs with
fields dropped, emptied or retyped, and notebook/namespace names around
the 63-character route limit (the generateName suffix the store
completes included): equal outputs, exactly.
"""

from __future__ import annotations

import base64
import json

import numpy as np
import pytest

from torch_parity import Stack, normalise

CENTRAL = "kubeflow-tpu-system"
NS = "proj"
GW_NS = "openshift-ingress"
GW_NAME = "data-science-gateway"
SEED = 19


def b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


def config(s, **kw):
    return s.Config(gateway_name=GW_NAME, gateway_namespace=GW_NS, **kw)


def raised(exc_type, fn, fragment: str) -> str:
    """``fn()`` raises ``exc_type`` matching ``fragment``; its message."""
    with pytest.raises(exc_type, match=fragment) as exc:
        fn()
    return str(exc.value)


# --------------------------------------------------- runtime images
def stream(s, name="ds", tags=None, labeled=True):
    labels = {s.ext.runtime_images.RUNTIME_IMAGE_LABEL: "true"} \
        if labeled else {}
    return {"kind": "ImageStream", "apiVersion": "image.openshift.io/v1",
            "metadata": {"name": name, "namespace": CENTRAL,
                         "labels": labels},
            "spec": {"tags": tags if tags is not None else []}}


def tag(s, display="DS Runtime", image="quay.io/org/img@sha256:abc",
        metadata=None, name="1.0"):
    t = {"name": name}
    if image is not None:
        t["from"] = {"kind": "DockerImage", "name": image}
    if metadata is None and display is not None:
        metadata = json.dumps([{"display_name": display, "metadata": {}}])
    if metadata is not None:
        t["annotations"] = {s.ext.runtime_images.METADATA_ANNOTATION:
                            metadata}
    return t


def collect(s):
    return s.ext.runtime_images.collect_runtime_images(s.store, CENTRAL)


def ri_labeled_stream_with_tag_collected(s):
    s.store.create(stream(s, tags=[tag(s)]))
    data = collect(s)
    assert "ds-runtime.json" in data
    entry = json.loads(data["ds-runtime.json"])
    assert entry["metadata"]["image_name"] == "quay.io/org/img@sha256:abc"
    return data


def ri_unlabeled_stream_ignored(s):
    s.store.create(stream(s, tags=[tag(s)], labeled=False))
    assert collect(s) == {}


def ri_stream_without_tags_skipped(s):
    s.store.create(stream(s))
    assert collect(s) == {}


def ri_tag_without_from_reference_skipped(s):
    s.store.create(stream(s, tags=[tag(s, image=None)]))
    assert collect(s) == {}


def ri_tag_without_metadata_annotation_skipped(s):
    s.store.create(stream(s, tags=[tag(s, display=None)]))
    assert collect(s) == {}


def ri_malformed_metadata_skipped(s):
    s.store.create(stream(s, tags=[tag(s, metadata="{not json")]))
    assert collect(s) == {}


def ri_non_array_metadata_skipped(s):
    s.store.create(stream(
        s, tags=[tag(s, metadata=json.dumps({"display_name": "X"}))]))
    assert collect(s) == {}


def ri_only_first_array_object_used(s):
    meta = json.dumps([{"display_name": "First", "metadata": {}},
                       {"display_name": "Second", "metadata": {}}])
    s.store.create(stream(s, tags=[tag(s, metadata=meta)]))
    data = collect(s)
    assert list(data) == ["first.json"]
    return data


def ri_entry_without_display_name_skipped(s):
    s.store.create(stream(
        s, tags=[tag(s, metadata=json.dumps([{"metadata": {}}]))]))
    assert collect(s) == {}


def ri_all_invalid_display_name_skipped(s):
    s.store.create(stream(
        s, tags=[tag(s, metadata=json.dumps([{"display_name": "***"}]))]))
    assert collect(s) == {}


def ri_multiple_tags_multiple_entries(s):
    s.store.create(stream(s, tags=[
        tag(s, display="Python 3.11", name="py311",
            image="quay.io/org/py@sha256:1"),
        tag(s, display="Spark 3.5", name="spark",
            image="quay.io/org/spark@sha256:2")]))
    data = collect(s)
    assert set(data) == {"python-3.11.json", "spark-3.5.json"}
    return data


def ri_image_name_injected_only_into_metadata_dict(s):
    meta = json.dumps([{"display_name": "X", "metadata": "odd"}])
    s.store.create(stream(s, tags=[tag(s, metadata=meta)]))
    entry = json.loads(collect(s)["x.json"])
    assert entry["metadata"] == "odd"
    return entry


def sync(s):
    s.ext.runtime_images.sync_runtime_images_config_map(s.store, CENTRAL, NS)


def ri_no_images_no_configmap_created(s):
    sync(s)
    assert s.store.get_or_none("ConfigMap", NS, s.ext.runtime_images.
                               CONFIGMAP_NAME) is None


def ri_creates_labeled_configmap(s):
    s.store.create(stream(s, tags=[tag(s)]))
    sync(s)
    cm = s.store.get("ConfigMap", NS, s.ext.runtime_images.CONFIGMAP_NAME)
    assert cm["metadata"]["labels"]["opendatahub.io/managed-by"] == \
        "workbenches"
    assert "ds-runtime.json" in cm["data"]


def ri_updates_on_inventory_change(s):
    s.store.create(stream(s, tags=[tag(s)]))
    sync(s)
    s.store.create(stream(s, name="spark", tags=[
        tag(s, display="Spark", image="quay.io/org/spark@sha256:2")]))
    sync(s)
    cm = s.store.get("ConfigMap", NS, s.ext.runtime_images.CONFIGMAP_NAME)
    assert set(cm["data"]) == {"ds-runtime.json", "spark.json"}


def ri_existing_configmap_left_as_is_when_inventory_empties(s):
    st = s.store.create(stream(s, tags=[tag(s)]))
    sync(s)
    s.store.delete("ImageStream", CENTRAL, st["metadata"]["name"])
    sync(s)
    cm = s.store.get("ConfigMap", NS, s.ext.runtime_images.CONFIGMAP_NAME)
    assert "ds-runtime.json" in cm["data"]


def ri_no_rewrite_when_stable(s):
    name = s.ext.runtime_images.CONFIGMAP_NAME
    s.store.create(stream(s, tags=[tag(s)]))
    sync(s)
    rv = s.store.get("ConfigMap", NS, name)["metadata"]["resourceVersion"]
    sync(s)
    assert s.store.get("ConfigMap", NS, name)["metadata"][
        "resourceVersion"] == rv


# ------------------------------------------------------ Elyra and DSPA
def gateway(listeners=None, owners=None):
    gw = {"kind": "Gateway",
          "apiVersion": "gateway.networking.k8s.io/v1",
          "metadata": {"name": GW_NAME, "namespace": GW_NS},
          "spec": {"listeners": [] if listeners is None else listeners}}
    if owners:
        gw["metadata"]["ownerReferences"] = owners
    return gw


def owner_ref(kind, name):
    return {"kind": kind, "name": name, "uid": f"uid-{kind}-{name}",
            "apiVersion": "v1"}


def route(name, host, owners):
    return {"kind": "Route", "apiVersion": "route.openshift.io/v1",
            "metadata": {"name": name, "namespace": GW_NS,
                         "ownerReferences": owners},
            "spec": {"host": host}}


def cos_secret(ns=NS, name="s3-creds", data=None):
    if data is None:
        data = {"AWS_ACCESS_KEY_ID": b64("minio-user"),
                "AWS_SECRET_ACCESS_KEY": b64("minio-pass")}
    return {"kind": "Secret", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": ns}, "data": data}


def dspa(name="dspa", ns=NS, spec=None, status=None):
    obj = {"kind": "DataSciencePipelinesApplication",
           "apiVersion":
               "datasciencepipelinesapplications.opendatahub.io/v1alpha1",
           "metadata": {"name": name, "namespace": ns},
           "spec": spec if spec is not None else {
               "objectStorage": {"externalStorage": {
                   "host": "s3.example.com", "bucket": "pipelines",
                   "s3CredentialsSecret": {
                       "secretName": "s3-creds",
                       "accessKey": "AWS_ACCESS_KEY_ID",
                       "secretKey": "AWS_SECRET_ACCESS_KEY"}}}}}
    if status is not None:
        obj["status"] = status
    return obj


def decoded_secret(s, ns=NS):
    secret = s.store.get("Secret", ns, s.ext.elyra.SECRET_NAME)
    return json.loads(base64.b64decode(secret["data"]["odh_dsp.json"]))


def hostname(s, **kw):
    return s.ext.elyra.discover_public_hostname(s.store, config(s, **kw))


# GatewayConfig owner (test_elyra_dspa.py TestGatewayConfigOwner)
def gco_no_owner_references(s):
    assert s.ext.elyra._gateway_config_owner(gateway()) == ""


def gco_owner_references_without_gatewayconfig(s):
    gw = gateway(owners=[owner_ref("Deployment", "some-deploy"),
                         owner_ref("ConfigMap", "some-cm")])
    assert s.ext.elyra._gateway_config_owner(gw) == ""


def gco_gatewayconfig_owner_found(s):
    gw = gateway(owners=[owner_ref("GatewayConfig", "default-gateway")])
    assert s.ext.elyra._gateway_config_owner(gw) == "default-gateway"


def gco_gatewayconfig_among_multiple_owners(s):
    gw = gateway(owners=[owner_ref("Deployment", "other"),
                         owner_ref("GatewayConfig", "default-gateway"),
                         owner_ref("Service", "svc")])
    assert s.ext.elyra._gateway_config_owner(gw) == "default-gateway"


# hostname discovery (test_elyra_dspa.py TestHostnameDiscovery)
def hd_no_gateway_returns_empty(s):
    assert hostname(s) == ""


def hd_hostname_from_first_listener(s):
    s.store.create(gateway(listeners=[{"hostname": "gw.apps.example.com"},
                                      {"hostname": "second.example.com"}]))
    assert hostname(s) == "gw.apps.example.com"


def _gc_route_world(s, listeners):
    s.store.create(gateway(listeners=listeners,
                           owners=[owner_ref("GatewayConfig", "gc")]))
    s.store.create(route("r", "route.apps.example.com",
                         [owner_ref("GatewayConfig", "gc")]))


def hd_route_fallback_when_listeners_empty(s):
    _gc_route_world(s, [])
    assert hostname(s) == "route.apps.example.com"


def hd_route_fallback_when_listener_hostname_missing(s):
    _gc_route_world(s, [{}])
    assert hostname(s) == "route.apps.example.com"


def hd_route_fallback_when_listener_hostname_empty(s):
    _gc_route_world(s, [{"hostname": ""}])
    assert hostname(s) == "route.apps.example.com"


def hd_no_owner_and_no_hostname_returns_empty(s):
    s.store.create(gateway(listeners=[{}]))
    s.store.create(route("r", "route.apps.example.com",
                         [owner_ref("GatewayConfig", "gc")]))
    assert hostname(s) == ""


def hd_route_fallback_finds_no_matching_route(s):
    s.store.create(gateway(owners=[owner_ref("GatewayConfig", "gc")]))
    s.store.create(route("r", "other.example.com",
                         [owner_ref("GatewayConfig", "other-gc")]))
    assert hostname(s) == ""


def hd_gateway_hostname_preferred_over_route(s):
    s.store.create(gateway(
        listeners=[{"hostname": "gw.apps.example.com"}],
        owners=[owner_ref("GatewayConfig", "gc")]))
    s.store.create(route("r", "route.apps.example.com",
                         [owner_ref("GatewayConfig", "gc")]))
    assert hostname(s) == "gw.apps.example.com"


def hd_route_without_owner_references_skipped(s):
    s.store.create(gateway(owners=[owner_ref("GatewayConfig", "gc")]))
    s.store.create({"kind": "Route", "apiVersion": "route.openshift.io/v1",
                    "metadata": {"name": "r", "namespace": GW_NS},
                    "spec": {"host": "route.apps.example.com"}})
    assert hostname(s) == ""


def hd_route_owner_not_gatewayconfig_kind_skipped(s):
    s.store.create(gateway(owners=[owner_ref("GatewayConfig", "gc")]))
    s.store.create(route("r", "route.apps.example.com",
                         [owner_ref("Deployment", "gc")]))
    assert hostname(s) == ""


def hd_route_matching_owner_but_empty_host(s):
    s.store.create(gateway(owners=[owner_ref("GatewayConfig", "gc")]))
    s.store.create(route("r", "", [owner_ref("GatewayConfig", "gc")]))
    assert hostname(s) == ""


# extract validation (test_elyra_dspa.py TestExtractValidation)
def extract(s, d):
    return s.ext.elyra.extract_runtime_config(d, config(s), NS, s.store)


def expect_error(s, d, fragment):
    return raised(s.ext.elyra.IncompleteDSPAError, lambda: extract(s, d),
                  fragment)


def _storage(d):
    return d["spec"]["objectStorage"]["externalStorage"]


def ev_object_storage_missing(s):
    return expect_error(s, dspa(spec={}), "objectStorage")


def ev_external_storage_missing(s):
    return expect_error(s, dspa(spec={"objectStorage": {}}),
                        "externalStorage")


def ev_host_empty(s):
    d = dspa()
    _storage(d)["host"] = ""
    return expect_error(s, d, "host")


def ev_bucket_empty(s):
    d = dspa()
    _storage(d)["bucket"] = ""
    return expect_error(s, d, "bucket")


def ev_credentials_secret_missing(s):
    d = dspa()
    del _storage(d)["s3CredentialsSecret"]
    return expect_error(s, d, "s3CredentialsSecret")


def ev_secret_name_empty(s):
    d = dspa()
    _storage(d)["s3CredentialsSecret"]["secretName"] = ""
    return expect_error(s, d, "secretName")


def ev_access_key_empty(s):
    d = dspa()
    _storage(d)["s3CredentialsSecret"]["accessKey"] = ""
    return expect_error(s, d, "accessKey")


def ev_secret_key_empty(s):
    d = dspa()
    _storage(d)["s3CredentialsSecret"]["secretKey"] = ""
    return expect_error(s, d, "secretKey")


def ev_cos_secret_not_found(s):
    return expect_error(s, dspa(), "not found")


def ev_access_key_missing_from_secret(s):
    s.store.create(cos_secret(
        data={"AWS_SECRET_ACCESS_KEY": b64("minio-pass")}))
    return expect_error(s, dspa(), "AWS_ACCESS_KEY_ID")


def ev_secret_key_missing_from_secret(s):
    s.store.create(cos_secret(data={"AWS_ACCESS_KEY_ID": b64("minio-user")}))
    return expect_error(s, dspa(), "AWS_SECRET_ACCESS_KEY")


def ev_malformed_base64_credential_skips_gracefully(s):
    s.store.create(cos_secret(
        data={"AWS_ACCESS_KEY_ID": "%%%not-base64%%%",
              "AWS_SECRET_ACCESS_KEY": b64("p")}))
    return expect_error(s, dspa(), "unreadable")


def ev_non_utf8_credential_skips_gracefully(s):
    raw = base64.b64encode(b"\xff\xfe\x80").decode()
    s.store.create(cos_secret(
        data={"AWS_ACCESS_KEY_ID": raw, "AWS_SECRET_ACCESS_KEY": b64("p")}))
    return expect_error(s, dspa(), "unreadable")


# extract content (test_elyra_dspa.py TestExtractContent)
def ec_default_https_scheme(s):
    s.store.create(cos_secret())
    runtime = extract(s, dspa())
    assert runtime["metadata"]["cos_endpoint"] == "https://s3.example.com"
    return runtime


def ec_custom_scheme(s):
    s.store.create(cos_secret())
    d = dspa()
    _storage(d)["scheme"] = "http"
    runtime = extract(s, d)
    assert runtime["metadata"]["cos_endpoint"] == "http://s3.example.com"
    return runtime


def ec_api_endpoint_from_dspa_status(s):
    s.store.create(cos_secret())
    d = dspa(status={"components": {"apiServer": {
        "externalUrl": "https://pipe.apps.example.com/pipeline"}}})
    runtime = extract(s, d)
    assert runtime["metadata"]["api_endpoint"] == \
        "https://pipe.apps.example.com/pipeline"
    return runtime


def ec_public_endpoint_with_gateway_hostname(s):
    s.store.create(cos_secret())
    s.store.create(gateway(listeners=[{"hostname": "gw.example.com"}]))
    runtime = extract(s, dspa())
    assert runtime["metadata"]["public_api_endpoint"] == \
        f"https://gw.example.com/external/elyra/{NS}"
    return runtime


def ec_no_public_endpoint_without_gateway(s):
    s.store.create(cos_secret())
    runtime = extract(s, dspa())
    assert "public_api_endpoint" not in runtime["metadata"]
    return runtime


def ec_public_endpoint_from_route_fallback(s):
    s.store.create(cos_secret())
    s.store.create(gateway(owners=[owner_ref("GatewayConfig", "gc")]))
    s.store.create(route("r", "route.example.com",
                         [owner_ref("GatewayConfig", "gc")]))
    runtime = extract(s, dspa())
    assert runtime["metadata"]["public_api_endpoint"] == \
        f"https://route.example.com/external/elyra/{NS}"
    return runtime


def ec_all_required_fields_populated(s):
    s.store.create(cos_secret())
    runtime = extract(s, dspa())
    md = runtime["metadata"]
    assert runtime["schema_name"] == "kfp"
    assert runtime["display_name"] == "Pipeline"
    assert md["engine"] == "Argo"
    assert md["runtime_type"] == "KUBEFLOW_PIPELINES"
    assert md["auth_type"] == "KUBERNETES_SERVICE_ACCOUNT_TOKEN"
    assert md["cos_auth_type"] == "KUBERNETES_SECRET"
    assert md["cos_bucket"] == "pipelines"
    assert md["cos_secret"] == "s3-creds"
    assert md["cos_username"] == "minio-user"
    assert md["cos_password"] == "minio-pass"
    assert md["tags"] == []
    return runtime


def ec_string_data_credentials_accepted(s):
    s.store.create({"kind": "Secret", "apiVersion": "v1",
                    "metadata": {"name": "s3-creds", "namespace": NS},
                    "stringData": {"AWS_ACCESS_KEY_ID": "u",
                                   "AWS_SECRET_ACCESS_KEY": "p"}})
    runtime = extract(s, dspa())
    assert runtime["metadata"]["cos_username"] == "u"
    assert runtime["metadata"]["cos_password"] == "p"
    return runtime


# sync lifecycle (test_elyra_dspa.py TestSyncLifecycle)
def sync_secret(s, **kw):
    return s.ext.elyra.sync_elyra_runtime_secret(s.store, config(s, **kw),
                                                 NS)


def sl_skips_when_dspa_absent(s):
    assert not sync_secret(s)
    assert s.store.get_or_none("Secret", NS, s.ext.elyra.SECRET_NAME) is None


_INCOMPLETE_SPECS = [
    {},
    {"objectStorage": {}},
    {"objectStorage": {"externalStorage": {"host": "h", "bucket": "b"}}},
]


def _skips_gracefully_on_incomplete_dspa(i):
    def case(s):
        s.store.create(dspa(spec=_INCOMPLETE_SPECS[i]))
        assert not sync_secret(s)
        assert s.store.get_or_none("Secret", NS,
                                   s.ext.elyra.SECRET_NAME) is None
    case.__name__ = f"sl_skips_gracefully_on_incomplete_dspa[{i}]"
    return case


def sl_skips_when_cos_secret_missing(s):
    s.store.create(dspa())
    assert not sync_secret(s)


def sl_creates_secret_owned_by_dspa(s):
    elyra = s.ext.elyra
    s.store.create(cos_secret())
    d = s.store.create(dspa())
    assert sync_secret(s)
    secret = s.store.get("Secret", NS, elyra.SECRET_NAME)
    assert secret["metadata"]["labels"][elyra.MANAGED_BY_KEY] == \
        elyra.MANAGED_BY_VALUE
    owners = secret["metadata"]["ownerReferences"]
    assert owners[0]["kind"] == "DataSciencePipelinesApplication"
    assert owners[0]["uid"] == d["metadata"]["uid"]
    assert owners[0]["controller"] is True
    assert owners[0]["blockOwnerDeletion"] is False
    return owners


def sl_updates_secret_on_content_drift(s):
    s.store.create(cos_secret())
    s.store.create(dspa())
    sync_secret(s)
    secret = s.store.get("Secret", NS, s.ext.elyra.SECRET_NAME)
    secret["data"] = {"odh_dsp.json": b64("{}")}
    s.store.update(secret)
    sync_secret(s)
    assert decoded_secret(s)["schema_name"] == "kfp"
    return decoded_secret(s)


def sl_repairs_stripped_managed_by_label(s):
    elyra = s.ext.elyra
    s.store.create(cos_secret())
    s.store.create(dspa())
    sync_secret(s)
    secret = s.store.get("Secret", NS, elyra.SECRET_NAME)
    secret["metadata"]["labels"] = {"app.kubernetes.io/part-of": "x"}
    s.store.update(secret)
    sync_secret(s)
    labels = s.store.get("Secret", NS, elyra.SECRET_NAME)["metadata"][
        "labels"]
    assert labels[elyra.MANAGED_BY_KEY] == elyra.MANAGED_BY_VALUE
    assert labels["app.kubernetes.io/part-of"] == "x"


def sl_no_update_when_content_stable(s):
    name = s.ext.elyra.SECRET_NAME
    s.store.create(cos_secret())
    s.store.create(dspa())
    sync_secret(s)
    rv = s.store.get("Secret", NS, name)["metadata"]["resourceVersion"]
    sync_secret(s)
    assert s.store.get("Secret", NS, name)["metadata"][
        "resourceVersion"] == rv


def sl_foreign_secret_never_deleted(s):
    s.store.create({"kind": "Secret", "apiVersion": "v1",
                    "metadata": {"name": s.ext.elyra.SECRET_NAME,
                                 "namespace": NS},
                    "data": {"user": b64("data")}})
    assert not sync_secret(s)
    assert s.store.get("Secret", NS, s.ext.elyra.SECRET_NAME)


def sl_deletes_secret_when_dspa_removed(s):
    s.store.create(cos_secret())
    d = s.store.create(dspa())
    sync_secret(s)
    s.store.delete("DataSciencePipelinesApplication", NS,
                   d["metadata"]["name"])
    sync_secret(s)
    assert s.store.get_or_none("Secret", NS, s.ext.elyra.SECRET_NAME) is None


# mount (test_elyra_dspa.py TestMount)
def notebook(containers=None, volumes=None):
    spec = {"containers": containers if containers is not None else
            [{"name": "nb", "image": "img"}]}
    if volumes is not None:
        spec["volumes"] = volumes
    return {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
            "metadata": {"name": "nb", "namespace": NS},
            "spec": {"template": {"spec": spec}}}


def managed_secret(s):
    s.store.create(cos_secret())
    s.store.create(dspa())
    assert sync_secret(s)


def mt_skips_when_secret_absent(s):
    nb = notebook()
    s.ext.elyra.mount_elyra_secret(s.store, nb)
    assert "volumes" not in nb["spec"]["template"]["spec"]
    return nb


def mt_skips_unmanaged_secret(s):
    s.store.create({"kind": "Secret", "apiVersion": "v1",
                    "metadata": {"name": s.ext.elyra.SECRET_NAME,
                                 "namespace": NS},
                    "data": {"odh_dsp.json": b64("{}")}})
    nb = notebook()
    s.ext.elyra.mount_elyra_secret(s.store, nb)
    assert "volumes" not in nb["spec"]["template"]["spec"]
    return nb


def mt_skips_empty_secret(s):
    elyra = s.ext.elyra
    s.store.create({"kind": "Secret", "apiVersion": "v1",
                    "metadata": {"name": elyra.SECRET_NAME,
                                 "namespace": NS,
                                 "labels": {elyra.MANAGED_BY_KEY:
                                            elyra.MANAGED_BY_VALUE}},
                    "data": {}})
    nb = notebook()
    elyra.mount_elyra_secret(s.store, nb)
    assert "volumes" not in nb["spec"]["template"]["spec"]
    return nb


def mt_mounts_volume_and_every_container(s):
    elyra = s.ext.elyra
    managed_secret(s)
    nb = notebook(containers=[{"name": "nb", "image": "img"},
                              {"name": "sidecar", "image": "proxy"}])
    elyra.mount_elyra_secret(s.store, nb)
    spec = nb["spec"]["template"]["spec"]
    assert spec["volumes"] == [{
        "name": elyra.VOLUME_NAME,
        "secret": {"secretName": elyra.SECRET_NAME, "optional": True}}]
    for c in spec["containers"]:
        assert any(m["mountPath"] == elyra.MOUNT_PATH
                   for m in c["volumeMounts"])
    return nb


def mt_mount_idempotent(s):
    managed_secret(s)
    nb = notebook()
    s.ext.elyra.mount_elyra_secret(s.store, nb)
    s.ext.elyra.mount_elyra_secret(s.store, nb)
    spec = nb["spec"]["template"]["spec"]
    assert len(spec["volumes"]) == 1
    assert len(spec["containers"][0]["volumeMounts"]) == 1
    return nb


def mt_mount_dedupes_by_path_even_with_foreign_name(s):
    managed_secret(s)
    nb = notebook(containers=[{
        "name": "nb", "image": "img",
        "volumeMounts": [{"name": "user-runtimes",
                          "mountPath": s.ext.elyra.MOUNT_PATH}]}])
    s.ext.elyra.mount_elyra_secret(s.store, nb)
    mounts = nb["spec"]["template"]["spec"]["containers"][0]["volumeMounts"]
    assert len(mounts) == 1 and mounts[0]["name"] == "user-runtimes"
    return nb


# ------------------------------------------ tests/test_dspa_discovery.py
def dd_gateway(listeners=None, owner=None):
    owners = [{"kind": "GatewayConfig", "name": owner,
               "uid": f"uid-{owner}"}] if owner else None
    return gateway(listeners=listeners, owners=owners)


def dd_route(name, host, owner):
    return route(name, host, [{"kind": "GatewayConfig", "name": owner,
                               "uid": f"uid-{owner}"}])


def dd_gateway_listener_hostname_wins(s):
    s.store.create(dd_gateway(listeners=[{"hostname":
                                          "gw.apps.example.com"}]))
    assert hostname(s) == "gw.apps.example.com"


def dd_route_fallback_through_gatewayconfig_owner(s):
    s.store.create(dd_gateway(listeners=[{}], owner="default-gateway"))
    s.store.create(dd_route("unrelated", "other.example.com",
                            "other-config"))
    s.store.create(dd_route("gw-route", "route.apps.example.com",
                            "default-gateway"))
    assert hostname(s) == "route.apps.example.com"


def dd_gateway_without_owner_cannot_fall_back(s):
    s.store.create(dd_gateway(listeners=[]))
    s.store.create(dd_route("gw-route", "route.apps.example.com",
                            "default-gateway"))
    assert hostname(s) == ""


def dd_empty_route_host_yields_static_fallback(s):
    s.store.create(dd_gateway(owner="default-gateway"))
    s.store.create(dd_route("gw-route", "", "default-gateway"))
    assert hostname(s, gateway_url="static.example.com") == \
        "static.example.com"


def dd_no_gateway_uses_static_config(s):
    assert hostname(s, gateway_url="static.example.com") == \
        "static.example.com"
    assert hostname(s) == ""


def dd_secret_content_carries_discovered_endpoint(s):
    s.store.create(dd_gateway(listeners=[{"hostname":
                                          "gw.apps.example.com"}]))
    s.store.create(cos_secret())
    s.store.create(dspa())
    assert sync_secret(s)
    runtime = decoded_secret(s)
    md = runtime["metadata"]
    assert md["public_api_endpoint"] == \
        "https://gw.apps.example.com/external/elyra/proj"
    assert md["api_endpoint"] == \
        "https://gw.apps.example.com/pipelines/proj/dspa"
    assert md["cos_endpoint"] == "https://s3.example.com"
    assert md["cos_bucket"] == "pipelines"
    assert md["cos_secret"] == "s3-creds"
    assert md["cos_username"] == "minio-user"
    assert md["cos_password"] == "minio-pass"
    assert runtime["schema_name"] == "kfp"
    return runtime


def dd_secret_omits_public_endpoint_without_hostname(s):
    s.store.create(cos_secret())
    s.store.create(dspa())
    assert sync_secret(s)
    md = decoded_secret(s)["metadata"]
    assert "public_api_endpoint" not in md
    assert md["api_endpoint"].startswith("https://gateway.invalid/")
    return md


def dd_secret_updates_when_gateway_appears(s):
    s.store.create(cos_secret())
    s.store.create(dspa())
    sync_secret(s)
    s.store.create(dd_gateway(listeners=[{"hostname": "late.example.com"}]))
    sync_secret(s)
    assert decoded_secret(s)["metadata"]["public_api_endpoint"] == \
        "https://late.example.com/external/elyra/proj"


# ------------------------------------------------ tests/test_mlflow.py
def ml_notebook(name="nb", annotations=None):
    nb = {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
          "metadata": {"name": name, "namespace": NS},
          "spec": {"template": {"spec": {
              "containers": [{"name": name, "image": "img"}]}}}}
    if annotations:
        nb["metadata"]["annotations"] = annotations
    return nb


def ml_cluster_role(s):
    s.store.create({"kind": "ClusterRole",
                    "apiVersion": "rbac.authorization.k8s.io/v1",
                    "metadata": {"name": s.ext.rbac.MLFLOW_CLUSTER_ROLE}})


def ml_gateway(s, host="gw.apps.example.com"):
    s.store.create(gateway(listeners=[{"hostname": host}]))


def ml_annotated(s, value="mlflow"):
    return s.store.create(ml_notebook(annotations={
        s.names.MLFLOW_INSTANCE_ANNOTATION: value}))


def ml_rb(s):
    return s.store.get_or_none("RoleBinding", NS,
                               s.ext.rbac.mlflow_rb_name("nb"))


def rb_no_annotation_no_rolebinding(s):
    ml_cluster_role(s)
    nb = s.store.create(ml_notebook())
    assert s.ext.rbac.reconcile_mlflow_integration(s.store, nb) is None
    assert ml_rb(s) is None


def rb_cleans_up_rolebinding_when_annotation_absent(s):
    ml_cluster_role(s)
    nb = ml_annotated(s)
    s.ext.rbac.reconcile_mlflow_integration(s.store, nb)
    assert ml_rb(s)
    nb["metadata"]["annotations"] = {}
    assert s.ext.rbac.reconcile_mlflow_integration(s.store, nb) is None
    assert ml_rb(s) is None


def rb_whitespace_annotation_treated_as_absent(s):
    ml_cluster_role(s)
    nb = ml_annotated(s, "   ")
    assert s.ext.rbac.reconcile_mlflow_integration(s.store, nb) is None
    assert ml_rb(s) is None


def rb_requeues_without_clusterrole(s):
    nb = ml_annotated(s)
    delay = s.ext.rbac.reconcile_mlflow_integration(s.store, nb)
    assert delay == s.ext.rbac.MLFLOW_REQUEUE_SECONDS
    assert ml_rb(s) is None
    return delay


def rb_creates_rolebinding_with_annotation(s):
    rbac = s.ext.rbac
    ml_cluster_role(s)
    nb = ml_annotated(s)
    assert rbac.reconcile_mlflow_integration(s.store, nb) is None
    rb = ml_rb(s)
    assert rb["roleRef"] == {"apiGroup": "rbac.authorization.k8s.io",
                             "kind": "ClusterRole",
                             "name": rbac.MLFLOW_CLUSTER_ROLE}
    assert rb["subjects"] == [{"kind": "ServiceAccount",
                               "name": "default", "namespace": NS}]
    assert rb["metadata"]["ownerReferences"][0]["kind"] == "Notebook"


def rb_repairs_subject_drift(s):
    ml_cluster_role(s)
    nb = ml_annotated(s)
    s.ext.rbac.reconcile_mlflow_integration(s.store, nb)
    rb = ml_rb(s)
    rb["subjects"] = [{"kind": "ServiceAccount", "name": "hijacked",
                       "namespace": NS}]
    s.store.update(rb)
    s.ext.rbac.reconcile_mlflow_integration(s.store, nb)
    assert ml_rb(s)["subjects"][0]["name"] == "default"


def rb_label_repair_preserves_foreign_labels(s):
    ml_cluster_role(s)
    nb = ml_annotated(s)
    s.ext.rbac.reconcile_mlflow_integration(s.store, nb)
    rb = ml_rb(s)
    rb["metadata"]["labels"]["policy.example.com/audit"] = "yes"
    s.store.update(rb)
    s.ext.rbac.reconcile_mlflow_integration(s.store, nb)
    rb = ml_rb(s)
    assert rb["metadata"]["labels"]["policy.example.com/audit"] == "yes"
    rv = rb["metadata"]["resourceVersion"]
    s.ext.rbac.reconcile_mlflow_integration(s.store, nb)
    assert ml_rb(s)["metadata"]["resourceVersion"] == rv


def rb_stable_rolebinding_not_rewritten(s):
    ml_cluster_role(s)
    nb = ml_annotated(s)
    s.ext.rbac.reconcile_mlflow_integration(s.store, nb)
    rv = ml_rb(s)["metadata"]["resourceVersion"]
    s.ext.rbac.reconcile_mlflow_integration(s.store, nb)
    assert ml_rb(s)["metadata"]["resourceVersion"] == rv


def uri(s, instance="mlflow", **kw):
    """tests/test_mlflow.py's ``get_mlflow_tracking_uri`` call, MLflow
    on."""
    return s.ext.rbac.get_mlflow_tracking_uri(
        s.store, config(s, mlflow_enabled=True, **kw), instance)


def tu_prepends_https_when_no_scheme(s):
    assert uri(s, gateway_url="gw.example.com") == \
        "https://gw.example.com/mlflow"


def tu_preserves_https_scheme(s):
    assert uri(s, gateway_url="https://gw.example.com") == \
        "https://gw.example.com/mlflow"


def tu_preserves_http_scheme(s):
    assert uri(s, gateway_url="http://gw.example.com") == \
        "http://gw.example.com/mlflow"


def tu_non_default_instance_path_segment(s):
    assert uri(s, "tracking-1", gateway_url="gw.example.com") == \
        "https://gw.example.com/mlflow-tracking-1"


def tu_gateway_lookup_when_no_configured_url(s):
    ml_gateway(s)
    assert uri(s) == "https://gw.apps.example.com/mlflow"


def tu_configured_url_bypasses_gateway_lookup(s):
    ml_gateway(s, "from-gateway.example.com")
    assert uri(s, gateway_url="configured.example.com") == \
        "https://configured.example.com/mlflow"


def tu_none_when_no_hostname_determinable(s):
    assert uri(s) is None


# ---------------------------------------------- tests/test_extension.py
def pem_validation_drops_bad_base64(s):
    bad = ("-----BEGIN CERTIFICATE-----\n!!!not-base64!!!\n"
           "-----END CERTIFICATE-----")
    good = ("-----BEGIN CERTIFICATE-----\nZ29vZA==\n"
            "-----END CERTIFICATE-----")
    blocks = s.ext.cacert.extract_valid_pem_blocks(bad + "\n" + good)
    assert len(blocks) == 1 and "Z29vZA" in blocks[0]
    return blocks


def _cases(prefix: str, fns) -> dict:
    return {f"{prefix}.{fn.__name__.split('_', 1)[1]}": fn for fn in fns}


CASES = {}
CASES.update(_cases("test_runtime_images.TestCollect", (
    ri_labeled_stream_with_tag_collected, ri_unlabeled_stream_ignored,
    ri_stream_without_tags_skipped, ri_tag_without_from_reference_skipped,
    ri_tag_without_metadata_annotation_skipped,
    ri_malformed_metadata_skipped, ri_non_array_metadata_skipped,
    ri_only_first_array_object_used, ri_entry_without_display_name_skipped,
    ri_all_invalid_display_name_skipped, ri_multiple_tags_multiple_entries,
    ri_image_name_injected_only_into_metadata_dict)))
CASES.update(_cases("test_runtime_images.TestSync", (
    ri_no_images_no_configmap_created, ri_creates_labeled_configmap,
    ri_updates_on_inventory_change,
    ri_existing_configmap_left_as_is_when_inventory_empties,
    ri_no_rewrite_when_stable)))
CASES.update(_cases("test_elyra_dspa.TestGatewayConfigOwner", (
    gco_no_owner_references, gco_owner_references_without_gatewayconfig,
    gco_gatewayconfig_owner_found, gco_gatewayconfig_among_multiple_owners)))
CASES.update(_cases("test_elyra_dspa.TestHostnameDiscovery", (
    hd_no_gateway_returns_empty, hd_hostname_from_first_listener,
    hd_route_fallback_when_listeners_empty,
    hd_route_fallback_when_listener_hostname_missing,
    hd_route_fallback_when_listener_hostname_empty,
    hd_no_owner_and_no_hostname_returns_empty,
    hd_route_fallback_finds_no_matching_route,
    hd_gateway_hostname_preferred_over_route,
    hd_route_without_owner_references_skipped,
    hd_route_owner_not_gatewayconfig_kind_skipped,
    hd_route_matching_owner_but_empty_host)))
CASES.update(_cases("test_elyra_dspa.TestExtractValidation", (
    ev_object_storage_missing, ev_external_storage_missing, ev_host_empty,
    ev_bucket_empty, ev_credentials_secret_missing, ev_secret_name_empty,
    ev_access_key_empty, ev_secret_key_empty, ev_cos_secret_not_found,
    ev_access_key_missing_from_secret, ev_secret_key_missing_from_secret,
    ev_malformed_base64_credential_skips_gracefully,
    ev_non_utf8_credential_skips_gracefully)))
CASES.update(_cases("test_elyra_dspa.TestExtractContent", (
    ec_default_https_scheme, ec_custom_scheme,
    ec_api_endpoint_from_dspa_status,
    ec_public_endpoint_with_gateway_hostname,
    ec_no_public_endpoint_without_gateway,
    ec_public_endpoint_from_route_fallback, ec_all_required_fields_populated,
    ec_string_data_credentials_accepted)))
CASES.update(_cases("test_elyra_dspa.TestSyncLifecycle", (
    sl_skips_when_dspa_absent,
    *(_skips_gracefully_on_incomplete_dspa(i)
      for i in range(len(_INCOMPLETE_SPECS))),
    sl_skips_when_cos_secret_missing, sl_creates_secret_owned_by_dspa,
    sl_updates_secret_on_content_drift, sl_repairs_stripped_managed_by_label,
    sl_no_update_when_content_stable, sl_foreign_secret_never_deleted,
    sl_deletes_secret_when_dspa_removed)))
CASES.update(_cases("test_elyra_dspa.TestMount", (
    mt_skips_when_secret_absent, mt_skips_unmanaged_secret,
    mt_skips_empty_secret, mt_mounts_volume_and_every_container,
    mt_mount_idempotent, mt_mount_dedupes_by_path_even_with_foreign_name)))
CASES.update(_cases("test_dspa_discovery", (
    dd_gateway_listener_hostname_wins,
    dd_route_fallback_through_gatewayconfig_owner,
    dd_gateway_without_owner_cannot_fall_back,
    dd_empty_route_host_yields_static_fallback,
    dd_no_gateway_uses_static_config,
    dd_secret_content_carries_discovered_endpoint,
    dd_secret_omits_public_endpoint_without_hostname,
    dd_secret_updates_when_gateway_appears)))
CASES.update(_cases("test_mlflow.TestReconcileRoleBinding", (
    rb_no_annotation_no_rolebinding,
    rb_cleans_up_rolebinding_when_annotation_absent,
    rb_whitespace_annotation_treated_as_absent,
    rb_requeues_without_clusterrole, rb_creates_rolebinding_with_annotation,
    rb_repairs_subject_drift, rb_label_repair_preserves_foreign_labels,
    rb_stable_rolebinding_not_rewritten)))
CASES.update(_cases("test_mlflow.TestTrackingURI", (
    tu_prepends_https_when_no_scheme, tu_preserves_https_scheme,
    tu_preserves_http_scheme, tu_non_default_instance_path_segment,
    tu_gateway_lookup_when_no_configured_url,
    tu_configured_url_bypasses_gateway_lookup,
    tu_none_when_no_hostname_determinable)))
CASES["test_extension.pem_validation_drops_bad_base64"] = \
    pem_validation_drops_bad_base64


def _snapshot(s) -> dict:
    return {(o["kind"], s.k8s.namespace(o), s.k8s.name(o)):
            normalise(o, s.side) for o in s.store.all_objects()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_helper_case_through_both_packages(case):
    got, stores, writes = {}, {}, {}
    for s in (Stack("ref"), Stack("port")):
        got[s.side] = CASES[case](s)
        stores[s.side] = _snapshot(s)
        writes[s.side] = s.store._last_rv
    assert got["port"] == got["ref"]
    assert sorted(stores["port"]) == sorted(stores["ref"])
    for key in sorted(stores["ref"]):
        assert stores["port"][key] == stores["ref"][key], key
    assert writes["port"] == writes["ref"]


@pytest.mark.parametrize("given,expected", [
    ("Datascience with Python 3.11", "datascience-with-python-3.11.json"),
    ("A b/c*d (v2)!", "a-b-c-d-v2.json"),
    ("UPPER", "upper.json"),
    ("under_score.keep", "under_score.keep.json"),
    ("--edge--", "edge.json"),
    ("a  +  b", "a-b.json"),
    ("***", ""),
    ("", ""),
])
def test_format_key_name_table(given, expected):
    """tests/test_runtime_images.py's ``TestFormatKeyName`` table on both
    packages."""
    for s in (Stack("ref"), Stack("port")):
        assert s.ext.runtime_images.format_key_name(given) == expected


# ------------------------------------------------------ seeded inputs
_ALPHABET = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJ0123456789 -_./*+()!")


def _text(rng, lo=0, hi=24) -> str:
    return "".join(rng.choice(_ALPHABET, size=int(rng.integers(lo, hi))))


def _pem_blob(rng) -> str:
    """A trust-bundle payload: valid blocks of random bytes, garbage
    lines, blocks whose body is not base64 or is empty, a BEGIN with no
    END, each separated by newlines or nothing."""
    parts = []
    for _ in range(int(rng.integers(0, 6))):
        kind = rng.random()
        body = base64.b64encode(rng.bytes(int(rng.integers(1, 40)))).decode()
        if kind < 0.4:
            wrapped = "\n".join(body[i:i + 16]
                                for i in range(0, len(body), 16))
            parts.append("-----BEGIN CERTIFICATE-----\n" + wrapped +
                         "\n-----END CERTIFICATE-----")
        elif kind < 0.55:
            parts.append("-----BEGIN CERTIFICATE-----\n!!" + body +
                         "\n-----END CERTIFICATE-----")
        elif kind < 0.65:
            parts.append("-----BEGIN CERTIFICATE-----\n\n"
                         "-----END CERTIFICATE-----")
        elif kind < 0.75:
            parts.append("-----BEGIN CERTIFICATE-----\n" + body)
        else:
            parts.append(_text(rng, 0, 30))
    return "".join(str(rng.choice(["\n", "", " \n"])) + p for p in parts)


def test_pem_blocks_match_the_reference_on_seeded_blobs():
    """``extract_valid_pem_blocks`` of both packages on 400 blobs drawn
    from one seed, and ``build_workbench_bundle`` on three sources made
    of them: the same blocks, the same bundle."""
    from kubeflow_tpu.controllers import cacert as ref_cacert
    from kubeflow_tpu_torch.controllers import cacert
    rng = np.random.default_rng(SEED)
    counts = set()
    for _ in range(400):
        blob = _pem_blob(rng)
        want = ref_cacert.extract_valid_pem_blocks(blob)
        assert cacert.extract_valid_pem_blocks(blob) == want, blob
        counts.add(len(want))
    assert len(counts) >= 4      # the draw reaches several block counts
    for _ in range(30):
        bundles = []
        sources = [_pem_blob(rng) for _ in range(3)]
        for s in (Stack("ref"), Stack("port")):
            ca = s.ext.cacert
            for (name, ns, key), data in zip(
                    ((ca.TRUSTED_CA_BUNDLE, CENTRAL, "ca-bundle.crt"),
                     (ca.KUBE_ROOT_CA, NS, "ca.crt"),
                     (ca.SERVICE_CA, NS, "service-ca.crt")),
                    sources):
                s.store.create({"kind": "ConfigMap", "apiVersion": "v1",
                                "metadata": {"name": name, "namespace": ns},
                                "data": {key: data}})
            bundles.append(ca.build_workbench_bundle(s.store, CENTRAL, NS))
        assert bundles[1] == bundles[0]


def _metadata(rng) -> str | None:
    """A runtime-image metadata annotation: absent, not JSON, not an
    array, an empty array, or an array of entries with or without a
    display name and a metadata object."""
    roll = rng.random()
    if roll < 0.1:
        return None
    if roll < 0.2:
        return "{" + _text(rng)
    if roll < 0.3:
        return json.dumps({"display_name": _text(rng, 1)})
    entries = []
    for _ in range(int(rng.integers(0, 3))):
        e = {}
        if rng.random() < 0.85:
            e["display_name"] = _text(rng) if rng.random() < 0.9 else 7
        meta = rng.random()
        if meta < 0.6:
            e["metadata"] = {"tags": [_text(rng, 1, 6)]}
        elif meta < 0.7:
            e["metadata"] = _text(rng)
        entries.append(e)
    return json.dumps(entries)


def test_runtime_images_match_the_reference_on_seeded_streams():
    """``format_key_name`` and ``parse_runtime_image_metadata`` of both
    packages on 400 drawn display names and annotations, then
    ``sync_runtime_images_config_map`` over 40 drawn ImageStream
    inventories (labelled or not, tags with and without an image or
    metadata): the same keys, entries and ConfigMap."""
    from kubeflow_tpu.controllers import runtime_images as ref_ri
    from kubeflow_tpu_torch.controllers import runtime_images as ri
    rng = np.random.default_rng(SEED)
    for _ in range(400):
        name = _text(rng)
        assert ri.format_key_name(name) == ref_ri.format_key_name(name)
        raw = _metadata(rng) or "[]"
        assert ri.parse_runtime_image_metadata(raw, "img") == \
            ref_ri.parse_runtime_image_metadata(raw, "img")
    keys = 0
    for i in range(40):
        state = rng.bit_generator.state
        snapshots = []
        for s in (Stack("ref"), Stack("port")):
            rng.bit_generator.state = state
            for j in range(int(rng.integers(0, 4))):
                tags = []
                for k in range(int(rng.integers(0, 4))):
                    t = {"name": f"t{k}"}
                    if rng.random() < 0.9:
                        t["from"] = {"kind": "DockerImage",
                                     "name": f"quay.io/o/i{j}{k}@sha256:1"}
                    meta = _metadata(rng)
                    if meta is not None:
                        t["annotations"] = {
                            s.ext.runtime_images.METADATA_ANNOTATION: meta}
                    tags.append(t)
                s.store.create(stream(s, name=f"s{j}", tags=tags,
                                      labeled=rng.random() < 0.8))
            s.ext.runtime_images.sync_runtime_images_config_map(
                s.store, CENTRAL, NS)
            snapshots.append(_snapshot(s))
        assert snapshots[1] == snapshots[0], i
        keys += len(snapshots[0])
    assert keys > 40     # some inventories project a ConfigMap


_DSPA_PATHS = [("objectStorage",), ("objectStorage", "externalStorage"),
               ("objectStorage", "externalStorage", "host"),
               ("objectStorage", "externalStorage", "bucket"),
               ("objectStorage", "externalStorage", "scheme"),
               ("objectStorage", "externalStorage", "s3CredentialsSecret"),
               ("objectStorage", "externalStorage", "s3CredentialsSecret",
                "secretName"),
               ("objectStorage", "externalStorage", "s3CredentialsSecret",
                "accessKey"),
               ("objectStorage", "externalStorage", "s3CredentialsSecret",
                "secretKey")]


_DSPA_OBJECTS = ("objectStorage", "externalStorage", "s3CredentialsSecret")


def _drawn_dspa(rng) -> dict:
    d = dspa()
    if rng.random() < 0.5:
        d["status"] = {"components": {"apiServer": {
            "externalUrl": str(rng.choice(["", "https://p.example.com/x"]))
        }}}
    for _ in range(int(rng.integers(0, 3))):
        path = _DSPA_PATHS[int(rng.integers(0, len(_DSPA_PATHS)))]
        node = d["spec"]
        for key in path[:-1]:
            node = node.get(key)
            if not isinstance(node, dict):
                break
        else:
            op = rng.random()
            if op < 0.4:
                node.pop(path[-1], None)
            elif path[-1] in _DSPA_OBJECTS:
                node[path[-1]] = {}
            elif op < 0.7:
                node[path[-1]] = ""
            else:
                node[path[-1]] = "http" if path[-1] == "scheme" else \
                    _text(rng, 1, 8)
    return d


def test_dspa_extraction_matches_the_reference_on_seeded_specs():
    """``extract_runtime_config`` and ``sync_elyra_runtime_secret`` of
    both packages on 200 DSPA specs drawn from one seed (fields dropped,
    emptied or rewritten; a status endpoint or none; a gateway hostname
    or none; a COS secret with both keys, one, or none): the same
    runtime config or the same IncompleteDSPAError message, and the
    same Secret."""
    rng = np.random.default_rng(SEED)
    outcomes = set()
    for i in range(200):
        state = rng.bit_generator.state
        results = []
        for s in (Stack("ref"), Stack("port")):
            rng.bit_generator.state = state
            d = s.store.create(_drawn_dspa(rng))
            secret = rng.random()
            if secret < 0.7:
                s.store.create(cos_secret())
            elif secret < 0.85:
                s.store.create(cos_secret(
                    data={"AWS_ACCESS_KEY_ID": b64("u")}))
            if rng.random() < 0.5:
                s.store.create(gateway(listeners=[{"hostname":
                                                   "gw.example.com"}]))
            try:
                out = ("ok", extract(s, d))
            except s.ext.elyra.IncompleteDSPAError as exc:
                out = ("error", str(exc))
            synced = sync_secret(s)
            results.append((out, synced, _snapshot(s)))
        assert results[1] == results[0], i
        outcomes.add(results[0][0][0])
    assert outcomes == {"ok", "error"}


def test_route_names_match_the_reference_on_seeded_names():
    """``route_name_for_notebook`` and ``new_httproute`` of both
    packages on 300 (namespace, name) pairs drawn around the 63-character
    limit, auth on and off; each route created in its side's store gets
    the same name, the generateName suffix included."""
    from kubeflow_tpu.utils import names as ref_names
    from kubeflow_tpu_torch.utils import names
    assert names.MAX_ROUTE_NAME_LENGTH == ref_names.MAX_ROUTE_NAME_LENGTH
    rng = np.random.default_rng(SEED)
    letters = list("abcdefghijklmnopqrstuvwxyz0123456789-")
    stacks = (Stack("ref"), Stack("port"))
    generated = 0
    for i in range(300):
        ns = "n" + "".join(rng.choice(letters,
                                      size=int(rng.integers(10, 45))))
        nb_name = "b" + "".join(rng.choice(letters,
                                           size=int(rng.integers(10, 45))))
        want = ref_names.route_name_for_notebook(ns, nb_name)
        assert names.route_name_for_notebook(ns, nb_name) == want
        generated += want[1]
        auth = bool(rng.integers(0, 2))
        made = []
        for s in stacks:
            nb = s.api.new_notebook(nb_name, ns)
            route = s.ext.routes.new_httproute(nb, s.Config(), auth=auth)
            made.append((route, s.k8s.name(s.store.create(route))))
        assert made[1] == made[0]
        assert len(made[0][1]) <= 63
    assert 50 < generated < 250
