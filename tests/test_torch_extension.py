"""The port's extension reconciler held against the reference's, case for
case, through both packages' whole control planes.

Every case of tests/test_extension.py but the PEM one (a function of one
module: tests/test_torch_extension_helpers.py holds it), all 23 of
tests/test_extension_matrix.py and all 5 of tests/test_notebook_update.py
run on each side's entry point (``torch_parity.Stack.entry_point``),
each with the case's own assertions. Twenty of the matrix cases and
those of tests/test_extension.py run without the admission webhooks: the
reference's ``setup_controllers(store, config, webhooks=False)`` and the
port's ``build_manager(store, config, components="all")``. The
reference's tests run with the mutating webhook, which puts the
reconciliation lock (the stop annotation with
``RECONCILIATION_LOCK_VALUE``) on every created Notebook; there no
webhook runs, so each case writes the lock on the CR it creates, on both
sides, and the unlock path runs in every case as in the reference's.
The CA-bundle mount lifecycle, the two MLflow admission-denial cases and
the update cases run with the webhooks, as the reference's do:
``setup_controllers(store, config)`` against ``build_manager(store,
config, components="all", webhooks=True)``; there the webhook writes the
lock. The two write-path cases of tests/test_notebook_update.py run the
core alone with no webhooks on both sides
(``setup_controllers(extension=False, webhooks=False,
cached_reads=False)`` against ``build_manager(components="core")``),
each over a client that records the StatefulSet and Service writes.

At the points each case marks and at its end, every object of both
stores is compared after ``normalise`` (cluster-scoped
ClusterRoleBindings, the HTTPRoutes in the controller namespace and
their generateName suffixes among them), and so are the writes since the
stack was built and the reconciles of every drain. No timed requeue runs
in a drain (the MLflow 30 s requeue stays pending on both sides), no
case sleeps and no manager is started.
"""

from __future__ import annotations

import pytest

from torch_parity import Stack, normalise

CENTRAL = "kubeflow-tpu-system"
LONG_NS = "a-rather-long-user-namespace-name-for-testing"
# structurally valid PEM block (base64 "certificate-bytes")
PEM = ("-----BEGIN CERTIFICATE-----\nY2VydGlmaWNhdGUtYnl0ZXM=\n"
       "-----END CERTIFICATE-----")


# ------------------------------------------------------------- the worlds
def world(s, webhooks=False, **config) -> None:
    """The reference's ``world`` fixture on stack ``s``: the side's entry
    point on a config with the controller namespace set, with the
    admission webhooks or without."""
    s.config = s.Config(controller_namespace=CENTRAL, **config)
    s.entry_point(webhooks=webhooks)
    s.webhooks = webhooks


def matrix_world(s, webhooks=False) -> None:
    """tests/test_extension_matrix.py's ``world``: MLflow on, a static
    gateway URL."""
    world(s, webhooks=webhooks, mlflow_enabled=True,
          gateway_url="gw.example.com")


def create_nb(s, name="nb", ns="user-ns", annotations=None, **kw) -> dict:
    """Create a Notebook, locked as the reference's webhook locks it (by
    the webhook when the world has one), and drain."""
    anns = {} if s.webhooks else \
        {s.names.STOP_ANNOTATION: s.names.RECONCILIATION_LOCK_VALUE}
    anns.update(annotations or {})
    s.store.create(s.api.new_notebook(name, ns, annotations=anns or None,
                                      **kw))
    s.drain()
    return s.store.get(s.api.KIND, ns, name)


def set_auth(s, value, name="nb", ns="user-ns") -> dict:
    s.store.patch(s.api.KIND, ns, name, {"metadata": {"annotations": {
        s.names.INJECT_AUTH_ANNOTATION: value}}})
    s.drain()
    return s.store.get(s.api.KIND, ns, name)


def route_of(s, nb) -> dict:
    found = s.ext.routes.find_routes(s.store, s.config, nb)
    assert len(found) == 1, f"expected exactly one route, got {len(found)}"
    return found[0]


def touch(s, value="1", name="nb", ns="user-ns") -> None:
    s.store.patch(s.api.KIND, ns, name,
                  {"metadata": {"labels": {"touch": value}}})
    s.drain()


def enqueue(s, name="nb", ns="user-ns") -> None:
    s.manager.enqueue("extension-controller", s.Request(ns, name))
    s.drain()


def cluster_role(s) -> None:
    s.store.create({"kind": "ClusterRole",
                    "apiVersion": "rbac.authorization.k8s.io/v1",
                    "metadata": {"name": s.ext.rbac.MLFLOW_CLUSTER_ROLE}})


def backend(route) -> dict:
    return route["spec"]["rules"][0]["backendRefs"][0]


def mark(s, label: str) -> None:
    """A comparison point: the objects, the writes since the stack was
    built and the reconciles of each drain so far."""
    s.marks.append((label, {
        (o["kind"], s.k8s.namespace(o), s.k8s.name(o)): normalise(o, s.side)
        for o in s.store.all_objects()},
        s.store._last_rv - s.base, list(s.drains)))


# ------------------------------------------- tests/test_extension.py
def full_provisioning_loop(s):
    world(s)
    nb = create_nb(s)
    k8s, names, routes = s.k8s, s.names, s.ext.routes
    assert k8s.get_annotation(nb, names.STOP_ANNOTATION) is None
    assert s.store.get("StatefulSet", "user-ns", "nb")["spec"][
        "replicas"] == 1
    route = routes.find_routes(s.store, s.config, nb)[0]
    assert k8s.namespace(route) == CENTRAL
    assert route["spec"]["rules"][0]["matches"][0]["path"]["value"] == \
        "/notebook/user-ns/nb"
    assert backend(route) == {"kind": "Service", "namespace": "user-ns",
                              "name": "nb", "port": 80}
    assert s.store.get("ReferenceGrant", "user-ns",
                       routes.REFERENCE_GRANT_NAME)
    assert s.store.get("NetworkPolicy", "user-ns", "nb-ctrl-np")
    assert k8s.has_finalizer(nb, s.ext.extension.FINALIZER_ROUTES)
    assert k8s.has_finalizer(nb, s.ext.extension.FINALIZER_REFGRANT)
    return {"route": k8s.name(route)}


def auth_mode_provisions_proxy_resources(s):
    world(s)
    auth = s.ext.auth
    nb = create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    assert s.store.get("ServiceAccount", "user-ns", auth.sa_name("nb"))
    assert s.store.get("ConfigMap", "user-ns", auth.rbac_config_name("nb"))
    tls_svc = s.store.get("Service", "user-ns", auth.tls_service_name("nb"))
    assert tls_svc["spec"]["ports"][0]["targetPort"] == 8443
    assert s.store.get("ClusterRoleBinding", "",
                       auth.crb_name("user-ns", "nb"))
    assert backend(s.ext.routes.find_routes(s.store, s.config, nb)[0])[
        "port"] == 443
    assert s.k8s.has_finalizer(nb, s.ext.extension.FINALIZER_CRB)
    return {}


def auth_mode_switch_replaces_route_and_cleans_up(s):
    world(s)
    auth = s.ext.auth
    create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    mark(s, "auth")
    nb = set_auth(s, "false")
    all_routes = s.ext.routes.find_routes(s.store, s.config, nb)
    assert len(all_routes) == 1
    assert backend(all_routes[0])["port"] == 80
    assert s.store.get_or_none("ServiceAccount", "user-ns",
                               auth.sa_name("nb")) is None
    assert s.store.get_or_none("ClusterRoleBinding", "",
                               auth.crb_name("user-ns", "nb")) is None
    return {}


def deletion_cleans_cross_namespace_resources(s):
    world(s)
    create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    mark(s, "provisioned")
    s.store.delete(s.api.KIND, "user-ns", "nb")
    s.drain()
    assert s.store.get_or_none(s.api.KIND, "user-ns", "nb") is None
    assert s.store.list("HTTPRoute", CENTRAL) == []
    assert s.store.get_or_none("ReferenceGrant", "user-ns",
                               s.ext.routes.REFERENCE_GRANT_NAME) is None
    assert s.store.get_or_none("ClusterRoleBinding", "",
                               s.ext.auth.crb_name("user-ns", "nb")) is None
    assert s.store.get_or_none("StatefulSet", "user-ns", "nb") is None
    return {}


def reference_grant_shared_until_last_notebook(s):
    world(s)
    grant = s.ext.routes.REFERENCE_GRANT_NAME
    create_nb(s, name="nb1")
    create_nb(s, name="nb2")
    s.store.delete(s.api.KIND, "user-ns", "nb1")
    s.drain()
    assert s.store.get("ReferenceGrant", "user-ns", grant)
    mark(s, "one left")
    s.store.delete(s.api.KIND, "user-ns", "nb2")
    s.drain()
    assert s.store.get_or_none("ReferenceGrant", "user-ns", grant) is None
    return {}


def route_recreated_on_delete(s):
    world(s)
    nb = create_nb(s)
    route = s.ext.routes.find_routes(s.store, s.config, nb)[0]
    s.store.delete("HTTPRoute", CENTRAL, s.k8s.name(route))
    s.drain()
    assert len(s.ext.routes.find_routes(s.store, s.config, nb)) == 1
    return {}


def extension_route_drift_repaired(s):
    world(s)
    nb = create_nb(s)
    route = s.ext.routes.find_routes(s.store, s.config, nb)[0]
    route["spec"]["rules"][0]["matches"][0]["path"]["value"] = "/hacked"
    s.store.update(route)
    s.drain()
    route = s.ext.routes.find_routes(s.store, s.config, nb)[0]
    assert route["spec"]["rules"][0]["matches"][0]["path"]["value"] == \
        "/notebook/user-ns/nb"
    return {}


def ca_bundle_merged_into_user_namespace(s):
    world(s)
    pem = ("-----BEGIN CERTIFICATE-----\nZmFrZWNlcnQ=\n"
           "-----END CERTIFICATE-----")
    s.store.create({"apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"name": "odh-trusted-ca-bundle",
                                 "namespace": CENTRAL},
                    "data": {"ca-bundle.crt": pem + "\ngarbage-not-pem"}})
    create_nb(s)
    bundle = s.store.get("ConfigMap", "user-ns", s.ext.cacert.WORKBENCH_BUNDLE)
    assert pem in bundle["data"]["ca-bundle.crt"]
    assert "garbage" not in bundle["data"]["ca-bundle.crt"]
    return {"bundle": bundle["data"]}


def pipeline_rbac_gated_and_role_precheck(s):
    world(s, set_pipeline_rbac=True)
    create_nb(s)
    assert s.store.get_or_none("RoleBinding", "user-ns",
                               "elyra-pipelines-nb") is None
    mark(s, "no role")
    s.store.create({"apiVersion": "rbac.authorization.k8s.io/v1",
                    "kind": "Role",
                    "metadata": {"name": "ds-pipeline-user-access-dspa",
                                 "namespace": "user-ns"}})
    enqueue(s)
    assert s.store.get("RoleBinding", "user-ns", "elyra-pipelines-nb")
    return {}


def mlflow_requeues_until_clusterrole_exists(s):
    world(s, mlflow_enabled=True, gateway_url="gw")
    create_nb(s, annotations={s.names.MLFLOW_INSTANCE_ANNOTATION: "exp-1"})
    assert s.store.get_or_none("RoleBinding", "user-ns",
                               "mlflow-access-nb") is None
    mark(s, "pending")
    cluster_role(s)
    enqueue(s)
    assert s.store.get("RoleBinding", "user-ns", "mlflow-access-nb")
    return {}


def lock_strict_mode_waits_for_pull_secret(s):
    world(s, lock_requires_pull_secret=True)
    k8s, names = s.k8s, s.names
    nb = create_nb(s)
    assert k8s.get_annotation(nb, names.STOP_ANNOTATION) == \
        names.RECONCILIATION_LOCK_VALUE
    assert s.store.get("StatefulSet", "user-ns", "nb")["spec"][
        "replicas"] == 0
    mark(s, "locked")
    s.store.create({"apiVersion": "v1", "kind": "ServiceAccount",
                    "metadata": {"name": "default", "namespace": "user-ns"},
                    "imagePullSecrets": [{"name": "default-dockercfg"}]})
    enqueue(s)
    nb = s.store.get(s.api.KIND, "user-ns", "nb")
    assert k8s.get_annotation(nb, names.STOP_ANNOTATION) is None
    assert s.store.get("StatefulSet", "user-ns", "nb")["spec"][
        "replicas"] == 1
    return {}


def runtime_images_synced_to_user_namespace(s):
    world(s)
    s.store.create({
        "apiVersion": "image.openshift.io/v1", "kind": "ImageStream",
        "metadata": {"name": "datascience-runtime", "namespace": CENTRAL,
                     "labels": {"opendatahub.io/runtime-image": "true"}},
        "spec": {"tags": [{
            "name": "2024a",
            "from": {"kind": "DockerImage",
                     "name": "quay.io/org/spark@sha256:def"},
            "annotations": {"opendatahub.io/runtime-image-metadata":
                            '[{"display_name": "Datascience with Spark"}]'},
        }]},
    })
    create_nb(s)
    cm = s.store.get("ConfigMap", "user-ns", "pipeline-runtime-images")
    assert "datascience-with-spark.json" in cm["data"]
    return {"data": cm["data"]}


# ------------------------------------ tests/test_extension_matrix.py
def switch_plain_to_auth_full_resource_set(s):
    matrix_world(s)
    auth, k8s = s.ext.auth, s.k8s
    nb = create_nb(s)
    assert backend(route_of(s, nb))["port"] == 80
    mark(s, "plain")
    nb = set_auth(s, "true")
    route = route_of(s, nb)
    assert backend(route) == {"kind": "Service", "namespace": "user-ns",
                              "name": auth.tls_service_name("nb"),
                              "port": 443}
    assert k8s.get_label(route, "notebook-auth") == "true"
    assert s.store.get("ServiceAccount", "user-ns", auth.sa_name("nb"))
    assert s.store.get("ConfigMap", "user-ns", auth.rbac_config_name("nb"))
    assert s.store.get("Service", "user-ns", auth.tls_service_name("nb"))
    assert s.store.get("ClusterRoleBinding", "",
                       auth.crb_name("user-ns", "nb"))
    assert k8s.has_finalizer(nb, s.ext.extension.FINALIZER_CRB)
    return {}


def switch_auth_to_plain_removes_all_auth_resources(s):
    matrix_world(s)
    auth = s.ext.auth
    create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    mark(s, "auth")
    nb = set_auth(s, "false")
    route = route_of(s, nb)
    assert backend(route)["port"] == 80
    assert s.k8s.get_label(route, "notebook-auth") == "false"
    for kind, ns, name in [
            ("ServiceAccount", "user-ns", auth.sa_name("nb")),
            ("ConfigMap", "user-ns", auth.rbac_config_name("nb")),
            ("Service", "user-ns", auth.tls_service_name("nb")),
            ("ClusterRoleBinding", "", auth.crb_name("user-ns", "nb"))]:
        assert s.store.get_or_none(kind, ns, name) is None, f"{kind} {name}"
    return {}


def switch_flip_flop_converges_with_single_route(s):
    matrix_world(s)
    create_nb(s)
    for mode in ("true", "false", "true", "false"):
        nb = set_auth(s, mode)
        route = route_of(s, nb)
        assert s.k8s.get_label(route, "notebook-auth") == mode
        mark(s, f"auth {mode}")
    assert s.store.get_or_none("ClusterRoleBinding", "", s.ext.auth.crb_name(
        "user-ns", "nb")) is None
    return {}


def conflicting_route_of_other_mode_deleted_even_if_manually_created(s):
    matrix_world(s)
    nb = create_nb(s)
    rogue = s.ext.routes.new_httproute(nb, s.config, auth=True)
    rogue["metadata"]["name"] = "rogue-auth-route"
    rogue["metadata"].pop("generateName", None)
    s.store.create(rogue)
    touch(s)
    remaining = s.ext.routes.find_routes(s.store, s.config, nb)
    assert len(remaining) == 1
    assert s.k8s.get_label(remaining[0], "notebook-auth") == "false"
    return {}


def matrix_route_drift_repaired(s):
    matrix_world(s)
    nb = create_nb(s)
    route = route_of(s, nb)
    route["spec"]["rules"][0]["matches"][0]["path"]["value"] = "/hijacked"
    s.store.update(route)
    s.drain()
    assert route_of(s, nb)["spec"]["rules"][0]["matches"][0]["path"][
        "value"] == "/notebook/user-ns/nb"
    return {}


def long_names_use_generate_name_fallback(s):
    matrix_world(s)
    long_name = "notebook-with-a-very-long-name-indeed"
    assert len(f"nb-{LONG_NS}-{long_name}") > 63
    nb = create_nb(s, name=long_name, ns=LONG_NS)
    route = route_of(s, nb)
    assert len(s.k8s.name(route)) <= 63
    assert s.k8s.name(route).startswith("nb-")
    mark(s, "generated")
    touch(s, name=long_name, ns=LONG_NS)
    assert len(s.ext.routes.find_routes(s.store, s.config, nb)) == 1
    return {"route": s.k8s.name(route)}


def two_long_named_notebooks_with_same_prefix_get_distinct_routes(s):
    matrix_world(s)
    names, routes = s.names, s.ext.routes
    name_a = "experiment-alpha-notebook-with-very-long-name"
    name_b = "experiment-betaa-notebook-with-very-long-name"
    nb_a = create_nb(s, name=name_a, ns=LONG_NS)
    nb_b = create_nb(s, name=name_b, ns=LONG_NS)
    route_a, route_b = route_of(s, nb_a), route_of(s, nb_b)
    assert s.k8s.name(route_a) != s.k8s.name(route_b)
    assert s.k8s.get_label(route_a, names.NOTEBOOK_NAME_LABEL) == name_a
    assert s.k8s.get_label(route_b, names.NOTEBOOK_NAME_LABEL) == name_b
    mark(s, "both")
    s.store.delete(s.api.KIND, LONG_NS, name_a)
    s.drain()
    assert routes.find_routes(s.store, s.config, nb_a) == []
    assert len(routes.find_routes(s.store, s.config, nb_b)) == 1
    return {"routes": [s.k8s.name(route_a), s.k8s.name(route_b)]}


def ca_bundle_merges_user_namespace_sources_and_drops_garbage(s):
    matrix_world(s)
    cacert = s.ext.cacert
    s.store.create({"kind": "ConfigMap", "apiVersion": "v1",
                    "metadata": {"name": cacert.TRUSTED_CA_BUNDLE,
                                 "namespace": CENTRAL},
                    "data": {"ca-bundle.crt":
                             PEM + "\nnot-a-pem-block-at-all"}})
    other_pem = ("-----BEGIN CERTIFICATE-----\nb3RoZXItY2VydC1ieXRlcw==\n"
                 "-----END CERTIFICATE-----")
    s.store.create({"kind": "ConfigMap", "apiVersion": "v1",
                    "metadata": {"name": cacert.KUBE_ROOT_CA,
                                 "namespace": "user-ns"},
                    "data": {"ca.crt": other_pem}})
    s.store.create({"kind": "ConfigMap", "apiVersion": "v1",
                    "metadata": {"name": cacert.SERVICE_CA,
                                 "namespace": "user-ns"},
                    "data": {"service-ca.crt":
                             "-----BEGIN CERTIFICATE-----\n!!!garbage!!!\n"
                             "-----END CERTIFICATE-----"}})
    create_nb(s)
    content = s.store.get("ConfigMap", "user-ns", cacert.WORKBENCH_BUNDLE)[
        "data"]["ca-bundle.crt"]
    assert content.count("BEGIN CERTIFICATE") == 2
    assert "not-a-pem-block" not in content
    return {"content": content}


def mlflow_pending_clusterrole_requeues_then_converges(s):
    matrix_world(s)
    rbac = s.ext.rbac
    create_nb(s, annotations={s.names.MLFLOW_INSTANCE_ANNOTATION:
                              "tracking-1"})
    assert s.store.get_or_none("RoleBinding", "user-ns",
                               rbac.mlflow_rb_name("nb")) is None
    events = s.store.list("Event", "user-ns")
    assert any(e["reason"] == "MLflowClusterRolePending" for e in events)
    mark(s, "pending")
    cluster_role(s)
    touch(s)
    rb = s.store.get("RoleBinding", "user-ns", rbac.mlflow_rb_name("nb"))
    assert rb["roleRef"]["name"] == "mlflow-operator-mlflow-integration"
    return {}


def deleted_auth_sa_is_recreated_by_owns_watch(s):
    matrix_world(s)
    create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    s.store.delete("ServiceAccount", "user-ns", s.ext.auth.sa_name("nb"))
    s.drain()
    assert s.store.get("ServiceAccount", "user-ns", s.ext.auth.sa_name("nb"))
    return {}


def sar_configmap_drift_repaired(s):
    matrix_world(s)
    name = s.ext.auth.rbac_config_name("nb")
    create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    cm = s.store.get("ConfigMap", "user-ns", name)
    original_data = s.k8s.deepcopy(cm["data"])
    cm["data"] = {"nb-rbac-config.yaml": "tampered: true"}
    s.store.update(cm)
    s.drain()
    assert s.store.get("ConfigMap", "user-ns", name)["data"] == original_data
    return {}


def reference_grant_recreated_on_delete(s):
    matrix_world(s)
    grant = s.ext.routes.REFERENCE_GRANT_NAME
    create_nb(s)
    s.store.delete("ReferenceGrant", "user-ns", grant)
    s.drain()
    assert s.store.get("ReferenceGrant", "user-ns", grant)
    return {}


def reference_grant_spec_drift_repaired(s):
    matrix_world(s)
    name = s.ext.routes.REFERENCE_GRANT_NAME
    create_nb(s)
    grant = s.store.get("ReferenceGrant", "user-ns", name)
    grant["spec"]["from"] = [{"group": "evil.example.com",
                              "kind": "HTTPRoute", "namespace": "evil-ns"}]
    s.store.update(grant)
    s.drain()
    grant = s.store.get("ReferenceGrant", "user-ns", name)
    assert grant["spec"]["from"][0]["namespace"] == CENTRAL
    assert grant["spec"]["from"][0]["group"] == "gateway.networking.k8s.io"
    return {}


def reference_grant_label_drift_repaired(s):
    matrix_world(s)
    name = s.ext.routes.REFERENCE_GRANT_NAME
    create_nb(s)
    grant = s.store.get("ReferenceGrant", "user-ns", name)
    labels_before = s.k8s.deepcopy(
        s.k8s.get_in(grant, "metadata", "labels", default={}))
    grant["metadata"]["labels"] = {}
    s.store.update(grant)
    s.drain()
    grant = s.store.get("ReferenceGrant", "user-ns", name)
    assert s.k8s.get_in(grant, "metadata", "labels", default={}) == \
        labels_before
    return {}


def network_policies_recreated_on_delete(s):
    matrix_world(s)
    netpol = s.ext.netpol
    create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    s.store.delete("NetworkPolicy", "user-ns",
                   netpol.notebook_policy_name("nb"))
    s.store.delete("NetworkPolicy", "user-ns", netpol.auth_policy_name("nb"))
    s.drain()
    assert s.store.get("NetworkPolicy", "user-ns",
                       netpol.notebook_policy_name("nb"))
    assert s.store.get("NetworkPolicy", "user-ns",
                       netpol.auth_policy_name("nb"))
    return {}


def auth_proxy_service_recreated_and_drift_repaired(s):
    matrix_world(s)
    create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    svc_name = s.ext.auth.tls_service_name("nb")
    s.store.delete("Service", "user-ns", svc_name)
    s.drain()
    svc = s.store.get("Service", "user-ns", svc_name)
    assert svc["metadata"]["annotations"][
        "service.beta.openshift.io/serving-cert-secret-name"]
    mark(s, "recreated")
    svc["spec"]["ports"] = [{"name": "https", "port": 9999,
                             "targetPort": 9999}]
    s.store.update(svc)
    s.drain()
    svc = s.store.get("Service", "user-ns", svc_name)
    assert svc["spec"]["ports"][0]["port"] == 443
    assert svc["spec"]["ports"][0]["targetPort"] == 8443
    return {}


def auth_route_reconciled_and_recreated(s):
    matrix_world(s)
    nb = create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    route = route_of(s, nb)
    assert backend(route)["name"] == s.ext.auth.tls_service_name("nb")
    assert backend(route)["port"] == 443
    route["spec"]["rules"][0]["backendRefs"][0]["port"] = 80
    s.store.update(route)
    s.drain()
    assert backend(route_of(s, nb))["port"] == 443
    mark(s, "repaired")
    s.store.delete("HTTPRoute", CENTRAL, s.k8s.name(route))
    s.drain()
    assert backend(route_of(s, nb))["port"] == 443
    return {}


def sar_configmap_recreated_on_delete(s):
    matrix_world(s)
    name = s.ext.auth.rbac_config_name("nb")
    create_nb(s, annotations={s.names.INJECT_AUTH_ANNOTATION: "true"})
    s.store.delete("ConfigMap", "user-ns", name)
    s.drain()
    assert s.store.get("ConfigMap", "user-ns", name)
    return {}


def reconciliation_lock_removed_after_provisioning(s):
    matrix_world(s)
    nb = create_nb(s)
    assert s.k8s.get_annotation(nb, s.names.STOP_ANNOTATION) is None
    assert s.store.get("StatefulSet", "user-ns", "nb")["spec"][
        "replicas"] == 1
    return {}


def pipeline_rolebinding_gc_with_notebook(s):
    matrix_world(s)
    rbac = s.ext.rbac
    # a second control plane on the same store, pipeline RBAC on
    world(s, set_pipeline_rbac=True)
    s.store.create({"kind": "Role",
                    "apiVersion": "rbac.authorization.k8s.io/v1",
                    "metadata": {"name": rbac.PIPELINE_ROLE,
                                 "namespace": "user-ns"}})
    create_nb(s)
    assert s.store.get("RoleBinding", "user-ns", rbac.pipeline_rb_name("nb"))
    mark(s, "bound")
    s.store.delete(s.api.KIND, "user-ns", "nb")
    s.drain()
    assert s.store.get_or_none("RoleBinding", "user-ns",
                               rbac.pipeline_rb_name("nb")) is None
    return {}


# ------------------- tests/test_extension_matrix.py, with the webhooks
def ca_bundle_full_lifecycle_source_appears_then_disappears(s):
    matrix_world(s, webhooks=True)
    cacert, k8s, names = s.ext.cacert, s.k8s, s.names
    create_nb(s)
    assert s.store.get_or_none("ConfigMap", "user-ns",
                               cacert.WORKBENCH_BUNDLE) is None
    s.store.create({"kind": "ConfigMap", "apiVersion": "v1",
                    "metadata": {"name": cacert.TRUSTED_CA_BUNDLE,
                                 "namespace": CENTRAL},
                    "data": {"ca-bundle.crt": PEM}})
    s.drain()
    bundle = s.store.get("ConfigMap", "user-ns", cacert.WORKBENCH_BUNDLE)
    assert PEM in bundle["data"]["ca-bundle.crt"]
    mark(s, "bundle")
    touch(s, "1")
    nb = s.store.get(s.api.KIND, "user-ns", "nb")
    assert k8s.get_annotation(nb, names.UPDATE_PENDING_ANNOTATION)
    assert "REQUESTS_CA_BUNDLE" not in k8s.env_list_to_dict(
        s.api.notebook_container(nb).get("env", []))
    mark(s, "parked")
    s.store.patch(s.api.KIND, "user-ns", "nb", {"metadata": {"annotations": {
        names.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}}})
    s.drain()
    nb = s.store.get(s.api.KIND, "user-ns", "nb")
    env = k8s.env_list_to_dict(s.api.notebook_container(nb).get("env", []))
    assert env["REQUESTS_CA_BUNDLE"].endswith("ca-bundle.crt")
    assert any(v["name"] == "trusted-ca"
               for v in s.api.notebook_pod_spec(nb).get("volumes", []))
    assert k8s.get_annotation(nb, names.UPDATE_PENDING_ANNOTATION) is None
    mark(s, "stopped")
    s.store.delete("ConfigMap", CENTRAL, cacert.TRUSTED_CA_BUNDLE)
    s.drain()
    assert s.store.get_or_none("ConfigMap", "user-ns",
                               cacert.WORKBENCH_BUNDLE) is None
    touch(s, "2")
    nb = s.store.get(s.api.KIND, "user-ns", "nb")
    assert "REQUESTS_CA_BUNDLE" not in k8s.env_list_to_dict(
        s.api.notebook_container(nb).get("env", []))
    assert not any(v["name"] == "trusted-ca"
                   for v in s.api.notebook_pod_spec(nb).get("volumes", []))
    return {}


def mlflow_annotation_removal_denied_only_while_running(s):
    matrix_world(s, webhooks=True)
    ann = s.names.MLFLOW_INSTANCE_ANNOTATION
    cluster_role(s)
    nb = create_nb(s, annotations={ann: "tracking-1"})
    assert s.k8s.get_annotation(nb, s.names.STOP_ANNOTATION) is None
    with pytest.raises(s.wh.AdmissionDenied) as exc:
        s.store.patch(s.api.KIND, "user-ns", "nb", {"metadata": {
            "annotations": {ann: None}}})
    mark(s, "denied")
    s.store.patch(s.api.KIND, "user-ns", "nb", {"metadata": {"annotations": {
        s.names.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}}})
    s.store.patch(s.api.KIND, "user-ns", "nb", {"metadata": {
        "annotations": {ann: None}}})
    s.drain()
    assert s.store.get_or_none("RoleBinding", "user-ns",
                               s.ext.rbac.mlflow_rb_name("nb")) is None
    return {"denied": (exc.value.code, exc.value.message)}


def mlflow_guard_under_stale_writer(s):
    matrix_world(s, webhooks=True)
    ann = s.names.MLFLOW_INSTANCE_ANNOTATION
    cluster_role(s)
    create_nb(s, annotations={ann: "tracking-1"})
    stale = s.store.get(s.api.KIND, "user-ns", "nb")
    s.store.patch(s.api.KIND, "user-ns", "nb",
                  {"metadata": {"labels": {"touch": "1"}}})
    s.k8s.remove_annotation(stale, ann)
    with pytest.raises(s.errors.ConflictError):
        s.store.update(stale)
    fresh = s.store.get(s.api.KIND, "user-ns", "nb")
    s.k8s.remove_annotation(fresh, ann)
    with pytest.raises(s.wh.AdmissionDenied) as exc:
        s.store.update(fresh)
    s.drain()
    return {"denied": (exc.value.code, exc.value.message)}


# ------------------------------------ tests/test_notebook_update.py
def update_world(s) -> None:
    """tests/test_notebook_update.py's ``world``: the whole control plane
    with the webhooks."""
    world(s, webhooks=True)


def spec_update_propagates_to_statefulset(s):
    update_world(s)
    create_nb(s, image="jupyter:2024a")
    nb = s.store.get(s.api.KIND, "user-ns", "nb")
    s.api.notebook_container(nb)["image"] = "jupyter:2024b"
    s.api.notebook_pod_spec(nb)["containers"][0].setdefault(
        "env", []).append({"name": "NEW_VAR", "value": "yes"})
    s.store.update(nb)
    s.drain()
    sts = s.store.get("StatefulSet", "user-ns", "nb")
    c = s.k8s.get_in(sts, "spec", "template", "spec", "containers")[0]
    assert c["image"] == "jupyter:2024b"
    assert {"name": "NEW_VAR", "value": "yes"} in c["env"]
    return {}


def replica_edit_on_sts_repaired_slice_atomically(s):
    update_world(s)
    create_nb(s, annotations={s.names.TPU_ACCELERATOR_ANNOTATION:
                              s.accelerator("v5e-16")})
    sts = s.store.get("StatefulSet", "user-ns", "nb")
    assert sts["spec"]["replicas"] == 4
    sts["spec"]["replicas"] = 2
    s.store.update(sts)
    s.drain()
    assert s.store.get("StatefulSet", "user-ns", "nb")["spec"][
        "replicas"] == 4
    return {}


def trusted_ca_mounted_on_update_when_source_appears_later(s):
    update_world(s)
    cacert = s.ext.cacert
    create_nb(s)
    s.store.patch(s.api.KIND, "user-ns", "nb", {"metadata": {"annotations": {
        s.names.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}}})
    s.drain()
    nb = s.store.get(s.api.KIND, "user-ns", "nb")
    assert not any(v.get("name") == "trusted-ca"
                   for v in s.api.notebook_pod_spec(nb).get("volumes", []))
    s.store.create({"kind": "ConfigMap", "apiVersion": "v1",
                    "metadata": {"name": cacert.TRUSTED_CA_BUNDLE,
                                 "namespace": CENTRAL},
                    "data": {"ca-bundle.crt": PEM}})
    touch(s, "1")
    assert s.store.get("ConfigMap", "user-ns", cacert.WORKBENCH_BUNDLE)
    mark(s, "bundle")
    touch(s, "2")
    nb = s.store.get(s.api.KIND, "user-ns", "nb")
    assert any(v.get("name") == "trusted-ca"
               for v in s.api.notebook_pod_spec(nb).get("volumes", []))
    assert any(m.get("mountPath", "").startswith("/etc/pki/tls")
               for m in s.api.notebook_container(nb).get("volumeMounts", []))
    return {}


class WriteRecorder:
    """The side's store, recording every PUT and PATCH the control plane
    sends through it."""

    def __init__(self, store):
        self._store = store
        self.updates: list = []
        self.patches: list = []

    def update(self, obj):
        self.updates.append(obj["kind"])
        return self._store.update(obj)

    def patch(self, kind, namespace, name, patch):
        self.patches.append((kind, namespace, name, patch))
        return self._store.patch(kind, namespace, name, patch)

    def __getattr__(self, name):
        return getattr(self._store, name)


def core_recorded(s) -> WriteRecorder:
    """The core alone over a ``WriteRecorder``: the reference's
    ``setup_controllers(extension=False, webhooks=False,
    cached_reads=False)``, the port's ``build_manager(components="core")``;
    the error count of the notebook reconciler is read from
    ``s.reconcile_errors()``."""
    client = WriteRecorder(s.store)
    if s.side == "ref":
        from kubeflow_tpu.controllers import setup_controllers
        s.manager = setup_controllers(client, s.config, metrics=s.metrics,
                                      extension=False, webhooks=False,
                                      cached_reads=False)
    else:
        from kubeflow_tpu_torch.main import build_manager
        s.manager, _ = build_manager(client, s.config, components="core")
        s.metrics = s.manager.metrics
    s.webhooks = False
    s.base = s.store._last_rv
    s.reconcile_errors = lambda: s.metrics.counter(
        "controller_runtime_reconcile_total", "").get(
        {"controller": "notebook-controller", "result": "error"})
    return client


def statefulset_drift_repair_is_a_minimal_merge_patch(s):
    client = core_recorded(s)
    s.store.create(s.api.new_notebook("nb", "user-ns", image="jupyter:2024a"))
    s.drain()
    nb = s.store.get(s.api.KIND, "user-ns", "nb")
    s.api.notebook_container(nb)["image"] = "jupyter:2024b"
    s.store.update(nb)
    errors_before = s.reconcile_errors()
    client.updates.clear()
    client.patches.clear()
    s.drain()
    sts = s.store.get("StatefulSet", "user-ns", "nb")
    c = s.k8s.get_in(sts, "spec", "template", "spec", "containers")[0]
    assert c["image"] == "jupyter:2024b"
    assert "StatefulSet" not in client.updates
    sts_patches = [p for p in client.patches if p[0] == "StatefulSet"]
    assert sts_patches
    for _, _, _, patch in sts_patches:
        assert set(patch) == {"spec"} and set(patch["spec"]) == {"template"}
        assert "resourceVersion" not in str(patch)
    assert s.reconcile_errors() == errors_before
    return {"patches": sts_patches}


def no_drift_means_no_write(s):
    client = core_recorded(s)
    s.store.create(s.api.new_notebook("nb", "user-ns", image="jupyter:2024a"))
    s.drain()
    client.updates.clear()
    client.patches.clear()
    s.store.patch(s.api.KIND, "user-ns", "nb", {"metadata": {"annotations": {
        "kubectl.kubernetes.io/last-applied-configuration": "{}"}}})
    s.drain()
    assert not {"StatefulSet", "Service"} & set(client.updates)
    assert not [p for p in client.patches
                if p[0] in ("StatefulSet", "Service")]
    return {"patches": client.patches}


CASES = {f"test_extension.{fn.__name__}": fn for fn in (
    full_provisioning_loop,
    auth_mode_provisions_proxy_resources,
    auth_mode_switch_replaces_route_and_cleans_up,
    deletion_cleans_cross_namespace_resources,
    reference_grant_shared_until_last_notebook,
    route_recreated_on_delete,
    extension_route_drift_repaired,
    ca_bundle_merged_into_user_namespace,
    pipeline_rbac_gated_and_role_precheck,
    mlflow_requeues_until_clusterrole_exists,
    lock_strict_mode_waits_for_pull_secret,
    runtime_images_synced_to_user_namespace)}
CASES.update({f"test_extension_matrix.{fn.__name__}": fn for fn in (
    switch_plain_to_auth_full_resource_set,
    switch_auth_to_plain_removes_all_auth_resources,
    switch_flip_flop_converges_with_single_route,
    conflicting_route_of_other_mode_deleted_even_if_manually_created,
    matrix_route_drift_repaired,
    long_names_use_generate_name_fallback,
    two_long_named_notebooks_with_same_prefix_get_distinct_routes,
    ca_bundle_merges_user_namespace_sources_and_drops_garbage,
    mlflow_pending_clusterrole_requeues_then_converges,
    deleted_auth_sa_is_recreated_by_owns_watch,
    sar_configmap_drift_repaired,
    reference_grant_recreated_on_delete,
    reference_grant_spec_drift_repaired,
    reference_grant_label_drift_repaired,
    network_policies_recreated_on_delete,
    auth_proxy_service_recreated_and_drift_repaired,
    auth_route_reconciled_and_recreated,
    sar_configmap_recreated_on_delete,
    reconciliation_lock_removed_after_provisioning,
    pipeline_rolebinding_gc_with_notebook,
    ca_bundle_full_lifecycle_source_appears_then_disappears,
    mlflow_annotation_removal_denied_only_while_running,
    mlflow_guard_under_stale_writer)})
CASES.update({f"test_notebook_update.{fn.__name__}": fn for fn in (
    spec_update_propagates_to_statefulset,
    replica_edit_on_sts_repaired_slice_atomically,
    trusted_ca_mounted_on_update_when_source_appears_later,
    statefulset_drift_repair_is_a_minimal_merge_patch,
    no_drift_means_no_write)})


@pytest.mark.parametrize("case", sorted(CASES))
def test_extension_case_through_both_stacks(case):
    ref, port = Stack("ref"), Stack("port")
    got = {}
    for s in (ref, port):
        s.marks = []
        got[s.side] = CASES[case](s)
        mark(s, "end")
    assert got["port"] == got["ref"]
    assert [m[0] for m in port.marks] == [m[0] for m in ref.marks]
    for (label, want, want_writes, want_drains), \
            (_, have, have_writes, have_drains) in zip(ref.marks,
                                                        port.marks):
        assert sorted(have) == sorted(want), label
        for key in sorted(want):
            assert have[key] == want[key], (label, key)
        assert have_writes == want_writes, label
        assert have_drains == want_drains, label


def test_extension_setup_watches_the_reference_kinds():
    """``setup`` on both packages: the same watches in the same order
    (Notebook, the five owned kinds, HTTPRoute, the CA-source
    ConfigMaps, ReferenceGrant, ImageStream), each dropping the
    reconciler's own echoes, and its client wrapped in an
    ``EchoTrackingClient``; ``CONTRACT`` equal as data."""
    seen = {}
    for s in (Stack("ref"), Stack("port")):
        calls = []
        watch = s.manager.watch

        def recording(kind, controller, _calls=calls, _watch=watch, **kw):
            _calls.append((kind, controller, kw.get("mapper") is not None,
                           kw.get("predicate") is not None))
            return _watch(kind, controller, **kw)
        s.manager.watch = recording
        rec = s.extension()
        seen[s.side] = (calls, type(rec.client).__name__,
                        rec.recorder.component)
    assert seen["port"] == seen["ref"]
    assert [c[0] for c in seen["port"][0]] == [
        "Notebook", "ServiceAccount", "Service", "ConfigMap",
        "NetworkPolicy", "RoleBinding", "HTTPRoute", "ConfigMap",
        "ReferenceGrant", "ImageStream"]
    assert seen["port"][1] == "EchoTrackingClient"
    from kubeflow_tpu.controllers import extension as ref_extension
    from kubeflow_tpu_torch.controllers import extension
    assert extension.CONTRACT == ref_extension.CONTRACT
    assert extension.ALL_FINALIZERS == ref_extension.ALL_FINALIZERS


def test_the_cases_cover_the_reference_files():
    """12 cases of tests/test_extension.py (the PEM one is in
    tests/test_torch_extension_helpers.py), all 23 of
    tests/test_extension_matrix.py and all 5 of
    tests/test_notebook_update.py."""
    counts = {}
    for key in CASES:
        counts[key.split(".")[0]] = counts.get(key.split(".")[0], 0) + 1
    assert counts == {"test_extension": 12, "test_extension_matrix": 23,
                      "test_notebook_update": 5}


def test_admitted_locked_then_unlocked_to_slice_ready():
    """``build_manager(components="all", webhooks=True,
    simulate_kubelet=True)`` against the reference's
    ``setup_controllers`` with its simulator: a Notebook created with no
    lock, an image the side's accelerator cannot drive and auth on is
    stored locked, with the side's accelerator image (the original
    recorded) and the kube-rbac-proxy sidecar; the extension unlocks it
    and it rolls to SliceReady. Every object of both stores is equal
    after ``normalise``, at the create and at the end."""
    from torch_parity import assert_parity
    stacks = (Stack("ref"), Stack("port"))
    stored = {}
    for s in stacks:
        s.config = s.Config(controller_namespace=CENTRAL,
                            tpu_default_image=s.image("default"))
        s.entry_point(simulate_kubelet=True, webhooks=True)
        nb = s.store.create(s.api.new_notebook(
            "wb", "user-ns", image=s.image("foreign"), annotations={
                s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-1"),
                s.names.INJECT_AUTH_ANNOTATION: "true"}))
        assert s.k8s.get_annotation(nb, s.names.STOP_ANNOTATION) == \
            s.names.RECONCILIATION_LOCK_VALUE
        assert s.api.notebook_container(nb)["image"] == s.image("default")
        assert s.k8s.get_annotation(
            nb, s.names.TPU_ORIGINAL_IMAGE_ANNOTATION) == s.image("foreign")
        assert [c["name"] for c in s.api.notebook_pod_spec(nb)[
            "containers"]] == ["wb", "kube-rbac-proxy"]
        stored[s.side] = normalise(nb, s.side)
        s.drain(include_delayed_under=0.1)
        nb = s.store.get(s.api.KIND, "user-ns", "wb")
        assert s.k8s.get_annotation(nb, s.names.STOP_ANNOTATION) is None
        assert s.k8s.condition_true(nb, s.api.CONDITION_SLICE_READY)
        assert s.store.get("StatefulSet", "user-ns", "wb")["spec"][
            "replicas"] == 1
    assert stored["port"] == stored["ref"]
    assert_parity(*stacks)
