"""The port's Notebook CRD, its structural schema and the store's
enforcement of it held against the reference's.

Every case of tests/test_crd_schema.py (each parametrised case on its
own), tests/test_podspec_full_schema.py and tests/test_api_versions.py
runs through each package: its store with its own Notebook CRD installed
(``api.types.install_notebook_crd``), its ``api/schema.py`` and its
typed admission, each side with the case's own assertions; then what
the case returns (the created objects, each rejection's type, code and
message), every object of both stores after ``normalise`` and the writes
are compared.

Then ``validate_schema`` of both packages on 300 pod specs drawn with
numpy from one seed (a valid spec with fields retyped, emptied, dropped
or set to values outside their enum or pattern): the same error list,
and the same outcome of a Notebook create through each store.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

from torch_parity import Stack, normalise, normalise_result

SEED = 20


def cluster(s):
    s.api.install_notebook_crd(s.store)
    return s.store


def nb(pod_spec, name="nb", version="v1", ns="default"):
    return {"kind": "Notebook", "apiVersion": f"kubeflow.org/{version}",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"template": {"spec": pod_spec}}}


def good_pod_spec(**extra):
    spec = {"containers": [{"name": "nb", "image": "img:latest"}]}
    spec.update(extra)
    return spec


def rejected(s, fn, match=None) -> tuple:
    """``fn()`` raises the side's ``InvalidError``; its type, code and
    message."""
    with pytest.raises(s.errors.InvalidError, match=match) as exc:
        fn()
    return type(exc.value).__name__, exc.value.code, exc.value.message


# -------------------------------------------- tests/test_crd_schema.py
def cs_valid_notebook_accepted(s):
    created = cluster(s).create(nb(good_pod_spec(
        nodeSelector={"cloud.google.com/gke-tpu-topology": "2x2"},
        volumes=[{"name": "data",
                  "persistentVolumeClaim": {"claimName": "pvc"}}])))
    assert created["metadata"]["uid"]
    return created


def cs_untyped_pod_spec_fields_flow_through(s):
    spec = good_pod_spec(dnsPolicy="ClusterFirst",
                         hostAliases=[{"ip": "1.2.3.4"}])
    spec["containers"][0]["livenessProbe"] = {"httpGet": {"port": 8888}}
    created = cluster(s).create(nb(spec))
    stored = s.api.notebook_pod_spec(created)
    assert stored["dnsPolicy"] == "ClusterFirst"
    assert stored["containers"][0]["livenessProbe"]
    return created


def cs_resources_with_tpu_quantities_accepted(s):
    spec = good_pod_spec()
    spec["containers"][0]["resources"] = {
        "limits": {"google.com/tpu": "4", "memory": "16Gi", "cpu": "500m"},
        "requests": {"cpu": "1.5", "memory": "2e9"}}
    return cluster(s).create(nb(spec))


MALFORMED = [
    ("image-int", lambda p: p["containers"][0].update(image=5),
     "expected string"),
    ("containers-string", lambda p: p.update(containers="not-a-list"),
     "containers"),
    ("containers-empty", lambda p: p.update(containers=[]), "containers"),
    ("env-no-name", lambda p: p["containers"][0].update(
        env=[{"value": "no-name"}]), "required value"),
    ("port-string", lambda p: p["containers"][0].update(
        ports=[{"containerPort": "8888"}]), "expected integer"),
    ("port-range", lambda p: p["containers"][0].update(
        ports=[{"containerPort": 99999}]), "must be <="),
    ("quantity", lambda p: p["containers"][0].update(
        resources={"limits": {"cpu": "abc"}}), "does not match"),
    ("mount-no-path", lambda p: p["containers"][0].update(
        volumeMounts=[{"name": "x"}]), "mountPath: required"),
    ("restart-policy", lambda p: p.update(restartPolicy="Sometimes"),
     "unsupported value"),
    ("container-name", lambda p: p["containers"][0].update(name="Bad_Name"),
     "does not match"),
    ("volume-no-name", lambda p: p.update(volumes=[{
        "persistentVolumeClaim": {"claimName": "p"}}]), "name: required"),
]


def _cs_malformed(label, mutate, fragment):
    def case(s):
        spec = good_pod_spec()
        mutate(spec)
        out = rejected(s, lambda: cluster(s).create(nb(spec)))
        assert fragment in out[2]
        return out
    case.__name__ = f"cs_malformed_pod_spec_rejected_server_side[{label}]"
    return case


def cs_malformed_update_rejected(s):
    created = cluster(s).create(nb(good_pod_spec()))
    s.api.notebook_pod_spec(created)["containers"][0]["image"] = 17
    return rejected(s, lambda: s.store.update(created))


def cs_all_served_versions_validated(s):
    cluster(s)
    return [rejected(s, lambda v=version: s.store.create(nb(
        {"containers": []}, name=f"nb-{v}", version=v)))
        for version in s.api.SERVED_VERSIONS]


def cs_crd_delete_disables_validation(s):
    cluster(s).delete("CustomResourceDefinition", "",
                      "notebooks.kubeflow.org")
    spec = good_pod_spec()
    spec["containers"][0]["ports"] = [{"containerPort": "not-an-int"}]
    return s.store.create(nb(spec))


def cs_quantity_pattern_matrix(s):
    good = ["1", "100m", "1.5", "16Gi", "4k", "2e9", "0.5", "+1", "-1",
            "123Mi", "1E6", ".5"]
    bad = ["abc", "", "1GiB", "--1", "1.2.3", "Gi"]
    for q in good:
        assert re.match(s.schema.QUANTITY_PATTERN, q), q
    for q in bad:
        assert not re.match(s.schema.QUANTITY_PATTERN, q), q
    return s.schema.QUANTITY_PATTERN


def cs_validator_int_or_string(s):
    schema = {"type": "string", "x-kubernetes-int-or-string": True}
    assert s.schema.validate_schema(8888, schema) == []
    assert s.schema.validate_schema("http", schema) == []
    out = s.schema.validate_schema(True, schema)
    assert out
    return out


def cs_validator_bool_is_not_integer(s):
    out = s.schema.validate_schema(True, {"type": "integer"})
    assert out
    assert s.schema.validate_schema(2, {"type": "integer"}) == []
    return out


def cs_error_paths_are_field_paths(s):
    spec = good_pod_spec()
    spec["containers"][0]["env"] = [{"name": "A"}, {"value": "missing"}]
    out = rejected(s, lambda: cluster(s).create(nb(spec)))
    assert ".spec.template.spec.containers[0].env[1].name" in out[2]
    return out


def notebook_crd(s) -> dict:
    """The side's Notebook CRD: the reference renders it in
    ``deploy/manifests.py``, the port keeps it in ``api/types.py``."""
    if s.side == "ref":
        from kubeflow_tpu.deploy.manifests import notebook_crd as ref_crd
        return ref_crd()
    return s.api.notebook_crd()


def cs_generated_crd_matches_reference_shape(s):
    crd = notebook_crd(s)
    assert crd["metadata"]["name"] == "notebooks.kubeflow.org"
    versions = {v["name"]: v for v in crd["spec"]["versions"]}
    assert set(versions) == {"v1", "v1beta1", "v1alpha1"}
    assert versions["v1"]["storage"] and not versions["v1beta1"]["storage"]
    for v in versions.values():
        pod = v["schema"]["openAPIV3Schema"]["properties"]["spec"][
            "properties"]["template"]["properties"]["spec"]
        assert pod["required"] == ["containers"]
        container = pod["properties"]["containers"]["items"]
        assert container["properties"]["image"]["type"] == "string"
        assert v["subresources"] == {"status": {}}
        assert any(c["name"] == "Ready"
                   for c in v["additionalPrinterColumns"])
    return crd


# ------------------------------------ tests/test_podspec_full_schema.py
def _containers(**extra) -> dict:
    return {"containers": [{"name": "nb", "image": "jupyter:latest",
                            **extra}]}


def _nb(pod_spec, name="nb"):
    return nb(pod_spec, name=name, ns="ns")


def ps_valid_probe_and_affinity_accepted(s):
    spec = _containers(
        livenessProbe={"httpGet": {"port": 8888, "path": "/api"},
                       "initialDelaySeconds": 5, "periodSeconds": 10},
        readinessProbe={"tcpSocket": {"port": "http"}},
        startupProbe={"exec": {"command": ["cat", "/ready"]}})
    spec["affinity"] = {
        "nodeAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [{"matchExpressions": [
                    {"key": "cloud.google.com/gke-tpu-topology",
                     "operator": "In", "values": ["2x2"]}]}]}},
        "podAntiAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [{
                "weight": 100,
                "podAffinityTerm": {
                    "topologyKey": "kubernetes.io/hostname",
                    "labelSelector": {"matchLabels": {"app": "nb"}}}}]},
    }
    spec["topologySpreadConstraints"] = [{
        "maxSkew": 1, "topologyKey": "zone",
        "whenUnsatisfiable": "DoNotSchedule"}]
    return cluster(s).create(_nb(spec))


def ps_mistyped_liveness_probe_port_rejected(s):
    cluster(s)
    return [rejected(s, lambda p=probe: s.store.create(_nb(_containers(
        livenessProbe=p))), match)
        for probe, match in (({"httpGet": {"port": True}}, "port"),
                             ({"httpGet": {"port": {"p": 1}}}, "port"),
                             ({"httpGet": {"path": "/api"}},
                              "port.*required"))]


def ps_malformed_affinity_rejected(s):
    cluster(s)
    out = []
    for affinity, match in (
            ({"nodeAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [
                        {"operator": "Bogus"}]}]}}}, "operator|key"),
            ({"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"a": "b"}}}]}},
             "topologyKey"),
            ({"nodeAffinity": "everywhere"}, "nodeAffinity")):
        spec = _containers()
        spec["affinity"] = affinity
        out.append(rejected(s, lambda: s.store.create(_nb(spec)), match))
    return out


def ps_lifecycle_and_security_context_typed(s):
    cluster(s)
    return [rejected(s, lambda e=extra: s.store.create(_nb(_containers(
        **e))), match) for extra, match in (
            ({"lifecycle": {"preStop": {"sleep": {}}}}, "seconds"),
            ({"securityContext": {"runAsUser": "root"}}, "runAsUser"),
            ({"securityContext": {"seccompProfile": {"type": "Wrong"}}},
             "seccompProfile"))]


def ps_pod_level_fields_typed(s):
    cluster(s)
    out = []
    for field, value, match in (
            ("dnsPolicy", "Sometimes", "dnsPolicy"),
            ("tolerations", [{"operator": "Maybe"}], "operator"),
            ("topologySpreadConstraints",
             [{"maxSkew": 1, "topologyKey": "zone"}], "whenUnsatisfiable"),
            ("hostAliases", [{"hostnames": ["a.local"]}], "ip")):
        spec = _containers()
        spec[field] = value
        out.append(rejected(s, lambda: s.store.create(_nb(spec)), match))
    return out


def ps_volume_sources_typed(s):
    cluster(s)
    out = []
    for volume in ({"name": "w", "hostPath": {"type": "Directory"}},
                   {"name": "w", "configMap": {"items": [{"key": "a"}]}},
                   {"name": "w", "projected": {"sources": [
                       {"serviceAccountToken": {"audience": "x"}}]}}):
        spec = _containers()
        spec["volumes"] = [volume]
        out.append(rejected(s, lambda: s.store.create(_nb(spec)), "path"))
    return out


def ps_unknown_future_fields_still_flow(s):
    spec = _containers()
    spec["someFutureK8sField"] = {"anything": ["goes"]}
    return cluster(s).create(_nb(spec))


def ps_override_layer_still_tightens(s):
    return rejected(s, lambda: cluster(s).create(_nb(_containers(
        resources={"limits": {"cpu": "not-a-quantity"}}))), "cpu")


def ps_ephemeral_containers_typed(s):
    cluster(s)
    spec = _containers()
    spec["ephemeralContainers"] = [
        {"name": "debug", "image": "busybox", "targetContainerName": "nb"}]
    out = [s.store.create(_nb(spec))]
    spec["ephemeralContainers"] = [{"name": "debug",
                                    "targetContainerName": 7}]
    out.append(rejected(s, lambda: s.store.create(_nb(spec, name="nb2")),
                        "targetContainerName"))
    spec["ephemeralContainers"] = [{"image": "busybox"}]
    out.append(rejected(s, lambda: s.store.create(_nb(spec, name="nb3")),
                        "name"))
    return out


def ps_ephemeral_volume_source_typed(s):
    cluster(s)
    spec = _containers()
    spec["volumes"] = [{"name": "scratch", "ephemeral": {
        "volumeClaimTemplate": {"spec": {
            "accessModes": ["ReadWriteOnce"],
            "resources": {"requests": {"storage": "10Gi"}},
            "storageClassName": "fast"}}}}]
    out = [s.store.create(_nb(spec))]
    spec["volumes"] = [{"name": "scratch", "ephemeral": {
        "volumeClaimTemplate": {"metadata": {"labels": {}}}}}]
    out.append(rejected(s, lambda: s.store.create(_nb(spec, name="nb2")),
                        "spec"))
    spec["volumes"] = [{"name": "scratch", "ephemeral": {
        "volumeClaimTemplate": {"spec": {"volumeMode": "Sideways"}}}}]
    out.append(rejected(s, lambda: s.store.create(_nb(spec, name="nb3")),
                        "volumeMode"))
    return out


def ps_cluster_trust_bundle_projection_typed(s):
    cluster(s)
    spec = _containers()
    spec["volumes"] = [{"name": "certs", "projected": {"sources": [
        {"clusterTrustBundle": {"path": "bundle.pem",
                                "signerName": "example.com/signer"}}]}}]
    out = [s.store.create(_nb(spec))]
    spec["volumes"] = [{"name": "certs", "projected": {"sources": [
        {"clusterTrustBundle": {"signerName": "x"}}]}}]
    out.append(rejected(s, lambda: s.store.create(_nb(spec, name="nb2")),
                        "path"))
    return out


def ps_legacy_volume_sources_typed(s):
    cluster(s)
    out = []
    for i, (volume, match) in enumerate((
            ({"name": "v", "iscsi": {"iqn": "iqn.2026-07.x"}},
             "lun|targetPortal"),
            ({"name": "v", "gcePersistentDisk": {"fsType": "ext4"}},
             "pdName"),
            ({"name": "v", "awsElasticBlockStore": {
                "volumeID": "vol-1", "partition": "one"}}, "partition"))):
        spec = _containers()
        spec["volumes"] = [volume]
        out.append(rejected(s, lambda: s.store.create(_nb(
            spec, name=f"nb{i}")), match))
    return out


# ------------------------------------------- tests/test_api_versions.py
def nb_at_version(s, version, name="nb", ns="default"):
    out = s.api.new_notebook(name, ns)
    out["apiVersion"] = f"{s.api.GROUP}/{version}"
    return out


def av_served_versions_declared(s):
    assert s.api.STORAGE_VERSION == "v1"
    assert set(s.api.SERVED_VERSIONS) == {"v1", "v1beta1", "v1alpha1"}
    return list(s.api.SERVED_VERSIONS)


def _av_create_any_served_version_stored_at_v1(version):
    def case(s):
        cluster(s).create(nb_at_version(s, version))
        stored = s.store.get(s.api.KIND, "default", "nb")
        assert stored["apiVersion"] == s.api.API_VERSION
        return stored
    case.__name__ = f"av_create_any_served_version_stored_at_v1[{version}]"
    return case


def av_unserved_version_rejected(s):
    cluster(s)
    return [rejected(s, lambda: s.store.create(nb_at_version(s, "v2"))),
            rejected(s, lambda: s.store.create({
                "apiVersion": "other.group/v1", "kind": s.api.KIND,
                "metadata": {"name": "x", "namespace": "default"},
                "spec": {"template": {"spec": {"containers": [
                    {"name": "x", "image": "i"}]}}}}))]


def av_convert_notebook_round_trip(s):
    old = nb_at_version(s, "v1beta1")
    v1 = s.api.convert_notebook(old, "v1")
    assert v1["apiVersion"] == "kubeflow.org/v1"
    assert v1["spec"] == old["spec"] and v1["metadata"] == old["metadata"]
    back = s.api.convert_notebook(v1, "v1beta1")
    assert back["apiVersion"] == "kubeflow.org/v1beta1"
    assert s.api.convert_notebook(v1, "v1") is v1
    return [v1, back]


def av_convert_to_unknown_version_rejected(s):
    return rejected(s, lambda: s.api.convert_notebook(
        nb_at_version(s, "v1"), "v9"))


def av_v1beta1_notebook_reconciles_to_ready(s):
    cluster(s)
    s.reconciler()
    s.simulator()
    s.store.create(nb_at_version(s, "v1beta1", name="legacy-nb"))
    s.drain()
    assert s.store.get_or_none("StatefulSet", "default", "legacy-nb")
    out = s.store.get(s.api.KIND, "default", "legacy-nb")
    assert out["apiVersion"] == s.api.API_VERSION
    return out


def _cases(prefix: str, fns) -> dict:
    return {f"{prefix}.{fn.__name__.split('_', 1)[1]}": fn for fn in fns}


CASES = {}
CASES.update(_cases("test_crd_schema", (
    cs_valid_notebook_accepted, cs_untyped_pod_spec_fields_flow_through,
    cs_resources_with_tpu_quantities_accepted,
    *(_cs_malformed(*m) for m in MALFORMED),
    cs_malformed_update_rejected, cs_all_served_versions_validated,
    cs_crd_delete_disables_validation, cs_quantity_pattern_matrix,
    cs_validator_int_or_string, cs_validator_bool_is_not_integer,
    cs_error_paths_are_field_paths,
    cs_generated_crd_matches_reference_shape)))
CASES.update(_cases("test_podspec_full_schema", (
    ps_valid_probe_and_affinity_accepted,
    ps_mistyped_liveness_probe_port_rejected, ps_malformed_affinity_rejected,
    ps_lifecycle_and_security_context_typed, ps_pod_level_fields_typed,
    ps_volume_sources_typed, ps_unknown_future_fields_still_flow,
    ps_override_layer_still_tightens, ps_ephemeral_containers_typed,
    ps_ephemeral_volume_source_typed,
    ps_cluster_trust_bundle_projection_typed,
    ps_legacy_volume_sources_typed)))
CASES.update(_cases("test_api_versions", (
    av_served_versions_declared,
    *(_av_create_any_served_version_stored_at_v1(v)
      for v in ("v1", "v1beta1", "v1alpha1")),
    av_unserved_version_rejected, av_convert_notebook_round_trip,
    av_convert_to_unknown_version_rejected,
    av_v1beta1_notebook_reconciles_to_ready)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_schema_case_through_both_packages(case):
    got, stores, writes = {}, {}, {}
    for s in (Stack("ref"), Stack("port")):
        got[s.side] = normalise_result(CASES[case](s), s.side)
        stores[s.side] = {(o["kind"], s.k8s.namespace(o), s.k8s.name(o)):
                          normalise(o, s.side)
                          for o in s.store.all_objects()}
        writes[s.side] = s.store._last_rv
    assert got["port"] == got["ref"]
    assert sorted(stores["port"]) == sorted(stores["ref"])
    for key in sorted(stores["ref"]):
        assert stores["port"][key] == stores["ref"][key], key
    assert writes["port"] == writes["ref"]


def test_the_cases_cover_the_reference_files():
    """12 functions of tests/test_crd_schema.py (22 cases), 12 of
    tests/test_podspec_full_schema.py and 6 of tests/test_api_versions.py
    (8 cases)."""
    counts = {}
    for key in CASES:
        counts[key.split(".")[0]] = counts.get(key.split(".")[0], 0) + 1
    assert counts == {"test_crd_schema": 22, "test_podspec_full_schema": 12,
                      "test_api_versions": 8}


def test_notebook_crd_is_the_reference_manifest():
    """The port's ``notebook_crd`` is the reference's
    ``deploy/manifests.py`` ``notebook_crd``, key for key."""
    from kubeflow_tpu.deploy.manifests import notebook_crd as ref_crd
    from kubeflow_tpu_torch.api.types import notebook_crd
    assert notebook_crd() == ref_crd()


# -------------------------------------------------- seeded pod specs
def _base_spec() -> dict:
    return {
        "containers": [{
            "name": "nb", "image": "img:1",
            "env": [{"name": "A", "value": "1"}],
            "ports": [{"containerPort": 8888, "name": "notebook-port",
                       "protocol": "TCP"}],
            "resources": {"limits": {"cpu": "1", "memory": "1Gi"},
                          "requests": {"cpu": "500m"}},
            "volumeMounts": [{"name": "data", "mountPath": "/data"}],
            "livenessProbe": {"httpGet": {"port": 8888, "path": "/"},
                              "periodSeconds": 5},
            "securityContext": {"runAsUser": 1000},
            "imagePullPolicy": "IfNotPresent"}],
        "volumes": [{"name": "data",
                     "persistentVolumeClaim": {"claimName": "pvc"}},
                    {"name": "cm", "configMap": {"name": "c", "items": [
                        {"key": "k", "path": "p"}]}}],
        "tolerations": [{"key": "nvidia.com/gpu", "operator": "Exists",
                         "effect": "NoSchedule"}],
        "affinity": {"nodeAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [{"matchExpressions": [
                    {"key": "zone", "operator": "In",
                     "values": ["a"]}]}]}}},
        "restartPolicy": "Always",
        "dnsPolicy": "ClusterFirst",
        "terminationGracePeriodSeconds": 30,
    }


_WRONG = [7, True, "x", "", [], {}, None, "-1Gi", "Bad_Name", 99999, 1.5]


def _paths(value, path=()):
    yield path
    if isinstance(value, dict):
        for k, v in value.items():
            yield from _paths(v, path + (k,))
    elif isinstance(value, list):
        for i, v in enumerate(value):
            yield from _paths(v, path + (i,))


def _drawn_spec(rng) -> dict:
    spec = _base_spec()
    for _ in range(int(rng.integers(0, 4))):
        paths = [p for p in _paths(spec) if p]
        path = paths[int(rng.integers(0, len(paths)))]
        parent = spec
        for key in path[:-1]:
            parent = parent[key]
        if isinstance(parent, dict) and rng.random() < 0.3:
            del parent[path[-1]]
        else:
            parent[path[-1]] = _WRONG[int(rng.integers(0, len(_WRONG)))]
    return spec


def test_validate_schema_matches_the_reference_on_seeded_pod_specs():
    """``validate_schema`` of both packages against each package's own
    pod-spec schema (equal, as the CRD is) on 300 pod specs drawn from
    one seed, and the same create through each store with its Notebook
    CRD installed: the same errors, or the same object."""
    from kubeflow_tpu.api import schema as ref_schema
    from kubeflow_tpu_torch.api import schema
    rng = np.random.default_rng(SEED)
    ref_pod, pod = ref_schema.pod_spec_schema(), schema.pod_spec_schema()
    assert pod == ref_pod
    stacks = (Stack("ref"), Stack("port"))
    for s in stacks:
        cluster(s)
    valid = invalid = 0
    for i in range(300):
        spec = _drawn_spec(rng)
        want = ref_schema.validate_schema(spec, ref_pod)
        assert schema.validate_schema(spec, pod) == want, i
        outcomes = []
        for s in stacks:
            try:
                made = s.store.create(nb(spec, name=f"nb-{i}"))
                outcomes.append(normalise(made, s.side))
            except s.errors.InvalidError as exc:
                outcomes.append((exc.code, exc.message))
        assert outcomes[1] == outcomes[0], i
        valid += not want
        invalid += bool(want)
    assert valid > 20 and invalid > 150
    assert stacks[1].store._last_rv == stacks[0].store._last_rv
