"""The port's core lifecycle controller held against the reference's, case
for case: every case of tests/test_notebook_controller.py runs through
both stacks (store, Manager, NotebookReconciler and, where the case uses
it, the StatefulSet simulator), each side with the case's own assertions,
and then every object of both stores is compared key for key.

The same Notebook goes to both sides; only its accelerator request is
mapped, to the H100 shape with the same worker count (``v5e-4`` (1 x 4)
↔ ``h100-4`` (1 x 4), ``v5e-16`` (4 x 4) ↔ ``h100-32`` (4 x 8)).
``normalise`` (tests/torch_parity.py, beside ``Stack``) drops
``uid``, ``resourceVersion`` and timestamps, and maps only the
accelerator seam: the resource key and its per-worker count, the
nodeSelector, the TPU_ACCELERATOR_TYPE and TPU_TOPOLOGY values and the
slice label's value, and the request itself (the Notebook's
annotation, a SlicePool's ``spec.accelerator``). Everything else —
names, generateName suffixes, labels, annotations, owner references, env
order, replicas, serviceName, hostnames, condition reasons — must be
equal. Cases without the simulator are deterministic, so the two sides
must also make the same number of writes and reconciles; with it, pod
readiness rides a timed requeue and only the objects are compared.
"""

from __future__ import annotations

import pytest

from kubeflow_tpu_torch.utils import k8s
from torch_parity import RESOURCE_KEY, Stack, assert_parity, normalise


# ------------------------------------------------ the reference's cases
def creates_sts_and_service(s):
    s.reconciler()
    s.apply(s.api.new_notebook("mynb", "user-ns", image="jupyter:latest"))
    sts = s.store.get("StatefulSet", "user-ns", "mynb")
    svc = s.store.get("Service", "user-ns", "mynb")
    assert sts["spec"]["replicas"] == 1
    assert sts["spec"]["selector"]["matchLabels"] == {"statefulset": "mynb"}
    assert s.k8s.get_label(sts, s.names.NOTEBOOK_NAME_LABEL) == "mynb"
    assert svc["spec"]["type"] == "ClusterIP"
    assert svc["spec"]["ports"][0]["name"] == "http-notebook"
    assert svc["spec"]["ports"][0]["port"] == 80
    assert svc["spec"]["ports"][0]["targetPort"] == 8888
    assert s.k8s.is_owned_by(sts, s.k8s.uid(
        s.store.get(s.api.KIND, "user-ns", "mynb")))


def container_defaults(s):
    s.reconciler()
    s.apply(s.api.new_notebook("mynb", "user-ns"))
    sts = s.store.get("StatefulSet", "user-ns", "mynb")
    c = sts["spec"]["template"]["spec"]["containers"][0]
    assert c["workingDir"] == "/home/jovyan"
    assert c["ports"][0]["containerPort"] == 8888
    env = s.k8s.env_list_to_dict(c["env"])
    assert env["NB_PREFIX"] == "/notebook/user-ns/mynb"
    assert sts["spec"]["template"]["spec"]["securityContext"]["fsGroup"] == 100


def no_fsgroup_when_disabled(s):
    s.config.add_fsgroup = False
    s.reconciler()
    s.apply(s.api.new_notebook("mynb", "ns"))
    sts = s.store.get("StatefulSet", "ns", "mynb")
    assert "securityContext" not in sts["spec"]["template"]["spec"]


def stop_annotation_scales_to_zero(s):
    s.reconciler()
    s.apply(s.api.new_notebook("mynb", "ns"))
    assert s.store.get("StatefulSet", "ns", "mynb")["spec"]["replicas"] == 1
    s.store.patch(s.api.KIND, "ns", "mynb", {"metadata": {"annotations": {
        s.names.STOP_ANNOTATION: "2026-07-29T00:00:00Z"}}})
    s.drain()
    assert s.store.get("StatefulSet", "ns", "mynb")["spec"]["replicas"] == 0
    s.store.patch(s.api.KIND, "ns", "mynb", {"metadata": {"annotations": {
        s.names.STOP_ANNOTATION: None}}})
    s.drain()
    assert s.store.get("StatefulSet", "ns", "mynb")["spec"]["replicas"] == 1


def long_name_generate_name(s):
    s.reconciler()
    long_name = "a" * 60
    s.apply(s.api.new_notebook(long_name, "ns"))
    stss = s.store.list("StatefulSet", "ns",
                        {s.names.NOTEBOOK_NAME_LABEL: long_name})
    assert len(stss) == 1
    assert s.k8s.name(stss[0]).startswith("nb-")
    assert len(s.k8s.name(stss[0])) <= 52
    s.manager.enqueue("notebook-controller", s.Request("ns", long_name))
    s.drain()
    assert len(s.store.list("StatefulSet", "ns",
                            {s.names.NOTEBOOK_NAME_LABEL: long_name})) == 1


def annotation_propagation_excludes_prefixes(s):
    s.reconciler()
    s.apply(s.api.new_notebook("mynb", "ns", annotations={
        "kubectl.kubernetes.io/last-applied-configuration": "{}",
        "notebooks.opendatahub.io/inject-auth": "true",
        "custom/keep": "yes",
    }))
    anns = s.store.get("StatefulSet", "ns", "mynb")["metadata"]["annotations"]
    assert "custom/keep" in anns
    assert "kubectl.kubernetes.io/last-applied-configuration" not in anns
    assert "notebooks.opendatahub.io/inject-auth" not in anns


def tpu_v5e4_single_host(s):
    s.reconciler()
    s.apply(s.api.new_notebook("tpu-nb", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-4")}))
    sts = s.store.get("StatefulSet", "ns", "tpu-nb")
    assert sts["spec"]["replicas"] == 1
    pod_spec = sts["spec"]["template"]["spec"]
    assert pod_spec["nodeSelector"] == s.rendered("v5e-4")["nodeSelector"]
    c = pod_spec["containers"][0]
    assert c["resources"]["requests"][RESOURCE_KEY[s.side]] == "4"
    assert c["resources"]["limits"][RESOURCE_KEY[s.side]] == "4"
    env = s.k8s.env_list_to_dict(c["env"])
    assert env["TPU_WORKER_HOSTNAMES"] == "localhost"
    assert s.store.get_or_none("Service", "ns", "tpu-nb-workers") is None


def tpu_v5e16_multi_host(s):
    s.reconciler()
    s.apply(s.api.new_notebook("big", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    sts = s.store.get("StatefulSet", "ns", "big")
    assert sts["spec"]["replicas"] == 4
    assert sts["spec"]["serviceName"] == "big-workers"
    headless = s.store.get("Service", "ns", "big-workers")
    assert headless["spec"]["clusterIP"] == "None"
    assert headless["spec"]["publishNotReadyAddresses"] is True
    c = sts["spec"]["template"]["spec"]["containers"][0]
    env = s.k8s.env_list_to_dict(c["env"])
    assert env["TPU_WORKER_HOSTNAMES"] == ",".join(
        f"big-{i}.big-workers.ns.svc" for i in range(4))
    assert env["TPU_TOPOLOGY"] == s.rendered("v5e-16")["topology"]
    assert c["resources"]["limits"][RESOURCE_KEY[s.side]] == \
        s.rendered("v5e-16")["per_worker"]
    worker_id = [e for e in c["env"] if e["name"] == "TPU_WORKER_ID"][0]
    assert worker_id["valueFrom"]["fieldRef"]["fieldPath"] == \
        "metadata.labels['apps.kubernetes.io/pod-index']"


def long_name_multihost_hostnames_use_real_sts_name(s):
    s.reconciler()
    long_name = "n" * 60
    s.apply(s.api.new_notebook(long_name, "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    sts = s.store.list("StatefulSet", "ns",
                       {s.names.NOTEBOOK_NAME_LABEL: long_name})[0]
    real_name = s.k8s.name(sts)
    assert real_name.startswith("nb-") and real_name != long_name
    env = s.k8s.env_list_to_dict(
        sts["spec"]["template"]["spec"]["containers"][0]["env"])
    for i in range(4):
        assert f"{real_name}-{i}." in env["TPU_WORKER_HOSTNAMES"]
    assert long_name not in \
        env["TPU_WORKER_HOSTNAMES"].split(",")[0].split(".")[0]


def cr_labels_and_annotations_reach_pod_template(s):
    s.reconciler()
    s.apply(s.api.new_notebook(
        "mynb", "ns", labels={"poddefault/enable-gpu": "true"},
        annotations={"sidecar.istio.io/inject": "false",
                     "kubectl.kubernetes.io/x": "drop"}))
    tmpl = s.store.get("StatefulSet", "ns", "mynb")["spec"]["template"]
    assert tmpl["metadata"]["labels"]["poddefault/enable-gpu"] == "true"
    assert tmpl["metadata"]["annotations"]["sidecar.istio.io/inject"] == \
        "false"
    assert "kubectl.kubernetes.io/x" not in tmpl["metadata"]["annotations"]


def e2e_slice_ready_with_simulator(s):
    s.reconciler()
    s.simulator()
    s.store.create(s.api.new_notebook("big", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    s.drain(include_delayed_under=0.1)
    pods = s.store.list("Pod", "ns", {s.names.NOTEBOOK_NAME_LABEL: "big"})
    assert len(pods) == 4
    assert {s.k8s.get_label(p, "apps.kubernetes.io/pod-index")
            for p in pods} == {"0", "1", "2", "3"}
    cur = s.store.get(s.api.KIND, "ns", "big")
    cond = s.api.get_condition(cur, s.api.CONDITION_SLICE_READY)
    assert cond and cond["status"] == "True"
    assert cur["status"]["readyReplicas"] == 4
    s.store.patch(s.api.KIND, "ns", "big", {"metadata": {"annotations": {
        s.names.STOP_ANNOTATION: "t"}}})
    s.drain(include_delayed_under=0.1)
    assert s.store.list("Pod", "ns",
                        {s.names.NOTEBOOK_NAME_LABEL: "big"}) == []
    cur = s.store.get(s.api.KIND, "ns", "big")
    cond = s.api.get_condition(cur, s.api.CONDITION_SLICE_READY)
    assert cond["status"] == "False"


def restart_annotation_bounces_pods(s):
    s.reconciler()
    s.simulator()
    s.store.create(s.api.new_notebook("mynb", "ns"))
    s.drain(include_delayed_under=0.1)
    pod = s.store.list("Pod", "ns", {s.names.NOTEBOOK_NAME_LABEL: "mynb"})[0]
    first_uid = s.k8s.uid(pod)
    s.store.patch(s.api.KIND, "ns", "mynb", {"metadata": {"annotations": {
        s.names.RESTART_ANNOTATION: "true"}}})
    s.drain(include_delayed_under=0.1)
    cur = s.store.get(s.api.KIND, "ns", "mynb")
    assert s.k8s.get_annotation(cur, s.names.RESTART_ANNOTATION) is None
    pods = s.store.list("Pod", "ns", {s.names.NOTEBOOK_NAME_LABEL: "mynb"})
    assert len(pods) == 1 and s.k8s.uid(pods[0]) != first_uid


def deletion_cascades(s):
    s.reconciler()
    s.store.create(s.api.new_notebook("mynb", "ns"))
    s.drain()
    s.store.delete(s.api.KIND, "ns", "mynb")
    s.drain()
    assert s.store.get_or_none("StatefulSet", "ns", "mynb") is None
    assert s.store.get_or_none("Service", "ns", "mynb") is None


def idempotent_no_spurious_updates(s):
    s.reconciler()
    s.store.create(s.api.new_notebook("mynb", "ns"))
    s.drain()
    rvs = [s.store.get(kind, "ns", "mynb")["metadata"]["resourceVersion"]
           for kind in ("StatefulSet", "Service")]
    writes = s.store._last_rv
    s.manager.enqueue("notebook-controller", s.Request("ns", "mynb"))
    s.drain()
    assert [s.store.get(kind, "ns", "mynb")["metadata"]["resourceVersion"]
            for kind in ("StatefulSet", "Service")] == rvs
    assert s.store._last_rv == writes   # the second reconcile wrote nothing


def service_clusterip_never_copied(s):
    s.reconciler()
    s.store.create(s.api.new_notebook("mynb", "ns"))
    s.drain()
    svc = s.store.get("Service", "ns", "mynb")
    svc["spec"]["clusterIP"] = "10.0.0.7"
    svc["metadata"]["labels"]["drift"] = "yes"
    s.store.update(svc)
    s.drain()
    cur = s.store.get("Service", "ns", "mynb")
    assert cur["spec"]["clusterIP"] == "10.0.0.7"
    assert "drift" not in cur["metadata"]["labels"]


def _istio(s):
    s.config.use_istio = True
    s.reconciler()


def virtual_service_created_when_istio_enabled(s):
    _istio(s)
    s.apply(s.api.new_notebook("mynb", "user-ns"))
    vs = s.store.get("VirtualService", "user-ns", "notebook-user-ns-mynb")
    assert vs["apiVersion"] == "networking.istio.io/v1alpha3"
    assert vs["spec"]["hosts"] == ["*"]
    assert vs["spec"]["gateways"] == ["kubeflow/kubeflow-gateway"]
    http = vs["spec"]["http"][0]
    assert http["match"][0]["uri"]["prefix"] == "/notebook/user-ns/mynb/"
    assert http["rewrite"]["uri"] == "/notebook/user-ns/mynb/"
    dest = http["route"][0]["destination"]
    assert dest["host"] == "mynb.user-ns.svc.cluster.local"
    assert dest["port"]["number"] == 80
    assert s.k8s.is_owned_by(vs, s.k8s.uid(
        s.store.get(s.api.KIND, "user-ns", "mynb")))


def virtual_service_gateway_host_configurable(s):
    s.config.istio_gateway = "my-ns/my-gw"
    s.config.istio_host = "notebooks.example.com"
    s.config.cluster_domain = "corp.local"
    _istio(s)
    s.apply(s.api.new_notebook("nb", "ns"))
    vs = s.store.get("VirtualService", "ns", "notebook-ns-nb")
    assert vs["spec"]["hosts"] == ["notebooks.example.com"]
    assert vs["spec"]["gateways"] == ["my-ns/my-gw"]
    assert (vs["spec"]["http"][0]["route"][0]["destination"]["host"]
            == "nb.ns.svc.corp.local")


def virtual_service_drift_repaired(s):
    _istio(s)
    s.apply(s.api.new_notebook("nb", "ns"))
    vs = s.store.get("VirtualService", "ns", "notebook-ns-nb")
    vs["spec"]["http"][0]["route"][0]["destination"]["host"] = "evil.svc"
    s.store.update(vs)
    s.drain()
    vs = s.store.get("VirtualService", "ns", "notebook-ns-nb")
    assert (vs["spec"]["http"][0]["route"][0]["destination"]["host"]
            == "nb.ns.svc.cluster.local")


def no_virtual_service_by_default(s):
    s.reconciler()
    s.apply(s.api.new_notebook("nb", "ns"))
    assert s.store.get_or_none("VirtualService", "ns",
                               "notebook-ns-nb") is None


def worker_env_stable_across_stop_resume_cycles(s):
    s.reconciler()
    s.apply(s.api.new_notebook("cyc", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))

    def rendered():
        sts = s.store.get("StatefulSet", "ns", "cyc")
        return (sts["spec"]["replicas"], sts["spec"].get("serviceName"),
                sts["spec"]["template"])

    replicas0, svc0, template0 = rendered()
    assert replicas0 == 4
    for cycle in range(2):
        s.store.patch(s.api.KIND, "ns", "cyc", {"metadata": {"annotations": {
            s.names.STOP_ANNOTATION: f"2026-01-0{cycle + 1}T00:00:00Z"}}})
        s.drain()
        stopped_replicas, svc_stopped, template_stopped = rendered()
        assert stopped_replicas == 0
        scrubbed = s.k8s.deepcopy(template_stopped)
        scrubbed["metadata"]["annotations"].pop(s.names.STOP_ANNOTATION, None)
        assert scrubbed == template0
        assert svc_stopped == svc0
        s.store.patch(s.api.KIND, "ns", "cyc", {"metadata": {"annotations": {
            s.names.STOP_ANNOTATION: None}}})
        s.drain()
        resumed_replicas, svc_resumed, template_resumed = rendered()
        assert resumed_replicas == 4
        assert template_resumed == template0
        assert svc_resumed == svc0
    assert s.store.get("Service", "ns", "cyc-workers")


def notebook_label_edit_keeps_pods_visible_to_simulator(s):
    s.reconciler()
    s.simulator()
    s.store.create(s.api.new_notebook("mynb", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-4")}))
    s.drain(include_delayed_under=0.1)
    pod = s.store.list("Pod", "ns", {s.names.NOTEBOOK_NAME_LABEL: "mynb"})[0]
    first_uid = s.k8s.uid(pod)
    cond = s.api.get_condition(s.store.get(s.api.KIND, "ns", "mynb"),
                               s.api.CONDITION_SLICE_READY)
    assert cond and cond["status"] == "True"
    s.store.patch(s.api.KIND, "ns", "mynb",
                  {"metadata": {"labels": {"team": "research"}}})
    s.drain(include_delayed_under=0.1)
    sts = s.store.get("StatefulSet", "ns", "mynb")
    assert sts["spec"]["template"]["metadata"]["labels"]["team"] == "research"
    pods = s.store.list("Pod", "ns", {s.names.NOTEBOOK_NAME_LABEL: "mynb"})
    assert len(pods) == 1 and s.k8s.uid(pods[0]) == first_uid
    assert sts["status"]["readyReplicas"] == 1
    cond = s.api.get_condition(s.store.get(s.api.KIND, "ns", "mynb"),
                               s.api.CONDITION_SLICE_READY)
    assert cond["status"] == "True"


def service_exposes_annotated_serving_port(s):
    s.reconciler()
    s.apply(s.api.new_notebook("srv", "ns", annotations={
        s.names.SERVING_PORT_ANNOTATION: "8890"}))
    s.apply(s.api.new_notebook("bad", "ns", annotations={
        s.names.SERVING_PORT_ANNOTATION: "not-a-port"}))
    s.apply(s.api.new_notebook("plain", "ns"))
    ports = s.store.get("Service", "ns", "srv")["spec"]["ports"]
    assert {"name": "http-serving", "port": 8890, "targetPort": 8890,
            "protocol": "TCP"} in ports
    assert len(s.store.get("Service", "ns", "bad")["spec"]["ports"]) == 1
    assert len(s.store.get("Service", "ns", "plain")["spec"]["ports"]) == 1


# the 22 cases of tests/test_notebook_controller.py, under their names
REFERENCE_CASES = {f"test_{fn.__name__}": fn for fn in (
    creates_sts_and_service, container_defaults, no_fsgroup_when_disabled,
    stop_annotation_scales_to_zero, long_name_generate_name,
    annotation_propagation_excludes_prefixes, tpu_v5e4_single_host,
    tpu_v5e16_multi_host, long_name_multihost_hostnames_use_real_sts_name,
    cr_labels_and_annotations_reach_pod_template,
    e2e_slice_ready_with_simulator, restart_annotation_bounces_pods,
    deletion_cascades, idempotent_no_spurious_updates,
    service_clusterip_never_copied,
    virtual_service_created_when_istio_enabled,
    virtual_service_gateway_host_configurable,
    virtual_service_drift_repaired, no_virtual_service_by_default,
    worker_env_stable_across_stop_resume_cycles,
    notebook_label_edit_keeps_pods_visible_to_simulator,
    service_exposes_annotated_serving_port)}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_case_through_both_stacks(case):
    ref, port = Stack("ref"), Stack("port")
    REFERENCE_CASES[case](ref)
    REFERENCE_CASES[case](port)
    assert_parity(ref, port)


# ----------------------------------------------- the gates, copied as is
def scheduler_gate_holds_until_admitted(s):
    """A gang-annotated notebook the scheduler has queued rolls nothing
    until its state reads Admitted."""
    s.reconciler()
    s.store.create(s.api.new_notebook("gang", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
        s.names.SCHED_GANG_ANNOTATION: "1",
        s.names.SCHED_STATE_ANNOTATION: "Pending"}))
    s.drain()
    assert s.store.list("StatefulSet", "ns") == []
    assert s.store.list("Service", "ns") == []
    s.store.patch(s.api.KIND, "ns", "gang", {"metadata": {"annotations": {
        s.names.SCHED_STATE_ANNOTATION: "Admitted"}}})
    s.drain()
    sts = s.store.get("StatefulSet", "ns", "gang")
    assert sts["spec"]["replicas"] == 4
    # scheduler bookkeeping never reaches the pod template
    assert s.names.SCHED_STATE_ANNOTATION not in \
        sts["spec"]["template"]["metadata"]["annotations"]


def pool_gate_holds_then_cold_rolls_on_a_bind_miss(s):
    """A SlicePool of the requested shape holds the cold roll (a warm
    slice may bind); a bind-miss annotation releases it."""
    s.reconciler()
    s.store.create(s.pool_api.new_slice_pool(
        "warm", s.accelerator("v5e-16"), 1))
    s.store.create(s.api.new_notebook("pooled", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
    s.drain()
    assert s.store.list("StatefulSet", "ns") == []
    s.store.patch(s.api.KIND, "ns", "pooled", {"metadata": {"annotations": {
        s.names.POOL_BIND_MISS_ANNOTATION: "Contended"}}})
    s.drain()
    assert s.store.get("StatefulSet", "ns", "pooled")["spec"]["replicas"] == 4


def bound_notebook_points_its_service_at_the_pool_slice(s):
    """A bound notebook gets no StatefulSet: its Service is an
    ExternalName to the pool slice and its status mirrors that slice."""
    s.reconciler()
    s.store.create(s.api.new_notebook("bound", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-4"),
        s.names.BOUND_SLICE_ANNOTATION: "tpu-slice-pools/warm-w0"}))
    s.drain()
    assert s.store.list("StatefulSet", "ns") == []
    svc = s.store.get("Service", "ns", "bound")
    assert svc["spec"]["type"] == "ExternalName"
    assert svc["spec"]["externalName"] == \
        "warm-w0.tpu-slice-pools.svc.cluster.local"
    cond = s.api.get_condition(s.store.get(s.api.KIND, "ns", "bound"),
                               s.api.CONDITION_POOL_BOUND)
    assert cond["status"] == "True" and cond["reason"] == "Bound"


def restart_and_health_annotations_render_status(s):
    """The slice-health annotation renders the Slice* condition triple;
    a restart of a notebook with no pods only strips the annotation."""
    s.reconciler()
    s.store.create(s.api.new_notebook("sick", "ns", annotations={
        s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-4"),
        s.names.SLICE_HEALTH_ANNOTATION: "Degraded",
        s.names.SLICE_HEALTH_REASON_ANNOTATION: "NodeNotReady",
        s.names.RESTART_ANNOTATION: "true"}))
    s.drain()
    nb = s.store.get(s.api.KIND, "ns", "sick")
    assert s.k8s.get_annotation(nb, s.names.RESTART_ANNOTATION) is None
    cond = s.api.get_condition(nb, s.api.CONDITION_SLICE_DEGRADED)
    assert cond["status"] == "True" and cond["reason"] == "NodeNotReady"


GATE_CASES = {fn.__name__: fn for fn in (
    scheduler_gate_holds_until_admitted,
    pool_gate_holds_then_cold_rolls_on_a_bind_miss,
    bound_notebook_points_its_service_at_the_pool_slice,
    restart_and_health_annotations_render_status)}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_case_through_both_stacks(case):
    ref, port = Stack("ref"), Stack("port")
    GATE_CASES[case](ref)
    GATE_CASES[case](port)
    assert_parity(ref, port)


def test_normaliser_maps_only_the_accelerator_seam():
    """A change anywhere but the seam survives ``normalise``: the
    comparison above would see it."""
    port = Stack("port")
    tpu_v5e16_multi_host(port)
    sts = port.store.get("StatefulSet", "ns", "big")
    base = normalise(sts, "port")
    for path, value in ((("spec", "replicas"), 3),
                        (("spec", "serviceName"), "big"),
                        (("metadata", "labels", "statefulset"), "other")):
        changed = k8s.deepcopy(sts)
        node = changed
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
        assert normalise(changed, "port") != base, path
    # the seam maps only the values the shape renders: a wrong count shows
    wrong = k8s.deepcopy(sts)
    wrong["spec"]["template"]["spec"]["containers"][0]["resources"][
        "limits"]["nvidia.com/gpu"] = "4"
    assert normalise(wrong, "port") != base


# ------------------------------------------------- the entry point
def _ref_build_manager(ref: Stack) -> None:
    """The reference composed as the port's ``build_manager(
    simulate_kubelet=True)`` on ``ref``: the SlicePool and TPUQuota CRDs,
    the Notebook reconciler, the SlicePool reconciler, the fleet
    scheduler and the simulator, as the reference's ``setup_controllers``
    registers them."""
    ref.pool_api.install_slicepool_crd(ref.store)
    ref.quota_api.install_tpuquota_crd(ref.store)
    ref.reconciler()
    ref.pool()
    ref.scheduler()
    ref.simulator()


def test_build_manager_matches_the_reference_quick_start():
    """``main.build_manager(simulate_kubelet=True)`` is the reference's
    README quick start (a Manager, the NotebookReconciler and the
    simulator on one store) with the SlicePool and TPUQuota CRDs
    installed and the pool reconciler and the fleet scheduler
    registered, as the reference's ``setup_controllers`` does: the same
    v5e-16 / h100-32 Notebook ends in the same objects, SliceReady on 4
    workers."""
    from kubeflow_tpu_torch.main import build_manager
    ref = Stack("ref")
    _ref_build_manager(ref)
    port = Stack("port")
    port.manager = build_manager(port.store, port.config,
                                 simulate_kubelet=True)
    port.timed = True
    for s in (ref, port):
        s.store.create(s.api.new_notebook("demo", "ns", annotations={
            s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16")}))
        s.drain(include_delayed_under=0.1)
        nb = s.store.get(s.api.KIND, "ns", "demo")
        assert s.k8s.condition_true(nb, s.api.CONDITION_SLICE_READY)
        assert nb["status"]["readyReplicas"] == 4
    assert_parity(ref, port)
    assert port.manager.metrics.counter(
        "notebook_create_total", "").get() == 1


def test_build_manager_admits_a_gang_then_rolls_it():
    """On ``build_manager``, a Notebook asking for a gang of 2 h100-32
    slices (v5e-16 on the reference's side) is admitted by the fleet
    scheduler (Pending, Reserving, Admitted; the reservation stamped; a
    GangAdmitted event) and then rolled to SliceReady, with no
    SchedulerAdmissionTimeout: object for object the reference's. The
    wall-clock ``sched-enqueued-at`` stamp is the one value masked."""
    from kubeflow_tpu_torch.main import build_manager
    ref = Stack("ref")
    _ref_build_manager(ref)
    port = Stack("port")
    port.manager = build_manager(port.store, port.config,
                                 simulate_kubelet=True)
    port.timed = True
    states = {}
    for s in (ref, port):
        seen = states.setdefault(s.side, [])

        def on_notebook(ev, s=s, seen=seen):
            st = s.k8s.get_annotation(ev.obj, s.names.SCHED_STATE_ANNOTATION)
            if ev.type != "DELETED" and (not seen or seen[-1] != st):
                seen.append(st)
        s.store.watch(s.api.KIND, on_notebook)
        s.store.create(s.api.new_notebook("job", "ns", annotations={
            s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
            s.names.SCHED_GANG_ANNOTATION: "2"}))
        s.drain(include_delayed_under=0.1)
        nb = s.store.get(s.api.KIND, "ns", "job")
        anns = nb["metadata"]["annotations"]
        assert anns[s.names.SCHED_STATE_ANNOTATION] == "Admitted"
        assert anns[s.names.SCHED_RESERVED_ANNOTATION] == "2"
        float(anns.pop(s.names.SCHED_ENQUEUED_AT_ANNOTATION))
        s.store.patch(s.api.KIND, "ns", "job", {"metadata": {
            "annotations": {s.names.SCHED_ENQUEUED_AT_ANNOTATION: None}}})
        s.drain(include_delayed_under=0.1)
        assert s.k8s.condition_true(nb, s.api.CONDITION_SLICE_READY)
        assert nb["status"]["readyReplicas"] == 4
        reasons = {e["reason"] for e in s.store.list("Event", "ns")}
        assert "GangAdmitted" in reasons
        assert "SchedulerAdmissionTimeout" not in reasons
    assert states["port"] == states["ref"] == [
        None, "Pending", "Reserving", "Admitted"]
    assert_parity(ref, port)
    assert port.manager.metrics.counter(
        "scheduler_admissions_total", "").get(
        {"tenant": "ns", "outcome": "admitted"}) == 1


@pytest.mark.parametrize("components", ["extension", "all", "bogus"])
def test_build_manager_refuses_what_is_not_ported(components):
    from kubeflow_tpu_torch.main import build_manager
    with pytest.raises(ValueError, match="ROADMAP" if components != "bogus"
                       else "unknown components"):
        build_manager(components=components)


def test_build_manager_enable_culling_gate():
    """tests/test_culling.py's ``test_enable_culling_gate`` on both entry
    points: the reference's ``setup_controllers`` and the port's
    ``build_manager`` register ``culling-controller`` only with
    ``enable_culling``, and the port's manager reads through its cache."""
    from kubeflow_tpu.cluster.store import ClusterStore as RefStore
    from kubeflow_tpu.controllers import setup_controllers
    from kubeflow_tpu.controllers.culling import (
        JupyterActivity as RefActivity)
    from kubeflow_tpu.utils.config import ControllerConfig as RefConfig
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers.culling import JupyterActivity
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.utils.config import ControllerConfig
    for enable in (False, True):
        ref = setup_controllers(RefStore(), RefConfig(enable_culling=enable),
                                prober=lambda nb: RefActivity())
        port = build_manager(ClusterStore(),
                             ControllerConfig(enable_culling=enable),
                             prober=lambda nb: JupyterActivity())
        assert ("culling-controller" in port._reconcilers) == \
            ("culling-controller" in ref._reconcilers) == enable
        assert port.read_cache is not None and port.client is port.read_cache


def test_build_manager_enable_slice_repair_gate():
    """The ENABLE_SLICE_REPAIR gate on both entry points: the reference's
    ``setup_controllers`` and the port's ``build_manager`` register
    ``slice-repair-controller`` only with ``enable_slice_repair`` (on by
    default), and the port's reads through the manager's cache."""
    from kubeflow_tpu.cluster.store import ClusterStore as RefStore
    from kubeflow_tpu.controllers import setup_controllers
    from kubeflow_tpu.utils.config import ControllerConfig as RefConfig
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.utils.config import ControllerConfig
    assert ControllerConfig().enable_slice_repair is \
        RefConfig().enable_slice_repair is True
    for enable in (False, True):
        ref = setup_controllers(RefStore(),
                                RefConfig(enable_slice_repair=enable))
        port = build_manager(ClusterStore(),
                             ControllerConfig(enable_slice_repair=enable))
        name = "slice-repair-controller"
        assert (name in port._reconcilers) == (name in ref._reconcilers) \
            == enable
        if enable:
            assert port._reconcilers[name]._read_cache is port.read_cache


def test_build_manager_enable_slice_pool_gate():
    """The ENABLE_SLICE_POOL gate on both entry points: the reference's
    ``setup_controllers`` and the port's ``build_manager`` register
    ``slice-pool-controller`` only with ``enable_slice_pool`` (on by
    default), the port's reading through the manager's cache; both
    install the same SlicePool CRD either way."""
    from kubeflow_tpu.cluster.store import ClusterStore as RefStore
    from kubeflow_tpu.controllers import setup_controllers
    from kubeflow_tpu.utils.config import ControllerConfig as RefConfig
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.utils.config import ControllerConfig
    assert ControllerConfig().enable_slice_pool is \
        RefConfig().enable_slice_pool is True
    crd = ("CustomResourceDefinition", "", "slicepools.tpu.kubeflow.org")
    for enable in (False, True):
        ref_store, port_store = RefStore(), ClusterStore()
        ref = setup_controllers(ref_store,
                                RefConfig(enable_slice_pool=enable))
        port = build_manager(port_store,
                             ControllerConfig(enable_slice_pool=enable))
        name = "slice-pool-controller"
        assert (name in port._reconcilers) == (name in ref._reconcilers) \
            == enable
        if enable:
            assert port._reconcilers[name]._read_cache is port.read_cache
        assert normalise(port_store.get(*crd), "port") == \
            normalise(ref_store.get(*crd), "ref")


def test_build_manager_enable_scheduler_gate():
    """The ENABLE_SCHEDULER gate on both entry points: the reference's
    ``setup_controllers`` and the port's ``build_manager`` register
    ``fleet-scheduler`` only with ``enable_scheduler`` (on by default),
    the port's reading through the manager's cache; both install the
    same TPUQuota CRD either way. With the scheduler off the core's
    admission gate is off too: a gang notebook rolls in the drain that
    follows its create, unscheduled and with no SchedulerAdmissionTimeout
    (the grace path of a scheduler that is on but silent is held in
    tests/test_torch_scheduler.py), on both."""
    from kubeflow_tpu.cluster.store import ClusterStore as RefStore
    from kubeflow_tpu.controllers import setup_controllers
    from kubeflow_tpu.utils.config import ControllerConfig as RefConfig
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.utils.config import ControllerConfig
    assert ControllerConfig().enable_scheduler is \
        RefConfig().enable_scheduler is True
    crd = ("CustomResourceDefinition", "", "tpuquotas.tpu.kubeflow.org")
    for enable in (False, True):
        ref_store, port_store = RefStore(), ClusterStore()
        ref = setup_controllers(ref_store,
                                RefConfig(enable_scheduler=enable))
        port = build_manager(port_store,
                             ControllerConfig(enable_scheduler=enable))
        name = "fleet-scheduler"
        assert (name in port._reconcilers) == (name in ref._reconcilers) \
            == enable
        if enable:
            assert port._reconcilers[name]._read_cache is port.read_cache
        assert normalise(port_store.get(*crd), "port") == \
            normalise(ref_store.get(*crd), "ref")
    ref = Stack("ref")
    ref.config = ref.Config(enable_scheduler=False)
    ref.pool_api.install_slicepool_crd(ref.store)
    ref.quota_api.install_tpuquota_crd(ref.store)
    ref.reconciler()
    ref.pool()
    ref.simulator()
    port = Stack("port")
    port.config = port.Config(enable_scheduler=False)
    port.manager = build_manager(port.store, port.config,
                                 simulate_kubelet=True)
    port.timed = True
    for s in (ref, port):
        s.store.create(s.api.new_notebook("job", "ns", annotations={
            s.names.TPU_ACCELERATOR_ANNOTATION: s.accelerator("v5e-16"),
            s.names.SCHED_GANG_ANNOTATION: "2"}))
        s.drain()
        assert s.store.get_or_none("StatefulSet", "ns", "job") is not None
        s.drain(include_delayed_under=0.1)
        nb = s.store.get(s.api.KIND, "ns", "job")
        assert s.k8s.condition_true(nb, s.api.CONDITION_SLICE_READY)
        assert s.k8s.get_annotation(nb, s.names.SCHED_STATE_ANNOTATION) \
            is None
        assert "SchedulerAdmissionTimeout" not in {
            e["reason"] for e in s.store.list("Event", "ns")}
    assert_parity(ref, port)


def test_build_manager_binds_a_warm_h100_1_slice_in_one_reconcile():
    """On ``build_manager``, an h100-1 Notebook created against a Warm
    h100-1 pool is bound by the pool's first reconcile after the create:
    one merge patch on the slice, its pod not rolled (same uid, replicas
    never 0), no BindTimeout, SliceReady on the bound slice, one bind
    latency sample and the SliceBound event."""
    from kubeflow_tpu_torch.api import slicepool as pool_api
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.utils import names
    from kubeflow_tpu_torch.utils.config import ControllerConfig
    store = ClusterStore()
    mgr = build_manager(store, ControllerConfig(), simulate_kubelet=True)
    replicas = []
    store.watch("StatefulSet", lambda ev: replicas.append(
        ev.obj["spec"]["replicas"]) if ev.type != "DELETED" else None)
    store.create(pool_api.new_slice_pool("h100-1-pool", "h100-1", 1))
    mgr.run_until_idle(timeout=10, include_delayed_under=0.01)
    w0 = store.get("StatefulSet", "tpu-slice-pools", "h100-1-pool-w0")
    assert k8s.get_annotation(w0, names.POOL_STATE_ANNOTATION) == "Warm"
    (pod,) = store.list("Pod", "tpu-slice-pools",
                        {"statefulset": k8s.name(w0)})
    reconciles = mgr.metrics.counter("controller_runtime_reconcile_total", "")

    def pool_reconciles():
        return sum(reconciles.get({"controller": "slice-pool-controller",
                                   "result": r})
                   for r in ("success", "requeue_after", "error"))
    before = pool_reconciles()
    at_bind = []     # pool reconciles finished when the bind patch lands

    def on_notebook(ev):
        if not at_bind and pool_api.bound_slice_ref(ev.obj) is not None:
            at_bind.append(pool_reconciles())
    store.watch(api.KIND, on_notebook)
    store.create(api.new_notebook("nb", "ns", annotations={
        names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
    mgr.run_until_idle(timeout=10, include_delayed_under=0.01)
    nb = store.get(api.KIND, "ns", "nb")
    assert pool_api.bound_slice_ref(nb) == ("tpu-slice-pools",
                                            "h100-1-pool-w0")
    assert at_bind == [before]   # in the first pool reconcile
    assert k8s.condition_true(nb, api.CONDITION_SLICE_READY)
    assert k8s.get_annotation(nb, names.POOL_BIND_MISS_ANNOTATION) is None
    assert k8s.get_annotation(nb, names.SLICE_IDENTITY_ANNOTATION) == \
        "localhost"
    (after,) = store.list("Pod", "tpu-slice-pools",
                          {"statefulset": k8s.name(w0)})
    assert k8s.uid(after) == k8s.uid(pod) and 0 not in replicas
    assert store.list("StatefulSet", "ns") == []
    assert mgr.metrics.histogram("slicepool_bind_latency_seconds",
                                 "").total_count() == 1
    assert "SliceBound" in {e["reason"] for e in store.list("Event", "ns")}
