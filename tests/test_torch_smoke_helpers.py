"""chip_smoke's readers of what the card and the compiler report: the
profiler's kernel names mapped to the port's kernel classes (phases 4 and
7), and ptxas's registers and spills per kernel (printed after the
build; a tensor-core kernel that spills fails the run)."""

from __future__ import annotations

import pytest

from chip_smoke import _kernel_class, ptxas_report


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_fwd_kernel_wgmma<128>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, "
     "float*, int, int, long, long, long, float, int)",
     "flash_attention (ours)"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel_wgmma<128>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, __nv_bfloat16*, __nv_bfloat16*, int, "
     "int, (anonymous namespace)::Strides, (anonymous namespace)::Strides,"
     " float, int)", "flash_attention_bwd_dkv (ours)"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel_wgmma<128>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, __nv_bfloat16*, int, int, (anonymous "
     "namespace)::Strides, float, int)", "flash_attention_bwd_dq (ours)"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<128>(float const*, "
     "float const*, float const*, float const*, float const*, float "
     "const*, float*, int, int, (anonymous namespace)::Strides, (anonymous"
     " namespace)::Strides, (anonymous namespace)::Strides, (anonymous "
     "namespace)::Strides, (anonymous namespace)::Strides, float, int)",
     "flash_attention_bwd_dq (ours)"),
    ("void (anonymous namespace)::flash_decode_kernel<__nv_bfloat16, "
     "__nv_bfloat16, 128, 2, false>(__nv_bfloat16 const*, __nv_bfloat16 "
     "const*, __nv_bfloat16 const*, float const*, float const*, int const*,"
     " float*, int, int, (anonymous namespace)::Strides, float)",
     "flash_decode (ours)"),
    ("void (anonymous namespace)::flash_decode_kernel_combine<"
     "__nv_bfloat16, 128, 2>(float const*, int const*, __nv_bfloat16*, "
     "int, int, int)", "flash_decode (ours)"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "matmul (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>", "elementwise/other"),
])
def test_kernel_class_names_each_of_our_kernels(name, cls):
    assert _kernel_class(name) == cls


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__flash_bwd_dq_kernel_wgmmaILi128EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN55_GLOBAL__N__flash_bwd_dq_kernel_wgmmaILi128EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 198 registers, used 1 barriers, 48 bytes smem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__flash_bwd_dq_kernelILi128EEEvPKfS2_' for 'sm_90a'
    24 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 32768 bytes smem
"""


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    """Both layouts of nvcc's report: with and without a "Function
    properties" line between the entry line and the spill line."""
    got = ptxas_report(_PTXAS_LOG)
    assert got == {
        "_ZN55_GLOBAL__N__flash_bwd_dq_kernel_wgmmaILi128EEEv14CUtensorMap_st":
            (198, 0, 0),
        "_ZN55_GLOBAL__N__flash_bwd_dq_kernelILi128EEEvPKfS2_": (255, 16, 12),
    }


def test_phase15_cull_sequence_on_the_cpu():
    """chip_smoke's phase-15 culler drive (``_cull_sequence`` behind its
    ``_KubectlProxy``) on the CPU at a tiny size: the port's
    ``build_manager`` under ``start()``, a culler on an advanced clock,
    an h100-1 notebook served by a CPU engine behind ``ServingServer``
    kept up past the cull time by its traffic, then it and an h100-16
    notebook culled at one check. Every server stops in a ``finally``."""
    import time

    import torch

    from chip_smoke import (_KubectlProxy, _cull_sequence,
                            _served_port_resolver)
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.controllers import CullingReconciler
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       init_params)
    from kubeflow_tpu_torch.runtime.server import ServingServer
    from kubeflow_tpu_torch.runtime.serving import ContinuousBatchedGenerator
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import ControllerConfig

    c = TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), c, device="cpu")
    store = ClusterStore()
    proxy = _KubectlProxy(_served_port_resolver(store))
    server = None
    try:
        config = ControllerConfig(dev_mode=True, dev_proxy_url=proxy.url,
                                  cull_idle_time_min=60,
                                  idleness_check_period_min=1,
                                  jupyter_probe_timeout_s=5.0)
        mgr, _ = build_manager(store, config, simulate_kubelet=True,
                               components="core")
        offset = [0.0]
        CullingReconciler(mgr.client, config, mgr.metrics,
                          clock=lambda: time.time() + offset[0]).setup(mgr)
        mgr.start()
        try:
            for name, shape in (("smoke", "h100-1"), ("smoke-big", "h100-16")):
                store.create(api.new_notebook(name, "user-ns", annotations={
                    names.TPU_ACCELERATOR_ANNOTATION: shape}))
            deadline = time.monotonic() + 30
            while not all(k8s.condition_true(
                    store.get(api.KIND, "user-ns", n), "SliceReady")
                    for n in ("smoke", "smoke-big")):
                assert time.monotonic() < deadline, "never SliceReady"
                time.sleep(0.01)
            gen = ContinuousBatchedGenerator(params, c, n_slots=8,
                                             device="cpu")
            server = ServingServer(gen, c, port=0).start()
            out = _cull_sequence(store, mgr, offset, config, server.url,
                                 server.port, c.vocab_size, "user-ns",
                                 "smoke", "smoke-big")
        finally:
            mgr.stop()
    finally:
        if server is not None:
            server.stop()
        proxy.close()
    assert out["requests_total"] == [8, 16, 16]
    assert out["culled_total"] == {"smoke": 1, "smoke-big": 1}
    assert out["credited"]["idle_jupyter_s"] > 60 * 60
    assert not proxy.refused
    assert any(p.endswith(":%d/proxy/healthz" % server.port)
               for p in proxy.seen)
    for name in ("smoke", "smoke-big"):
        assert store.get("StatefulSet", "user-ns", name)["spec"][
            "replicas"] == 0


def test_phase16_repair_and_quarantine_on_the_cpu():
    """chip_smoke's phase-16 control-plane drive on the CPU: the port's
    ``build_manager`` (its slice repair reconciler on) under ``start()``
    gates an h100-1 notebook's pod on a gloo world the gate forms for it
    (world A); ``_repair_sequence`` kills the worker's node, the slice is
    rolled whole 1 -> 0 -> 1 and the gate ends world A and forms world B
    for the new pod; then ``_quarantine_sequence`` on a second stack
    quarantines a wedged h100-8 notebook after two timed-out repairs,
    starts no repair while quarantined and recovers it once cleared.
    Every manager stops and the world ends in a ``finally``."""
    import time

    import torch.distributed as dist

    from chip_smoke import _quarantine_sequence, _repair_sequence, _SliceGate
    from kubeflow_tpu_torch.api import types as api
    from kubeflow_tpu_torch.cluster.store import ClusterStore
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.parallel.mesh import leave_world
    from kubeflow_tpu_torch.utils import k8s, names
    from kubeflow_tpu_torch.utils.config import ControllerConfig

    assert not dist.is_initialized()
    store = ClusterStore()
    gate = _SliceGate("trainer", device="cpu")
    mgr, _ = build_manager(store, ControllerConfig(), simulate_kubelet=True,
                           ready_hook=gate, components="core")
    try:
        mgr.start()
        try:
            store.create(api.new_notebook("trainer", "repair-ns",
                                          annotations={
                names.TPU_ACCELERATOR_ANNOTATION: "h100-1"}))
            deadline = time.monotonic() + 60
            while not k8s.condition_true(
                    store.get(api.KIND, "repair-ns", "trainer"),
                    api.CONDITION_SLICE_READY):
                assert gate.error is None, gate.error
                assert time.monotonic() < deadline, "never SliceReady"
                time.sleep(0.01)
            world_a = dist.group.WORLD
            rep = _repair_sequence(store, mgr, gate, "repair-ns", "trainer",
                                   timeout=60.0)
            assert dist.group.WORLD is not world_a
        finally:
            mgr.stop()
        q = _quarantine_sequence()
    finally:
        if dist.is_initialized():
            leave_world()
    assert rep["replicas"] == [1, 0, 1]
    assert [w["report"]["backend"] for w in gate.worlds] == ["gloo", "gloo"]
    assert gate.worlds[0]["uid"] != gate.worlds[1]["uid"]
    assert rep["repairs_total"] == 1 and rep["repair_duration_samples"] == 1
    assert q["replicas"][-1] == 1 and q["quarantines_total"] == 1
    assert q["repairs_at_quarantine"] == q["repairs_after_checks"] == 2


def test_phase18_fleet_scheduler_on_the_cpu():
    """chip_smoke's phase-18 drive (``_sched_sequence``) on the CPU at a
    tiny size, gloo worlds for the ready hook: on ``build_manager`` with
    the fleet scheduler and a capacity of one slice, notebook ds is held
    by its tenant's TPUQuota of 0 (no StatefulSet, no
    SchedulerAdmissionTimeout past the grace), notebook train is admitted
    in two phases, rolled and trains 4 steps in its world bit-equal to
    one device; with the quota raised ds waits for capacity and train is
    not preempted; train deleted, ds is reserved by its first pass after
    the deletion, rolled into its own world and generates ids equal to
    one device's. The manager stops and every world ends in a
    ``finally``."""
    import torch
    import torch.distributed as dist

    from chip_smoke import _sched_sequence
    from kubeflow_tpu_torch.models.train import TrainConfig
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    assert not dist.is_initialized()
    c = TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype="float32")
    stats, launched = _sched_sequence(torch, c, TrainConfig(warmup_steps=2),
                                      2, 32, 8, 4, device="cpu",
                                      timeout=60.0)
    assert not dist.is_initialized()
    assert stats["denied"]["state"] == "Pending"
    assert stats["denied"]["quota_denied"] >= 1
    assert stats["train_states"] == ["Pending", "Reserving", "Admitted"]
    assert len(stats["losses"]) == 4
    assert stats["no_capacity"]["quota_used"] == {"team-train": 1,
                                                  "team-ds": 0}
    assert stats["ds_passes_after_delete"][0] == ("Pending", "Reserving")
    assert stats["ids_equal"]
    assert [w["report"]["backend"] for w in
            (stats["world_train"], stats["world_ds"])] == ["gloo", "gloo"]
    admissions = dict(stats["admissions"])
    assert admissions.pop("team-ds/quota-denied") >= 1
    assert admissions.pop("team-ds/no-capacity") >= 1
    assert admissions == {"team-train/admitted": 1, "team-ds/admitted": 1}
    assert stats["gang_wait_s"]["team-ds"][0] == 1
    assert stats["gang_wait_s"]["team-ds"][1] > \
        stats["gang_wait_s"]["team-train"][1]
    # on the CPU the wrappers take their plain versions: nothing launched
    assert not any(launched.values())


def test_phase19_extension_tier_on_the_cpu():
    """chip_smoke's phase-19 drive (``_ext_sequence``) on the CPU at a
    tiny size, a gloo world for the ready hook: on
    ``build_manager(components="all")`` notebook wb, created with the
    reconciliation lock and auth on, stays at 0 replicas with no pod
    until the extension has provisioned its finalizers, auth objects,
    NetworkPolicies, route, ReferenceGrant, trust bundle (the valid
    block only) and runtime images; then it is unlocked, rolled 0 → 1
    and trains 2 steps in its world bit-equal to one device; auth off
    replaces the route by a plain one without rolling the pod; its
    generate equals one device's; deleted, it leaves no route, grant or
    binding behind. The manager stops and the world ends in a
    ``finally``."""
    import torch
    import torch.distributed as dist

    from chip_smoke import _VALID_PEM, _ext_sequence
    from kubeflow_tpu_torch.models.train import TrainConfig
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    assert not dist.is_initialized()
    c = TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype="float32")
    stats, launched = _ext_sequence(torch, c, TrainConfig(warmup_steps=2),
                                    2, 32, 8, 4, device="cpu", timeout=60.0)
    assert not dist.is_initialized()
    assert stats["while_locked"] == {"replicas": [0], "pods": 0}
    at_unlock = stats["at_unlock"]
    assert len(at_unlock["finalizers"]) == 3
    assert at_unlock["tls_target_port"] == 8443
    assert at_unlock["routes"] == [("kubeflow-tpu-system", "wb-tls", 443)]
    assert at_unlock["ca_bundle"] == _VALID_PEM + "\n"
    assert at_unlock["runtime_images"] == ["pytorch-cuda.json"]
    assert 0 < stats["ready_ms"]["lock_removed"] < \
        stats["ready_ms"]["slice_ready"]
    assert stats["world"]["report"]["backend"] == "gloo"
    assert len(stats["losses"]) == 2
    assert stats["auth_off"]["routes"] == [("kubeflow-tpu-system", "wb", 80)]
    assert len(stats["auth_off"]["pod_uids"]) == 1
    assert stats["auth_off"]["replicas"] == [0, 1]
    assert stats["ids_equal"]
    assert not any(stats["after_delete"].values())
    ext_writes = stats["extension"]["writes"]
    assert ext_writes["HTTPRoute/create"] == 2
    assert ext_writes["HTTPRoute/delete"] >= 2
    assert ext_writes["ClusterRoleBinding/delete"] >= 1
    assert ext_writes["Notebook/patch"] == 1       # the lock, once
    # on the CPU the wrappers take their plain versions: nothing launched
    assert not any(launched.values())


def test_phase20_admission_on_the_cpu():
    """chip_smoke's phase-20 drive (``_admission_sequence``) on the CPU at
    a tiny size, a gloo world for the ready hook: the AdmissionReview
    server's JSONPatch equals ``handle()`` (lock, CUDA image, original
    recorded, sidecar at its default resources), h100-3 is denied 403
    and a body that is not JSON gets 400; on ``build_manager(
    components="all", webhooks=True)`` notebook adm, created with no
    lock, is stored locked with the CUDA image and the sidecar, stays at
    0 replicas with no pod until the extension unlocks it, rolls 0 → 1
    and trains in its world; its generate equals one device's; a label
    touch after the trust bundle appears parks the CA mount without
    touching the template, the pod or the world, and a third step stays
    bit-equal to one device; a resize and the MLflow removal are denied
    while it runs; stopped, the parked mount is applied; deleted, it
    leaves nothing. The manager stops and the world ends in a
    ``finally``."""
    import torch
    import torch.distributed as dist

    from chip_smoke import _admission_sequence
    from kubeflow_tpu_torch.models.train import TrainConfig
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.utils.config import DEFAULT_GPU_IMAGE

    assert not dist.is_initialized()
    c = TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype="float32")
    stats, launched = _admission_sequence(
        torch, c, TrainConfig(warmup_steps=2), 2, 32, 8, 4, device="cpu",
        timeout=60.0)
    assert not dist.is_initialized()
    server = stats["server"]
    assert len(server["review_ms"]) == 20
    assert server["image"] == stats["admitted"]["image"] == DEFAULT_GPU_IMAGE
    assert server["denied"][2]["code"] == 403 and server["not_json"] == 400
    assert stats["admitted"]["lock"] == "odh-notebook-controller-lock"
    assert stats["admitted"]["containers"] == ["adm", "kube-rbac-proxy"]
    assert stats["while_locked"] == {"replicas": [0], "pods": 0}
    assert 0 < stats["ready_ms"]["lock_removed"] < \
        stats["ready_ms"]["slice_ready"]
    assert stats["world"]["report"]["backend"] == "gloo"
    assert len(stats["losses"]) == 3 and stats["ids_equal"]
    assert stats["parked"]["pending"] and \
        not stats["parked"]["trusted_ca_mounted"]
    assert stats["untouched"]["worlds"] == 0
    assert [code for code, _ in stats["denied"].values()] == [403, 403]
    assert stats["stopped"] == {"pending": None, "trusted_ca_mounted": True,
                                "applied_is_parked": True}
    assert not any(stats["after_delete"].values())
    # on the CPU the wrappers take their plain versions: nothing launched
    assert not any(launched.values())


def test_phase21_tracing_on_the_cpu():
    """chip_smoke's phase-21 drive (``_trace_sequence``) on the CPU at a
    tiny size, a gloo world for the ready hook: on ``build_manager(
    components="all", webhooks=True)`` with a recording provider (the
    port's flight recorder in front of its OTLP exporter, posting to a
    local collector), notebook trc is locked and swapped by the webhook,
    stamped once with the trace-context annotation and rolled; the
    health server's debug endpoint serves the stamped trace with every
    root a later Notebook event caused, its breakdown sums, the
    collector holds the recorder's spans and the webhook's span with its
    image-swapped event, a queue-duration exemplar carries the stamped
    trace id and the JSON log lines of trc's reconciles carry its key
    and a trace id; 2 steps and generate equal one device's; deleted, it
    leaves nothing, and the no-op provider is back. Then two small
    fleets in turns, untraced and recorded: every notebook traced, the
    recorder within its bound."""
    import torch
    import torch.distributed as dist

    from chip_smoke import _trace_sequence, _traced_fleets
    from kubeflow_tpu_torch.models.train import TrainConfig
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.utils import tracing

    assert not dist.is_initialized()
    c = TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype="float32")
    stats, launched = _trace_sequence(
        torch, c, TrainConfig(warmup_steps=2), 2, 32, 8, 4, device="cpu",
        timeout=60.0)
    assert not dist.is_initialized() and not tracing.is_recording()
    assert stats["stamp"]["values"] and not stats["stamp"]["rewritten"]
    assert stats["trace"]["joined_roots"] >= 1
    assert stats["trace"]["joined_in_stamped"] == \
        stats["trace"]["joined_roots"]
    b = stats["breakdown"]["sum"]
    assert stats["breakdown"]["roots"] >= 1
    assert abs(b["queue"] + b["wire"] + b["reconcile"] - b["wall"]) <= 1e-9
    assert stats["exported"]["image_swapped"] >= 1
    assert stats["exemplars"] >= 1
    assert stats["logs"]["trc"] >= 1
    assert stats["logs"]["trc_with_trace_id"] == stats["logs"]["trc"]
    assert len(stats["losses"]) == 2 and stats["ids_equal"]
    assert not any(stats["after_delete"].values())
    assert not any(launched.values())
    fleets = _traced_fleets({"h100-1": 6, "h100-8": 3, "h100-16": 1},
                            runs=2)
    assert [f["recorded"] for f in fleets] == [False, True]
    assert fleets[0]["spans"] == 0 and fleets[1]["spans"] > 0
    assert fleets[1]["notebooks_traced"] == 10
    assert 0 < fleets[1]["traces_held"] <= 512
    assert not tracing.is_recording()


def test_phase22_wire_on_the_cpu():
    """chip_smoke's phase-22 drive (``_wire_sequence``) on the CPU at a
    tiny size, a gloo world for the ready hook: the port's apiserver over
    its sharded store beside ``build_manager(components="all",
    webhooks=True)``; notebook wir POSTed over HTTP is answered locked
    with the CUDA image and rolled; its JSON and binary watches agree up
    to SliceReady; a resume from the last rv read replays exactly the
    frames missed; resumes past an 8-frame ring and from an rv never
    issued answer 410; 2 steps and generate equal one device's; the
    culler's probes all go through the apiserver's service proxy (to a
    Jupyter stand-in and the serving server) and cull both notebooks;
    deleted over HTTP, nothing is left. Then two small fleets, on 8
    shards over HTTP (paged LIST, rv=0 from the cache, a malformed
    continue 422) and on 1."""
    import torch
    import torch.distributed as dist

    from chip_smoke import _wire_fleets, _wire_sequence
    from kubeflow_tpu_torch.models.train import TrainConfig
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    assert not dist.is_initialized()
    c = TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype="float32")
    stats, launched = _wire_sequence(
        torch, c, TrainConfig(warmup_steps=2), 2, 32, 8, 4, device="cpu",
        timeout=60.0)
    assert not dist.is_initialized()
    assert stats["streams"]["json"]["events"] == \
        stats["streams"]["binary"]["events"] > 0
    assert stats["streams"]["binary"]["bytes_per_event"] < \
        stats["streams"]["json"]["bytes_per_event"]
    assert stats["resume"]["replayed"] >= 1 and stats["resume"]["patch_in_it"]
    assert {v[0] for v in stats["gone"].values()} == {410}
    assert len(stats["losses"]) == 2 and stats["ids_equal"]
    assert stats["culling"]["requests_total"] == [8, 16, 16]
    probes = stats["culling"]["probes"]
    assert probes["through_the_apiserver"] == \
        probes["jupyter"] + probes["healthz"] > 0
    assert not any(v for k, v in stats["after_delete"].items()
                   if k != "get_status")
    assert not any(launched.values())
    fleets = _wire_fleets({"h100-1": 6, "h100-8": 3, "h100-16": 1},
                          shards=(8, 1))
    assert [f["shards"] for f in fleets] == [8, 1]
    assert fleets[0]["http"]["paged_equal"] and \
        fleets[0]["http"]["pages"] == 2
    assert fleets[0]["http"]["rv0_from_cache"] == 1
    assert fleets[0]["http"]["malformed_continue"][0] == 422
    assert all(f["write_lock"]["count"] > 0 for f in fleets)
    assert fleets[0]["fanout"]["binary"]["bytes_per_frame"] < \
        fleets[0]["fanout"]["json"]["bytes_per_frame"]


def test_phase23_http_on_the_cpu():
    """chip_smoke's phase-23 drive (``_http_sequence``) on the CPU at a
    tiny size, a gloo world for the ready hook: the manager on the port's
    ``HttpApiClient`` against the port's apiserver; notebook wcl created
    through a second client is answered locked with the CUDA image after
    one mutating and one validating AdmissionReview over HTTP, unlocked,
    rolled and read SliceReady through the manager's cache; 2 steps and
    generate equal one device's; its stitched trace has ``rest.*`` spans
    and a ``wire`` leg above 0 and the audit log carries its trace id;
    across an apiserver restart every watch resumes without a relist and
    a notebook created during the outage turns SliceReady; deleted,
    nothing is left. Then a small fleet over JSON and one over binary,
    each under the 60 requests a notebook of the reference's bound, the
    echo filters dropping echoes."""
    import torch
    import torch.distributed as dist

    from chip_smoke import _http_fleet, _http_sequence
    from kubeflow_tpu_torch.models.train import TrainConfig
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    from kubeflow_tpu_torch.utils import tracing

    assert not dist.is_initialized()
    c = TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype="float32")
    stats, launched = _http_sequence(
        torch, c, TrainConfig(warmup_steps=2), 2, 32, 8, 4, device="cpu",
        timeout=60.0)
    assert not dist.is_initialized() and not tracing.is_recording()
    assert stats["admitted"]["reviews"] == {"/mutate-notebook-v1": 1,
                                            "/validate-notebook-v1": 1}
    assert len(stats["losses"]) == 2 and stats["ids_equal"]
    assert stats["trace"]["rest_spans"] and \
        stats["trace"]["breakdown"]["wire"] > 0
    assert stats["audit"]["with_wcl_trace_id"] > 0
    assert stats["resumes"]["resume"] >= 1 and \
        stats["resumes"]["relist"] == 0
    assert not any(v for nb in stats["after_delete"].values()
                   for v in nb.values())
    assert stats["requests_bringup"].get("POST", 0) > 0
    assert not any(launched.values())
    echoes = 0
    for fmt in ("json", "binary"):
        fleet = _http_fleet({"h100-1": 6, "h100-8": 3, "h100-16": 1},
                            wire_format=fmt)
        assert fleet["notebooks"] == 10
        assert 0 < fleet["requests_per_notebook"] < 60, fleet
        assert fleet["connections"]["pooled"] >= 1
        echoes += sum(fleet["echoes_dropped"].values())
    # over the wire a write returns before its event: echoes to drop
    assert echoes > 0


def test_phase24_binaries_on_the_cpu():
    """chip_smoke's phase-24 drive (``_binary_sequence``) on the CPU at a
    tiny size, a gloo world for the ready hook, with the processes: two
    core managers and an extension manager spawned as ``python -m
    kubeflow_tpu_torch.main`` against the port's apiserver in this
    process; one ``cli apply`` registers E's webhooks and creates the
    notebook, stored locked with the CUDA image; the leader rolls it (the
    standby reconciles nothing), ``cli get -o json`` reads SliceReady;
    2 steps and generate equal one device's; ``cli trace`` shows the
    stamped trace; SIGTERM hands the Lease over well under its duration;
    ``cli stop`` goes through the new leader; an apiserver outage opens
    and the restart closes its breaker, with a resync; ``cli delete``
    leaves nothing; every process exits 0 and releases its Lease."""
    import torch
    import torch.distributed as dist

    from chip_smoke import _binary_sequence
    from kubeflow_tpu_torch.models.train import TrainConfig
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    assert not dist.is_initialized()
    c = TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype="float32")
    stats, launched = _binary_sequence(
        torch, c, TrainConfig(warmup_steps=2), 2, 32, 8, 4, device="cpu",
        timeout=120.0)
    assert not dist.is_initialized()
    assert stats["cli_get"] == {"rc": 0, "SliceReady": "True"}
    assert stats["reconciles"]["leader"] > 0 == \
        stats["reconciles"]["standby"]
    assert len(stats["losses"]) == 2 and stats["ids_equal"]
    assert stats["cli_trace"]["stamped_shown"]
    assert stats["handover_ms"] < 3000
    assert stats["breaker_state_open"] == 2.0
    assert stats["breaker"]["resync_retries"] > 0
    assert not any(stats["after_delete"].values())
    assert stats["exited"] == {"a": 0, "b": 0, "e": 0}
    assert not any(launched.values())
