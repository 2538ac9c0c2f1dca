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
        mgr = build_manager(store, config, simulate_kubelet=True)
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
    mgr = build_manager(store, ControllerConfig(), simulate_kubelet=True,
                        ready_hook=gate)
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
