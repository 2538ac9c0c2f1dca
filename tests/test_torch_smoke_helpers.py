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
