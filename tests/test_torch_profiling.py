"""`utils.profiling.port_kernel_of`: the profiler's kernel names, mangled
and demangled, booked to the port kernel (launch counter) they belong to.
The names are those the card's build gives K1 and K4 (the Hopper body in
bf16 / fp16, the template body in fp32), P1 (both bodies), K2/K3 (the
Hopper backward in bf16 / fp16, K2's reduce kernel included, and the
template in fp32), K5 and K6 (the Hopper dKV and dQ bodies' masked
kernels in bf16 / fp16) and K5/K6 (the backward templates, whose last
flag is the frame mask), P2 (its Hopper body at each tile width and
output type) and Q (the one-read body and the two-read loop); a kernel of
another library books to nothing, no Hopper K2 / K3 kernel books to K5
or K6, and no Hopper kernel but K6's books to K6."""

import pytest

from mmpl_tpu_torch.utils.profiling import port_kernel_of

#: (kernel, launch counter, mangled name, demangled name)
NAMES = [
    ('K1 Hopper', 'flash_fwd',
     '_ZN4mmpl4sm9021flash_fwd_sm90_kernelI13__nv_bfloat16Li128EEEv14CUtensorMap_stS3_S3_NS0_6ParamsE',
     'void mmpl::sm90::flash_fwd_sm90_kernel<__nv_bfloat16, 128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::Params)'),
    ('K1 fp32', 'flash_fwd',
     '_ZN45_GLOBAL__N__176ec67e_12_flash_fwd_cu_c145cf2516flash_fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_PfiiiiN4mmpl10FwdStridesEf',
     'void (anonymous namespace)::flash_fwd_kernel<float, 64>(float const*, float const*, float const*, float*, float*, int, int, int, int, mmpl::FwdStrides, float)'),
    ('K4', 'flash_masked_fwd',
     '_ZN45_GLOBAL__N__176ec67e_12_flash_fwd_cu_c145cf2523flash_masked_fwd_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_PS2_PfiiiiN4mmpl10FwdStridesEfNS7_9FrameMaskE',
     'void (anonymous namespace)::flash_masked_fwd_kernel<__nv_bfloat16, 128>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, int, int, int, int, mmpl::FwdStrides, float, mmpl::FrameMask)'),
    ('K4 Hopper', 'flash_masked_fwd',
     '_ZN4mmpl4sm9028flash_masked_fwd_sm90_kernelI13__nv_bfloat16Li128EEEv14CUtensorMap_stS3_S3_NS0_6ParamsENS_9FrameMaskE',
     'void mmpl::sm90::flash_masked_fwd_sm90_kernel<__nv_bfloat16, 128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::Params, mmpl::FrameMask)'),
    ('P1 Hopper', 'flash_exp2',
     '_ZN4mmpl4sm9022flash_exp2_sm90_kernelI6__halfLi64ELb1ELb0EEEv14CUtensorMap_stS3_S3_NS0_6ParamsE',
     'void mmpl::sm90::flash_exp2_sm90_kernel<__half, 64, true, false>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::Params)'),
    ('P1 fp32', 'flash_exp2',
     '_ZN45_GLOBAL__N__176ec67e_12_flash_fwd_cu_c145cf2517flash_exp2_kernelIfLi64ELb1ELb1EEEvPKT_S3_S3_PS1_iiiiN4mmpl10FwdStridesEf',
     'void (anonymous namespace)::flash_exp2_kernel<float, 64, true, true>(float const*, float const*, float const*, float*, int, int, int, int, mmpl::FwdStrides, float)'),
    ('K2', 'flash_bwd_dkv',
     '_ZN45_GLOBAL__N__8cff8468_12_flash_bwd_cu_5aa6267520flash_bwd_dkv_kernelILi64ELb0EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiNS_7StridesEfN4mmpl9FrameMaskE',
     'void (anonymous namespace)::flash_bwd_dkv_kernel<64, false>(float const*, float const*, float const*, float const*, float const*, float const*, float*, float*, int, int, int, int, (anonymous namespace)::Strides, float, mmpl::FrameMask)'),
    ('K3', 'flash_bwd_dq',
     '_ZN45_GLOBAL__N__8cff8468_12_flash_bwd_cu_5aa6267519flash_bwd_dq_kernelILi128ELb0EEEvPKfS2_S2_S2_S2_S2_PfiiiiNS_7StridesEfN4mmpl9FrameMaskE',
     'void (anonymous namespace)::flash_bwd_dq_kernel<128, false>(float const*, float const*, float const*, float const*, float const*, float const*, float*, int, int, int, int, (anonymous namespace)::Strides, float, mmpl::FrameMask)'),
    ('K2 Hopper', 'flash_bwd_dkv',
     '_ZN4mmpl4sm9025flash_bwd_dkv_sm90_kernelI13__nv_bfloat16Li128EEEv14CUtensorMap_stS3_S3_S3_NS0_9BwdParamsE',
     'void mmpl::sm90::flash_bwd_dkv_sm90_kernel<__nv_bfloat16, 128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::BwdParams)'),
    ('K2 Hopper fp16', 'flash_bwd_dkv',
     '_ZN4mmpl4sm9025flash_bwd_dkv_sm90_kernelI6__halfLi64EEEv14CUtensorMap_stS3_S3_S3_NS0_9BwdParamsE',
     'void mmpl::sm90::flash_bwd_dkv_sm90_kernel<__half, 64>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::BwdParams)'),
    ('K2 reduce', 'flash_bwd_dkv',
     '_ZN4mmpl4sm9027flash_bwd_dkv_reduce_kernelI13__nv_bfloat16EEvNS0_9BwdParamsE',
     'void mmpl::sm90::flash_bwd_dkv_reduce_kernel<__nv_bfloat16>(mmpl::sm90::BwdParams)'),
    ('K2 reduce fp16', 'flash_bwd_dkv',
     '_ZN4mmpl4sm9027flash_bwd_dkv_reduce_kernelI6__halfEEvNS0_9BwdParamsE',
     'void mmpl::sm90::flash_bwd_dkv_reduce_kernel<__half>(mmpl::sm90::BwdParams)'),
    ('K3 Hopper', 'flash_bwd_dq',
     '_ZN4mmpl4sm9024flash_bwd_dq_sm90_kernelI13__nv_bfloat16Li128EEEv14CUtensorMap_stS3_S3_S3_NS0_9BwdParamsE',
     'void mmpl::sm90::flash_bwd_dq_sm90_kernel<__nv_bfloat16, 128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::BwdParams)'),
    ('K3 Hopper fp16', 'flash_bwd_dq',
     '_ZN4mmpl4sm9024flash_bwd_dq_sm90_kernelI6__halfLi64EEEv14CUtensorMap_stS3_S3_S3_NS0_9BwdParamsE',
     'void mmpl::sm90::flash_bwd_dq_sm90_kernel<__half, 64>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::BwdParams)'),
    ('K5', 'flash_masked_bwd_dkv',
     '_ZN45_GLOBAL__N__8cff8468_12_flash_bwd_cu_5aa6267520flash_bwd_dkv_kernelILi128ELb1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiNS_7StridesEfN4mmpl9FrameMaskE',
     'void (anonymous namespace)::flash_bwd_dkv_kernel<128, true>(float const*, float const*, float const*, float const*, float const*, float const*, float*, float*, int, int, int, int, (anonymous namespace)::Strides, float, mmpl::FrameMask)'),
    ('K5 Hopper', 'flash_masked_bwd_dkv',
     '_ZN4mmpl4sm9032flash_masked_bwd_dkv_sm90_kernelI6__halfLi64EEEv14CUtensorMap_stS3_S3_S3_NS0_9BwdParamsENS_9FrameMaskE',
     'void mmpl::sm90::flash_masked_bwd_dkv_sm90_kernel<__half, 64>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::BwdParams, mmpl::FrameMask)'),
    ('K6 Hopper', 'flash_masked_bwd_dq',
     '_ZN4mmpl4sm9031flash_masked_bwd_dq_sm90_kernelI13__nv_bfloat16Li128EEEv14CUtensorMap_stS3_S3_S3_NS0_9BwdParamsENS_9FrameMaskE',
     'void mmpl::sm90::flash_masked_bwd_dq_sm90_kernel<__nv_bfloat16, 128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::BwdParams, mmpl::FrameMask)'),
    ('K6 Hopper fp16', 'flash_masked_bwd_dq',
     '_ZN4mmpl4sm9031flash_masked_bwd_dq_sm90_kernelI6__halfLi64EEEv14CUtensorMap_stS3_S3_S3_NS0_9BwdParamsENS_9FrameMaskE',
     'void mmpl::sm90::flash_masked_bwd_dq_sm90_kernel<__half, 64>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, mmpl::sm90::BwdParams, mmpl::FrameMask)'),
    ('K6', 'flash_masked_bwd_dq',
     '_ZN45_GLOBAL__N__8cff8468_12_flash_bwd_cu_5aa6267519flash_bwd_dq_kernelILi64ELb1EEEvPKfS2_S2_S2_S2_S2_PfiiiiNS_7StridesEfN4mmpl9FrameMaskE',
     'void (anonymous namespace)::flash_bwd_dq_kernel<64, true>(float const*, float const*, float const*, float const*, float const*, float const*, float*, int, int, int, int, (anonymous namespace)::Strides, float, mmpl::FrameMask)'),
    ('P2 Hopper', 'int8_gemm',
     '_ZN4mmpl4sm9021int8_gemm_sm90_kernelILi256E13__nv_bfloat16EEv14CUtensorMap_stS3_S3_PKfS5_PT0_iiii',
     'void mmpl::sm90::int8_gemm_sm90_kernel<256, __nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float const*, __nv_bfloat16*, int, int, int, int)'),
    ('P2 Hopper int32', 'int8_gemm',
     '_ZN4mmpl4sm9021int8_gemm_sm90_kernelILi16EiEEv14CUtensorMap_stS2_S2_PKfS4_PT0_iiii',
     'void mmpl::sm90::int8_gemm_sm90_kernel<16, int>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float const*, int*, int, int, int, int)'),
    ('Q one read', 'quantize_rows',
     '_ZN45_GLOBAL__N__659e34ee_12_int8_gemm_cu_e18906b125quantize_rows_sm90_kernelI13__nv_bfloat16Li8EEEvPKT_PaPfii',
     'void (anonymous namespace)::quantize_rows_sm90_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*, signed char*, float*, int, int)'),
    ('Q two reads', 'quantize_rows',
     '_ZN45_GLOBAL__N__659e34ee_12_int8_gemm_cu_e18906b120quantize_rows_kernelIfEEvPKT_PaPfii',
     'void (anonymous namespace)::quantize_rows_kernel<float>(float const*, signed char*, float*, int, int)'),
]

CASES = ([(f"{k} {form}", name, want)
          for k, want, mangled, demangled in NAMES
          for form, name in (("mangled", mangled), ("demangled", demangled))]
         + [("P2", "void mmpl::sm90::int8_gemm_sm90_kernel<128, float>("
             "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
             "float const*, float*, int, int, int, int)", "int8_gemm"),
            ("Q", "void (anonymous namespace)::quantize_rows_kernel<"
             "__nv_bfloat16>(__nv_bfloat16 const*, signed char*, float*, "
             "int, int)", "quantize_rows"),
            ("library", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize"
             "128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel"
             "__5x_cublas", None),
            ("elementwise", "void at::native::vectorized_elementwise_kernel"
             "<4, at::native::FillFunctor<float>, std::array<char*, 1ul> >"
             "(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
             None)])


@pytest.mark.parametrize("what,name,want", CASES,
                         ids=[c[0] for c in CASES])
def test_port_kernel_of_books_each_kernel_to_its_counter(what, name, want):
    assert port_kernel_of(name) == want, what


@pytest.mark.parametrize("form", [2, 3], ids=["mangled", "demangled"])
def test_only_the_hopper_k6_kernel_books_to_k6(form):
    """Of the Hopper kernels' names, those of `flash_masked_bwd_dq_sm90_kernel`
    and no other book to K6."""
    hopper = [n for n in NAMES if "_sm90_kernel" in n[form]
              or "_reduce_kernel" in n[form]]
    k6 = [n[0] for n in hopper
          if port_kernel_of(n[form]) == "flash_masked_bwd_dq"]
    assert k6 == ["K6 Hopper", "K6 Hopper fp16"]
    assert all("flash_masked_bwd_dq_sm90_kernel" in n[form] for n in hopper
               if n[0] in k6)
