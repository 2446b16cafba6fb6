"""``chip_smoke.py``'s SASS counter on a canned ``cuobjdump -sass``
excerpt (no card, no toolkit): flash, built on warpgroup products, must
hold HGMMA; the decode kernels, built on mma.sync, HMMA.  An instruction
of the other kind does not count for a kernel."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

_NS = "_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_41edf866"
SASS = f"""
	code for sm_90a
		Function : {_NS}12flash_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiiiifi
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0f70*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0f80*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*1a00*/                   HGMMA.64x128x16.F32.BF16 R88, R20, gdesc[UR12], R88, gsb0 ;
        /*1a10*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
		Function : {_NS}12flash_kernelILi16EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiiiifi
        /*0900*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
		Function : _ZN51_GLOBAL__N__7e3a1c2b_19_decode_attention_cu_5c3b1a2018decode_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_PKiiiiiif
        /*0a10*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0a20*/                   HMMA.16816.F32.BF16 R16, R4, R14, R16 ;
        /*0a30*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0a40*/                   LDSM.16.M88.4 R4, [R2] ;
"""


def test_sass_counter_counts_each_kernels_own_tensor_op():
    counts, lines = chip_smoke.sass_counts(SASS)
    assert counts == {"flash_kernel<128>": 3, "flash_kernel<16>": 0,
                      "decode_bf16_kernel<64>": 2}
    assert len(lines["decode_bf16_kernel<64>"]) == 4
    assert chip_smoke.tensor_op("flash_kernel<32>") == "HGMMA"
    assert chip_smoke.tensor_op("paged_decode_q8_kernel<128>") == "HMMA"
    assert chip_smoke.tensor_op("wkv6_chunked_kernel") == "HMMA"


_DECODE = "_ZN51_GLOBAL__N__7e3a1c2b_19_decode_attention_cu_5c3b1a20"
TMA_SASS = f"""
	code for sm_90a
		Function : {_DECODE}24paged_decode_bf16_kernelILi128EEEv14CUtensorMap_stS1_PK13__nv_bfloat16PKiS6_PS2_iiiiiiif
        /*0400*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0410*/                   UTMALDG.4D [UR16], [UR12] ;
        /*0a10*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
		Function : {_DECODE}18decode_bf16_kernelILi16EEEv14CUtensorMap_stS1_PK13__nv_bfloat16PKiPS2_iiiiiif
        /*0a10*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0a20*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR6][R4.64] ;
		Function : {_DECODE}16decode_q8_kernelILi128EEEvPK13__nv_bfloat16PKaS5_S3_S3_PKiPfS8_iiiif
        /*0400*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0a10*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
"""


def test_tma_load_counter_counts_the_tma_kernels():
    """UTMALDG is counted for flash and all four decode kernels (bf16 and
    int8 load their tiles by TMA): a decode kernel without one is what the
    smoke fails on."""
    counts, lines = chip_smoke.sass_counts(TMA_SASS)
    assert counts == {"paged_decode_bf16_kernel<128>": 1,
                      "decode_bf16_kernel<16>": 1,
                      "decode_q8_kernel<128>": 1}
    assert chip_smoke.tma_loads(lines) == {
        "paged_decode_bf16_kernel<128>": 2, "decode_bf16_kernel<16>": 0,
        "decode_q8_kernel<128>": 1}
    assert {"flash_kernel", "decode_bf16_kernel", "paged_decode_bf16_kernel",
            "decode_q8_kernel", "paged_decode_q8_kernel"} == set(
                chip_smoke.TMA_KERNELS)
