"""PyTorch port, the kernel build module (pointdreamer_tpu_torch/kernels):
what it checks of a built library and what makes it rebuild.  Nothing
here compiles: the CPU has no nvcc."""
import shutil

from pointdreamer_tpu_torch import kernels

# the shape of `cuobjdump -sass` output: a header per function, then its
# instructions
SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_115attn_mma_kernelILi64ELb0EEEvPK13__nv_bfloat16PS1_iif
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   LDSM.16.M88.4 R8, [R2] ;
        /*0110*/                   HMMA.16816.F32.BF16 R12, R8, R4, R12 ;
        /*0120*/                   HMMA.16816.F32.BF16 R16, R8, R6, R16 ;
                Function : _ZN12_GLOBAL__N_115attn_fma_kernelILi16ELb0EEEvPKfPfiif
        /*0100*/                   FFMA R1, R2, R3, R1 ;
                Function : wgmma_kernel
        /*0200*/                   HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], R24 ;
"""


def test_mma_counts_per_function():
    counts = kernels.mma_counts(SASS)
    assert counts == {
        "_ZN12_GLOBAL__N_115attn_mma_kernelILi64ELb0EEEvPK13__nv_bfloat16PS1_iif": 2,
        "_ZN12_GLOBAL__N_115attn_fma_kernelILi16ELb0EEEvPKfPfiif": 0,
        "wgmma_kernel": 1}


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    # the kernels include csrc/tc.cuh: editing it must give a new library
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    before = kernels._source_hash()
    with open(csrc / "tc.cuh", "a") as f:
        f.write("\n// edited\n")
    assert kernels._source_hash() != before
