"""The port's native build (kubernetes_tpu_torch/native/build.py) on the
CPU: a CUDA library is rebuilt whenever its source, a csrc/ header it
includes or NVCC_FLAGS change, and reused otherwise; ptxas's report is
read back per kernel. nvcc itself runs only on the card's machine."""

import pytest

from kubernetes_tpu_torch.native import build as B

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z21resource_probe_kernelPKxS0_S0_PyPxiiixxi' for 'sm_90a'
ptxas info    : Function properties for _Z21resource_probe_kernelPKxS0_S0_PyPxiiixxi
    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 1024 bytes smem, 464 bytes cmem[0]
ptxas info    : Function properties for _Z9floor_divxx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z5otherPx' for 'sm_90a'
ptxas info    : Used 12 registers, 360 bytes cmem[0]
"""


def test_parse_ptxas_reads_one_kernel():
    assert B.parse_ptxas(PTXAS_LOG, "resource_probe_kernel") == {
        "stack": 16, "spill_stores": 4, "spill_loads": 8,
        "registers": 72, "smem": 1024}
    assert B.parse_ptxas(PTXAS_LOG, "other") == {"registers": 12}
    assert B.parse_ptxas(PTXAS_LOG, "missing") == {}


SASS = """\
\t\tFunction : _Z23victim_score_kernel_segILi8EEvPKi
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000e220000000800 */
        /*0010*/              @!P0 SHFL.BFLY PT, R3, R2, 0x1, 0x1f ; /* 0x0c201f0002037f89 */
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;     /* 0x0000000000007b1d */
        /*0030*/               @P1 LDG.E R4, desc[UR4][R2.64] ;      /* 0x0000000402047981 */
        /*0040*/                   EXIT ;                            /* 0x000000000000794d */
        /*0050*/                   NOP;                              /* 0x0000000000007918 */
\t\tFunction : _Z23victim_score_kernel_segILi16EEvPKi
        /*0000*/                   SHFL.IDX PT, R3, R2, R0, 0x1f ;   /* 0x0000000002037f89 */
"""


def test_parse_sass_counts_one_kernel():
    assert B.parse_sass(SASS, "victim_score_kernel_segILi8E") == {
        "instructions": 5, "SHFL": 1, "BAR": 1, "LDG": 1, "STG": 0,
        "LDS": 0, "STS": 0, "VOTE": 0}
    assert B.parse_sass(SASS, "segILi16E")["instructions"] == 1
    assert B.parse_sass(SASS, "missing") == {}


@pytest.fixture
def sources(tmp_path):
    src = tmp_path / "k.cu"
    hdr = tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n__global__ void k() {}\n')
    hdr.write_text("#define X 1\n")
    return src, hdr


def test_build_key_follows_source_header_and_flags(sources, monkeypatch):
    src, hdr = sources
    key = B.cuda_build_key(str(src))
    assert B.cuda_build_key(str(src)) == key
    hdr.write_text("#define X 2\n")
    key_hdr = B.cuda_build_key(str(src))
    assert key_hdr != key
    src.write_text(src.read_text() + "// note\n")
    key_src = B.cuda_build_key(str(src))
    assert key_src not in (key, key_hdr)
    monkeypatch.setattr(B, "NVCC_FLAGS", B.NVCC_FLAGS + ("-lineinfo",))
    assert B.cuda_build_key(str(src)) not in (key, key_hdr, key_src)


def test_build_reuses_only_the_same_build(sources, tmp_path, monkeypatch):
    """A library whose key matches (with its log) is reused without nvcc;
    after a change the build needs nvcc, which is absent here."""
    src, hdr = sources
    monkeypatch.setattr(B, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(B, "_nvcc_path", lambda: "/nonexistent/nvcc")
    (tmp_path / "out").mkdir()
    out = tmp_path / "out" / f"libk-{B.cuda_build_key(str(src))}.so"
    out.write_bytes(b"")
    out.with_suffix(".log").write_text(PTXAS_LOG)
    assert B.build_cuda_file(str(src), "k") == str(out)
    assert B.ptxas_report(str(out), "resource_probe_kernel")["registers"] == 72
    hdr.write_text("#define X 3\n")
    with pytest.raises(OSError):
        B.build_cuda_file(str(src), "k")


def test_kernel_source_is_keyed_with_ptxas_report():
    assert "-v" in B.NVCC_FLAGS and "--fmad=false" in B.NVCC_FLAGS
    assert len(B.cuda_build_key(f"{B._PKG_DIR}/csrc/probe_kernel.cu")) == 16
