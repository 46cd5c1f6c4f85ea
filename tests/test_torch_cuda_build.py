"""The build key of the hand-written kernels (``kernels/cuda_build.py``):
a library is keyed by its source and every ``csrc`` header it includes, so
editing the int8 kernels' shared header (``csrc/int8_mma.cuh``) rebuilds
each of them and nothing else.  Runs on copies of ``csrc`` under the test's
temporary directory; nothing is compiled."""
import shutil

import pytest

from repro_torch.kernels import cuda_build

INT8 = ("bitserial_gemm", "bitserial_gemm_a4", "quant_gemm")


@pytest.fixture
def csrc(tmp_path):
    """A copy of the kernels' sources."""
    return shutil.copytree(cuda_build._CSRC, tmp_path / "csrc")


def test_every_kernel_has_a_source():
    for name in cuda_build._SIGNATURES:
        assert (cuda_build._CSRC / f"{name}.cu").is_file()


def test_key_is_the_text_not_the_place(csrc):
    for name in cuda_build._SIGNATURES:
        assert (cuda_build._lib_path(name, csrc)
                == cuda_build._lib_path(name))


def test_editing_the_shared_header_changes_the_int8_keys_only(csrc):
    before = {n: cuda_build._lib_path(n, csrc) for n in cuda_build._SIGNATURES}
    header = csrc / "int8_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build._lib_path(n, csrc) for n in cuda_build._SIGNATURES}
    for name in INT8:
        assert after[name] != before[name]
        assert after[name].name.startswith(f"lib{name}-")
    assert after["flash_attention"] == before["flash_attention"]


def test_editing_a_source_changes_its_key_only(csrc):
    before = {n: cuda_build._lib_path(n, csrc) for n in INT8}
    source = csrc / "quant_gemm.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    after = {n: cuda_build._lib_path(n, csrc) for n in INT8}
    assert after["quant_gemm"] != before["quant_gemm"]
    assert after["bitserial_gemm"] == before["bitserial_gemm"]
    assert after["bitserial_gemm_a4"] == before["bitserial_gemm_a4"]


def test_headers_are_followed_through_their_includes(csrc):
    """A header included by the shared header counts too."""
    (csrc / "extra.cuh").write_text("// one\n")
    header = csrc / "int8_mma.cuh"
    header.write_text('#include "extra.cuh"\n' + header.read_text())
    before = cuda_build._lib_path("quant_gemm", csrc)
    (csrc / "extra.cuh").write_text("// two\n")
    assert cuda_build._lib_path("quant_gemm", csrc) != before
