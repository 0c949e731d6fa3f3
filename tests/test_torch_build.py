"""The CUDA build's cache key (cha1_mcmc_tpu_torch/utils/cuda_build.py),
on the CPU: no nvcc is needed to compute it. A library is reused only
while its source, every shared header in csrc/ and the flags are
unchanged, so an edit to the step loop every kernel includes
(csrc/step_loop.cuh) rebuilds them all."""

import shutil

import pytest

from cha1_mcmc_tpu_torch.utils import cuda_build


@pytest.fixture
def csrc(tmp_path):
    out = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, out)
    return out


def test_every_source_includes_the_shared_header():
    """Every source reaches step_loop.cuh, directly or through the
    single-component statics header (K1 and K3)."""
    csrc = cuda_build.CSRC_DIR
    via = '#include "step_loop.cuh"' in (csrc / "single_statics.cuh").read_text()
    assert via
    for name in ("fused_step.cu", "multi_step.cu", "gather_step.cu", "opacity.cu"):
        text = (csrc / name).read_text()
        assert ('#include "step_loop.cuh"' in text
                or '#include "single_statics.cuh"' in text), name
    for name in ("fused_step.cu", "gather_step.cu"):
        assert '#include "single_statics.cuh"' in (csrc / name).read_text(), name


@pytest.mark.parametrize("source", ["fused_step.cu", "multi_step.cu", "gather_step.cu",
                                    "opacity.cu", "construct_probe.cu"])
def test_editing_a_header_changes_the_digest(csrc, source):
    before = cuda_build.source_digest(csrc / source, csrc)
    assert before == cuda_build.source_digest(csrc / source, csrc)   # stable
    header = csrc / "step_loop.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert cuda_build.source_digest(csrc / source, csrc) != before


def test_digest_covers_source_new_headers_and_flags(csrc, monkeypatch):
    src = csrc / "multi_step.cu"
    base = cuda_build.source_digest(src, csrc)
    (csrc / "extra.cuh").write_text("// a new shared header\n")
    with_header = cuda_build.source_digest(src, csrc)
    assert with_header != base
    other = csrc / "fused_step.cu"
    other.write_text(other.read_text() + "\n// another source\n")
    assert cuda_build.source_digest(src, csrc) == with_header
    src.write_text(src.read_text() + "\n// edited\n")
    edited = cuda_build.source_digest(src, csrc)
    assert edited != with_header
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.source_digest(src, csrc) != edited
