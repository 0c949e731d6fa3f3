"""Build the port's CUDA sources into shared libraries at first use.

Each `csrc/*.cu` file has a plain C interface and is compiled by `nvcc`
into a `.so` that the kernel's module loads with ctypes. The sources share
device code through headers (`csrc/*.cuh`). A library is cached under
`build/cha1_mcmc_tpu_torch/` beside the package, named by `source_digest`
— a hash of the source, every header in `csrc/` and the compiler flags —
so a second process (or a second run from the same checkout) loads it
without compiling, and an edit to a shared header rebuilds every source.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "CSRC_DIR", "find_nvcc", "source_digest",
           "build_library"]

#: Hopper target (the `a` keeps wgmma/setmaxnreg available), IEEE math:
#: no --use_fast_math, so no flush-to-zero and correctly rounded div/sqrt.
#: -Xptxas -v reports registers, shared memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "cha1_mcmc_tpu_torch"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built here")
    return nvcc


def source_digest(source: Path, csrc_dir: Path = CSRC_DIR) -> str:
    """16 hex digits of SHA-256 over the source, every `*.cuh` header of
    `csrc_dir` (by name and content, in name order) and NVCC_FLAGS: the
    name of the source's cached library."""
    h = hashlib.sha256(Path(source).read_bytes())
    for header in sorted(Path(csrc_dir).glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library(source_name: str) -> tuple[Path, str]:
    """Compile `csrc/<source_name>` into a shared library (cached by
    `source_digest`) and return (path, build log). The log is empty when
    the cached library was reused."""
    source = CSRC_DIR / source_name
    out = BUILD_DIR / f"{source.stem}-{source_digest(source)}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{source}:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out, log
