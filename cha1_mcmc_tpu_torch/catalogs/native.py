"""ctypes bindings for the native SPCAT tokenizer (native/spcat_parser.cpp).

Port of cha1_mcmc_tpu/catalogs/native.py. The port keeps its own copy of
the C++ source and compiles it with g++ at first use into the port's build
directory (`utils/cuda_build.BUILD_DIR`), under a name that hashes the
source and the flags, so an edit rebuilds it and a second process reuses
it. Where the library cannot be built or loaded, or with CHA1_NATIVE=0,
`tokenize_native` returns None and `parse_spcat` uses the pure-Python
tokenizer, as the JAX package does (identical fields, tested equal).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from cha1_mcmc_tpu_torch.utils.cuda_build import BUILD_DIR

__all__ = ["CXX_FLAGS", "SOURCE", "build_native", "native_available", "tokenize_native"]

SOURCE = Path(__file__).resolve().parent.parent / "native" / "spcat_parser.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def build_native() -> Path:
    """Compile the tokenizer (cached by a hash of the source and
    CXX_FLAGS) and return the library's path. Raises RuntimeError where
    g++ is missing or fails."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    out = BUILD_DIR / f"libspcat-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native SPCAT tokenizer cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


@functools.cache
def _load():
    if os.environ.get("CHA1_NATIVE", "1") == "0":
        return None
    try:
        lib = ctypes.CDLL(str(build_native()))
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None
    lib.spcat_parse.restype = ctypes.c_long
    lib.spcat_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64),
    ]
    return lib


def native_available() -> bool:
    return _load() is not None


def tokenize_native(text: bytes):
    """Tokenize raw catalog bytes. Returns the same field dict as the
    pure-Python tokenizer, or None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    max_lines = text.count(b"\n") + 1
    frequency = np.empty(max_lines, dtype=np.float64)
    error = np.empty(max_lines, dtype=np.float64)
    logint = np.empty(max_lines, dtype=np.float64)
    dof = np.empty(max_lines, dtype=np.int64)
    elower = np.empty(max_lines, dtype=np.float64)
    gup = np.empty(max_lines, dtype=np.int64)
    tag = np.empty(max_lines, dtype=np.int64)
    qnformat = np.empty(max_lines, dtype=np.int64)
    qn = np.empty(max_lines * 12, dtype=np.int64)
    n = lib.spcat_parse(text, len(text), max_lines, frequency, error, logint,
                        dof, elower, gup, tag, qnformat, qn)
    if n < 0:
        return None
    return dict(
        frequency=frequency[:n], error=error[:n], logint=logint[:n],
        dof=dof[:n], elower=elower[:n], gup=gup[:n], tag=tag[:n],
        qnformat=qnformat[:n], qn=qn[: n * 12].reshape(n, 12),
    )
