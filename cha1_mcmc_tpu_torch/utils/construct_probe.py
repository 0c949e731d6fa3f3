"""T3: a probe of the device constructs the port's kernels rely on.

Port of tools/mosaic_construct_probe.py, the TPU tool that compiles the
dense gather kernel's suspect constructs one at a time as tiny programs.
Here the seven probes are the seven CTAs of one CUDA launch
(csrc/construct_probe.cu), at the TPU probe's shapes:

  A  a runtime loop accumulating 8-row bands of x (48, 128)
  B  the same with the band offset asserted a multiple of 8
  C  a runtime loop over 50-row bands at stride 56 of x (336, 128), each
     band summed as 5 planes of 10 rows
  D  A's loop fully unrolled (the control)
  E  C's loop fully unrolled (the control)
  F  a shared-memory scratch written in 8-row chunks (2 x) and read back
  G  A's band loop fed through exp2 / where

`probes(xa, xc, xf)` launches the kernel for CUDA tensors and takes the
plain version `probes_plain` (the same sums in the same order) for CPU
tensors; `LAUNCHES` counts launches. `run_probes(device)` is the tool:
every probe against a float64 NumPy reference at the TPU probe's
tolerance (rtol 1e-4), one line per probe.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cha1_mcmc_tpu_torch.utils.cuda_build import build_library
from cha1_mcmc_tpu_torch.utils.device import DEFAULT_DEVICE, DeviceError, resolve_device
from cha1_mcmc_tpu_torch.utils.metrics import register_launches

__all__ = ["PROBES", "probe_inputs", "probes_plain", "probes", "reference",
           "run_probes", "load_kernel_library", "LAUNCHES"]

PROBES = {"A": "runtime loop over aligned 8-row bands",
          "B": "the same, offset asserted a multiple of 8",
          "C": "runtime loop over 50-row bands at stride 56, 5 planes each",
          "D": "aligned bands, unrolled (control)",
          "E": "50-row bands at stride 56, unrolled (control)",
          "F": "shared-memory scratch store and reload",
          "G": "band loop through exp2 / where"}
_BANDS, _ROWS, _PLANE, _STRIDE, _SCRATCH, _COLS = 6, 8, 10, 56, 32, 128

#: Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = register_launches({"construct_probe": 0})

_library = None


def probe_inputs(device=DEFAULT_DEVICE, seed: int = 0):
    """(xa (48, 128), xc (336, 128), xf (32, 128)) float32 from a NumPy
    seed, on `device`."""
    device = resolve_device(device, "probe_inputs")
    rng = np.random.default_rng(seed)
    shapes = ((_BANDS * _ROWS, _COLS), (_BANDS * _STRIDE, _COLS), (_SCRATCH, _COLS))
    return tuple(torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                 device=device) for s in shapes)


def _bands(xa):
    return [xa[i * _ROWS:(i + 1) * _ROWS] for i in range(_BANDS)]


def probes_plain(xa, xc, xf) -> dict:
    """The probes' values with torch ops, summed in the kernel's order:
    bands in order, each 50-row band's planes left to right from 0."""
    acc = torch.zeros_like(xa[:_ROWS])
    gauss = torch.zeros_like(acc)
    for band in _bands(xa):
        acc = acc + band
        gauss = gauss + torch.where(band > 0, torch.exp2(-band * band), 0.0)
    planes = torch.zeros_like(xc[:_PLANE])
    for i in range(_BANDS):
        s = torch.zeros_like(planes)
        for j in range(5):
            r0 = i * _STRIDE + j * _PLANE
            s = s + xc[r0:r0 + _PLANE]
        planes = planes + s
    return {"A": acc, "B": acc.clone(), "C": planes, "D": acc.clone(),
            "E": planes.clone(), "F": xf * 2.0, "G": gauss}


def load_kernel_library():
    """Build T3 (at first use) and load it: (ctypes library, nvcc build
    log, empty when a cached build was loaded)."""
    global _library
    if _library is None:
        path, log = build_library("construct_probe.cu")
        lib = ctypes.CDLL(str(path))
        lib.t3_probes.argtypes = [ctypes.c_void_p] * 11
        lib.t3_probes.restype = ctypes.c_int
        lib.t3_error_string.argtypes, lib.t3_error_string.restype = [ctypes.c_int], \
            ctypes.c_char_p
        _library = lib, log
    return _library


def _launch(xa, xc, xf):
    lib, _ = load_kernel_library()
    dev = xa.device
    for name, t, rows in (("xa", xa, _BANDS * _ROWS), ("xc", xc, _BANDS * _STRIDE),
                          ("xf", xf, _SCRATCH)):
        if (t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (rows, _COLS)
                or not t.is_contiguous()):
            raise ValueError(f"T3: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                             f"the probe takes a contiguous float32 ({rows}, {_COLS}) "
                             f"on {dev}")
    rows = {"A": _ROWS, "B": _ROWS, "C": _PLANE, "D": _ROWS, "E": _PLANE, "F": _SCRATCH,
            "G": _ROWS}
    out = {k: torch.empty((r, _COLS), dtype=torch.float32, device=dev)
           for k, r in rows.items()}
    with torch.cuda.device(dev):
        err = lib.t3_probes(xa.data_ptr(), xc.data_ptr(), xf.data_ptr(),
                            *(out[k].data_ptr() for k in "ABCDEFG"),
                            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise DeviceError(f"T3 launch failed: CUDA error {err} "
                           f"({lib.t3_error_string(err).decode()})")
    LAUNCHES["construct_probe"] += 1
    return out


def probes(xa, xc, xf) -> dict:
    """{probe: values}: one launch of the CUDA probe for CUDA tensors, the
    plain version for CPU tensors."""
    if xa.is_cuda:
        return _launch(xa, xc, xf)
    if xa.device.type != "cpu":
        raise ValueError(f"T3 runs on CUDA (kernel) or on the CPU (plain version), "
                         f"not on {xa.device}")
    return probes_plain(xa, xc, xf)


def reference(xa, xc, xf) -> dict:
    """The probes' values in float64 NumPy, as the TPU probe computes its
    expectations."""
    xa, xc, xf = (t.cpu().double().numpy() for t in (xa, xc, xf))
    bands = xa.reshape(_BANDS, _ROWS, _COLS)
    a = bands.sum(axis=0)
    c = xc.reshape(_BANDS, _STRIDE, _COLS)[:, :5 * _PLANE].reshape(
        _BANDS, 5, _PLANE, _COLS).sum(axis=(0, 1))
    g = np.where(bands > 0, np.exp2(-bands * bands), 0.0).sum(axis=0)
    return {"A": a, "B": a, "C": c, "D": a, "E": c, "F": xf * 2.0, "G": g}


def run_probes(device=DEFAULT_DEVICE, seed: int = 0, verbose: bool = True) -> dict:
    """Run every probe on `device` against the float64 reference (rtol and
    atol 1e-4, the TPU probe's check); prints one line per probe and
    returns {probe: ok}."""
    inputs = probe_inputs(device, seed)
    got, want = probes(*inputs), reference(*inputs)
    result = {}
    for k, what in PROBES.items():
        g = got[k].cpu().numpy()
        result[k] = bool(np.allclose(g, want[k], rtol=1e-4, atol=1e-4))
        if verbose:
            dev = float(np.max(np.abs(g - want[k])))
            print(f"[{k} {what}] {'OK' if result[k] else 'WRONG'} max|dev|={dev:.3g}",
                  flush=True)
    return result
