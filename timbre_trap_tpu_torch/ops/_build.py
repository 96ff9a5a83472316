"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. The libraries go into
``timbre_trap_tpu_torch/build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads from disk. All sources build in parallel, one ``nvcc`` each.
Nothing is compiled while a module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils.profiling import span

__all__ = ["load", "build_all", "library_path", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signatures of each library's entry points: {library: {name: argtypes}}.
_SIGNATURES = {
    "peak_mask": {"tt_peak_mask": [_P, _P, _I, _I, _I, _L, _L, _F, _I, _P]},
    "banded_conv_bwd": {
        "tt_elu_backward": [_P] * 5 + [_I, _L, _P],
    },
    "band_mma": {
        "tt_band_conv_dx": [_P] * 7 + [_I] * 18 + [_P],
        "tt_band_conv_dx_f32": [_P] * 7 + [_I] * 17 + [_P],
        "tt_band_conv_dw": [_P] * 6 + [_I] * 18 + [_P],
        "tt_band_conv_dw_f32": [_P] * 6 + [_I] * 18 + [_P],
    },
    "band_wgmma": {"tt_band_conv_wgmma": [_P] * 5 + [_I] * 4 + [_P] * 2,
                   "tt_band_conv_wgmma_f32": [_P] * 5 + [_I] * 4 + [_P] * 2},
}

_loaded = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name):
    """The shared library that ``csrc/<name>.cu`` builds into, named by a
    hash of the source and the flags."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=None):
    """Compile every missing library in parallel; returns seconds spent and
    the compiler's log per source (ptxas register and shared-memory use)."""
    names = list(names or _SIGNATURES)
    todo = [n for n in names if not library_path(n).exists()]
    logs = {}
    if not todo:
        return 0.0, logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0, logs


def load(name, entry):
    """The ctypes entry point ``entry`` of library ``name``, building the
    library if needed."""
    if name not in _loaded:
        with span("tt.build"):
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            fns = {}
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[fn_name] = fn
            _loaded[name] = (lib, fns)
    return _loaded[name][1][entry]


def check(rc, what):
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
