"""
Build and load the port's CUDA kernel library.

``csrc/gram_kernels.cu`` has a plain C interface, so it is compiled by
``nvcc`` alone into a shared library and loaded with ``ctypes``; no PyTorch
header is compiled, which keeps a cold build to seconds. The library is
built at first use into ``build/gpim_tpu_torch/`` beside the package, under
a name keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

Fast-math is deliberately off: ``__expf`` would move the kernel values of
K2 away from the plain PyTorch version and the JAX reference.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "NVCC_FLAGS", "build", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "gram_kernels.cu"
BUILD_DIR = _PKG.parent / "build" / "gpim_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# C entry points per kernel; each exists as <name>_f32 and <name>_f64 and
# returns the cudaError_t of its launch; K1-K3 take the task count just
# before the stream, K4 (interp_adjoint) has no task axis, K5
# (chol_inverse) takes the order and then the number of matrices.
_SIGNATURES = {
    "gpim_sqdist": (_P, _P, _P, _I64, _I64, _INT, _INT, _P),
    "gpim_masked_system": (_P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT,
                           _INT, _P),
    "gpim_rbf_bwd_reductions": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I64, _INT, _INT, _P),
    "gpim_interp_adjoint": (_P, _P, _P, _P, _P, _P, _P, _INT, _P, _I64,
                            _I64, _INT, _P),
    "gpim_chol_inverse": (_P, _P, _P, _P, _INT, _I64, _P),
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float     # 0.0 when the library was already built
    log: str           # nvcc's output (ptxas register/spill report)


def find_nvcc():
    """nvcc from $CUDA_HOME, the default toolkit location, or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            "the gpim_tpu_torch CUDA kernels")
    return found


def _library_path():
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ("libgram_kernels_%s.so" % digest[:16])


def build():
    """Compile the kernel library unless it is already built."""
    path = _library_path()
    if path.exists():
        return BuildResult(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name("%s.%d.tmp" % (path.name, os.getpid()))
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (exit %d):\n%s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stderr))
    os.replace(tmp, path)       # atomic: a concurrent loader sees all or none
    return BuildResult(path, seconds, proc.stdout + proc.stderr)


@functools.cache
def load_library():
    """The built library with every entry point's argtypes declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, "%s_%s" % (name, suffix))
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    lib.gpim_error_string.argtypes = [ctypes.c_int]
    lib.gpim_error_string.restype = ctypes.c_char_p
    return lib
