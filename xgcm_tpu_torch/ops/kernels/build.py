"""Build and load the hand-written CUDA kernels.

The sources under ``xgcm_tpu_torch/csrc/`` have a plain ``extern "C"``
interface and include no PyTorch header, so ``nvcc`` compiles all of them
into one shared library in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/libxgcm_tpu_torch_kernels-<hash>.so csrc/*.cu

The library is built at first use into ``build/kernels/`` beside the
package, keyed on a hash of the sources and flags, and loaded with
``ctypes``.  Nothing here runs at import time, so the module imports on a
host with no ``nvcc`` and no card.  Each wrapper counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = [
    "LAUNCHES",
    "build_library",
    "find_nvcc",
    "launch_counts",
    "load_library",
    "reset_launch_counts",
    "require_cuda",
]

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = ("shift.cu", "cgrid_diagnostics.cu", "interp_linear.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Kernel launches since the last reset, one plain integer per kernel.  A
# wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES = {"shift": 0, "cgrid_diagnostics": 0, "interp_linear": 0}

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.bfloat16: 3,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

# argtypes of every C entry point (pointers and the stream as c_void_p, so
# ctypes never truncates them to 32 bits)
SIGNATURES = {
    # x, out, dtype, outer, n, inner, op, direction, bc, fill_value, stream
    "xt_shift": (_P, _P, _I, _L, _L, _L, _I, _I, _I, _D, _P),
    # u, v, inv_dx, inv_dy, zeta, div, ke, dtype, ny, nx, stream
    "xt_cgrid_diagnostics": (_P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _P),
    # theta, phi, target(f32), out, th_dtype, ph_dtype, cols, n, m,
    # th_cs, th_ks, ph_cs, ph_ks, t_cs, t_ms, o_cs, o_ms,
    # mask_edges, check_flip, stream
    "xt_interp_linear": (
        _P, _P, _P, _P, _I, _I, _L, _L, _L,
        _L, _L, _L, _L, _L, _L, _L, _L,
        _I, _I, _P,
    ),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, else ``PATH``, else the toolkit's
    default prefix ``/usr/local/cuda``; raises when none has it."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.append(pathlib.Path(cuda_home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(pathlib.Path(on_path))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of xgcm_tpu_torch cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libxgcm_tpu_torch_kernels-{_source_hash()}.so"


def build_library(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path.  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report of registers, shared memory and spills."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-I", str(CSRC_DIR), "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library, with the
    argument and return types of every entry point declared."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device that torch can
    use.  Wrappers call this before any launch: a tensor that is not on
    the CPU either reaches its kernel or raises, it never takes the plain
    version."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA kernel was requested but CUDA is not available")
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise RuntimeError(f"kernel inputs must share one CUDA device, got {devices}")


def check_status(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a C entry."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
