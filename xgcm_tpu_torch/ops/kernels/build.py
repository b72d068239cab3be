"""Build and load the hand-written CUDA kernels.

The sources under ``xgcm_tpu_torch/csrc/`` have a plain ``extern "C"``
interface and include no PyTorch header, so ``nvcc`` compiles them in
seconds, one process per source, all started together, and links the
objects into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c -o <source>.o csrc/<source>.cu                     # each source at once
    nvcc -shared -o build/kernels/libxgcm_tpu_torch_kernels-<hash>.so *.o

The library is built at first use into ``build/kernels/`` beside the
package, keyed on a hash of the sources and flags, and loaded with
``ctypes``.  Nothing here runs at import time, so the module imports on a
host with no ``nvcc`` and no card.  Each wrapper counts its launches in
:data:`LAUNCHES`; :func:`launch` times the first call of each C entry in
the process into :data:`FIRST_LAUNCH_S`.
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
import time

import torch

__all__ = [
    "FIRST_LAUNCH_S",
    "LAUNCHES",
    "autograd_launch",
    "build_library",
    "find_nvcc",
    "launch",
    "launch_counts",
    "load_library",
    "reset_first_launches",
    "reset_launch_counts",
    "require_cuda",
]

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = (
    "shift.cu", "cgrid_diagnostics.cu", "interp_linear.cu", "conservative.cu",
    "face_shift.cu", "vorticity.cu", "weighted_sum.cu",
)
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# Kernel launches since the last reset, one plain integer per kernel.  A
# wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES = {
    "shift": 0,
    "cgrid_diagnostics": 0,
    "interp_linear": 0,
    "interp_linear_multi": 0,
    "conservative": 0,
    "conservative_multi": 0,
    "face_shift": 0,
    "vorticity": 0,
    "weighted_sum": 0,
}

# Host seconds of the first call of each C entry in the process (the
# kernel's module load at its first launch, among the rest), by perf_counter
# around the call; set once an entry, never reset by a run.
FIRST_LAUNCH_S = {}

# The multi-variable kernels take at most this many variables: the size of
# the fixed pointer array of VarSet in csrc/common.cuh.
MAX_VARS = 8

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
_PP = ctypes.POINTER(ctypes.c_void_p)  # host array of device pointers
_LP = ctypes.POINTER(ctypes.c_longlong)  # host array of strides
_IP = ctypes.POINTER(ctypes.c_int)  # an int the entry writes

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
    # theta, phis, ph_cs, ph_ks, outs, target(f32), nv, th_dtype, ph_dtype,
    # cols, n, m, th_cs, th_ks, t_cs, t_ms, o_cs, o_ms, mask_edges,
    # check_flip, stream
    "xt_interp_linear_multi": (
        _P, _PP, _LP, _LP, _PP, _P, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _L, _L,
        _I, _I, _P,
    ),
    # theta, phis, ph_cs, ph_ks, outs, edges(f32), nv, th_dtype, ph_dtype,
    # cols, n, nb, th_cs, th_ks, o_cs, o_js, reassociate, stream
    "xt_conservative": (
        _P, _PP, _LP, _LP, _PP, _P, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _I, _P,
    ),
    # x, halo, out, dtype, outer, n, inner, op, direction, route (out), stream
    "xt_face_shift": (_P, _P, _P, _I, _L, _L, _L, _I, _I, _IP, _P),
    # u, v, inv_dx, inv_dy, zeta, dtype, ny, nx, stream
    "xt_vorticity": (_P, _P, _P, _P, _P, _I, _L, _L, _P),
    # x, factors, strides, nf, sizes, segments, rows, vw, vpt, tiles,
    # chunk_rows, chunks, partial, out, stream
    "xt_weighted_sum": (_P, _PP, _LP, _I, _LP, _L, _L, _I, _I, _I, _L, _I, _P, _P, _P),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_first_launches() -> None:
    FIRST_LAUNCH_S.clear()


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
    flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-I", str(CSRC_DIR)]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src + ".o") for src in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *flags, "-c", "-o", obj, str(CSRC_DIR / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        reports = [proc.communicate()[0] for proc in procs]
        for src, proc, report in zip(SOURCES, procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{report}")
        so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        if verbose:
            print("".join(reports))
        os.replace(so, out)
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


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry ``name`` with ``args`` and the current stream of
    ``device``, with ``device`` the current card (a kernel launches on the
    current card's streams, and a tensor may live on another, as a block
    of a sharded array does); raise on a non-zero status.  The first call
    of each entry in the process is timed into :data:`FIRST_LAUNCH_S`."""
    entry = getattr(load_library(), name)
    with torch.cuda.device(device):
        if name in FIRST_LAUNCH_S:
            status = entry(*args, stream_ptr(device))
        else:
            t0 = time.perf_counter()
            status = entry(*args, stream_ptr(device))
            FIRST_LAUNCH_S[name] = time.perf_counter() - t0
    check_status(name, status)


def outputs(outs, count, shape, dtype, device):
    """The ``count`` output tensors of a launch: ``outs`` checked (each
    ``shape`` in ``dtype`` on ``device``, all of one layout, since the
    kernels take one set of output strides), or new contiguous tensors."""
    if outs is None:
        return [torch.empty(shape, dtype=dtype, device=device) for _ in range(count)]
    if len(outs) != count or any(
        o.shape != shape or o.dtype != dtype or o.device != device
        or o.stride() != outs[0].stride() for o in outs
    ):
        raise ValueError(f"out must be {count} tensor(s) {shape} of one layout, {dtype}, "
                         f"on {device}")
    return list(outs)


def var_set(inputs, outputs):
    """Host arrays describing a VarSet (``csrc/common.cuh``): the device
    pointer, column stride and level stride of each 2-D input, and the
    device pointer of each output.  The arrays must outlive the call."""
    nv = len(inputs)
    return (
        (ctypes.c_void_p * nv)(*(x.data_ptr() for x in inputs)),
        (ctypes.c_longlong * nv)(*(x.stride(0) for x in inputs)),
        (ctypes.c_longlong * nv)(*(x.stride(1) for x in inputs)),
        (ctypes.c_void_p * nv)(*(o.data_ptr() for o in outputs)),
    )


class PlainBackward(torch.autograd.Function):
    """Forward: ``launch(*tensors)``, a kernel.  Backward: autograd through
    ``plain(*tensors)``, the kernel's plain version; the JAX package's
    custom-VJP rules do the same with their jnp twins, and no TPU kernel
    has a backward kernel.  Either callable returns a tensor or a tuple of
    tensors."""

    @staticmethod
    def forward(ctx, launch, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return launch(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            ref = ctx.plain(*inputs)
            refs = ref if isinstance(ref, tuple) else (ref,)
            found = iter(torch.autograd.grad(refs, wanted, grads, allow_unused=True))
        return (None, None, *(next(found) if x.requires_grad else None for x in inputs))


def autograd_launch(launch, plain, *tensors):
    """``launch(*tensors)``, the kernel, as every wrapper that offers a
    gradient calls it: directly when grad mode is off or no input needs a
    gradient, else through :class:`PlainBackward`, so that autograd runs
    through ``plain``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return PlainBackward.apply(launch, plain, *tensors)
    return launch(*tensors)
