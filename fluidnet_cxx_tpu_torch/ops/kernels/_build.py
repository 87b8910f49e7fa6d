"""Build and load the port's CUDA kernels.

One ``nvcc`` command compiles every ``csrc/*.cu`` into one shared library
with a plain C interface under ``<checkout>/build/kernels/`` (listed in
``.gitignore``); ``ctypes`` loads it. No PyTorch headers are compiled, so a
build takes seconds, and there is no lock file: the library is written under
a temporary name and renamed into place. A rebuild happens only when the
hash of the sources and flags changes.

Every ``extern "C"`` entry launches one kernel on the stream it is given,
returns its ``cudaError_t`` as an int, does not synchronise and allocates
nothing; ``call`` raises if the status is not 0. The entries in ``QUERIES``
launch nothing: they answer a question of the kernels' own limits, so each
such decision is written once, in the CUDA source, and ``query`` returns
the answer.

Run ``python -m fluidnet_cxx_tpu_torch.ops.kernels._build`` to build and
print nvcc's ``-Xptxas -v`` report (registers, shared memory, spills).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: products and sums round separately, as in the plain PyTorch
# versions; the conv kernel asks for its fused multiply-adds with fmaf().
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-fmad=false"]

_LIB = None

VP = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# extern "C" signatures, all returning the launch's cudaError_t.
SIGNATURES = {
    "fn_advect_forward": [VP, VP, VP, VP, VP, I, I, I, F, F, F, I, I, I,
                          VP],
    "fn_advect_backward": [VP, VP, VP, VP, VP, VP, VP, I, I, I, F, F, F, F,
                           I, I, I, VP],
    "fn_advect_scalar_forward": [VP, VP, VP, VP, I, I, I, F, F, F, I, I, I,
                                 VP],
    "fn_advect_scalar_backward": [VP, VP, VP, VP, VP, I, I, I, F, F, F, F,
                                  I, I, I, VP],
    "fn_advect_velocity_forward": [VP, VP, VP, VP, I, I, I, F, I, VP],
    "fn_advect_velocity_backward": [VP, VP, VP, VP, VP, I, I, I, F, F, I,
                                    VP],
    "fn_tail_prologue": [VP, VP, VP, VP, VP, VP, VP, VP, VP, I, I, I, VP],
    "fn_tail_sweep": [VP, VP, VP, VP, I, I, I, I, F, F, VP],
    "fn_tail_epilogue": [VP, VP, VP, VP, VP, VP, I, I, I, VP],
    "fn_conv2d_nhwc": [VP, VP, VP, VP, VP, VP] + [I] * 14 + [VP],
    "fn_jacobi_mask": [VP, VP, I, I, I, VP],
    "fn_jacobi_sweeps": [VP, VP, VP, VP, I, I, I, I, I, F, F, VP],
    "fn_mg_prologue": [VP, VP, VP, VP, I, I, I, VP],
    "fn_mg_coarsen": [VP, VP, VP, I, I, I, VP],
    "fn_mg_partials": [VP, VP, VP, I, I, I, VP],
    "fn_mg_project": [VP, VP, VP, I, VP, I, I, I, VP],
    "fn_mg_restrict": [VP, VP, VP, VP, VP, VP, I, I, I, VP],
    "fn_mg_prolong": [VP, VP, VP, VP, I, I, I, VP],
    "fn_mg_epilogue": [VP, VP, VP, VP, VP, I, VP, VP, I, I, I, VP],
    "fn_mg_small": [I, VP, VP, VP, VP, VP, VP, I, I, I, I, I, F, F, VP],
}
# extern "C" entries that launch nothing and return a number.
QUERIES = {
    "fn_jacobi_max_sweeps": [],
    "fn_mg_cut_level": [I, VP, VP],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(ptxas_verbose: bool = False) -> Path:
    """Compile the library if its sources changed; return its path. With
    ``ptxas_verbose`` the build always runs and prints nvcc's
    ``-Xptxas -v`` report."""
    lib = BUILD_DIR / f"libfluidnet_kernels_{source_hash()}.so"
    if lib.exists() and not ptxas_verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc()] + ARCH + FLAGS + (["-Xptxas", "-v"] if ptxas_verbose
                                     else [])
    cmd += ["-o", str(tmp)] + [str(p) for p in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    if ptxas_verbose:
        print(f"nvcc build {time.perf_counter() - t0:.1f} s")
        for line in res.stderr.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Compiling entry")):
                print(line.strip())
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in {**SIGNATURES, **QUERIES}.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def call(name: str, *args):
    """Launch one kernel through its C entry; raise on a launch error."""
    status = getattr(library(), name)(*args)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")


def query(name: str, *args) -> int:
    """The answer of one of the ``QUERIES`` entries."""
    if name not in QUERIES:
        raise KeyError(f"{name} is not a query entry")
    return getattr(library(), name)(*args)


def ptr(t):
    """Device pointer of a tensor, or None for a missing optional input."""
    return None if t is None else t.data_ptr()


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def check(t, name, dtype, shape, device):
    """Raise unless ``t`` is a contiguous tensor of this dtype and shape on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def on_cuda(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raise for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


if __name__ == "__main__":
    print(build(ptxas_verbose=True))
