"""Build and load the port's CUDA kernels.

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles
each source to an object; one more links them into one shared library with
a plain C interface under ``<checkout>/build/kernels/`` (listed in
``.gitignore``); ``ctypes`` loads it. No PyTorch headers are compiled, so a
build takes seconds, and there is no lock file: the library is written under
a temporary name and renamed into place. A rebuild happens only when the
hash of the sources and flags changes.

Every ``extern "C"`` entry launches its kernel (``fn_jacobi_solve``,
``fn_tail``, ``fn_jacobi3_solve``, ``fn_tail3``, ``fn_mg_solve`` and
``fn_mg_project``: the launches of a whole solve; ``fn_mg_learned_down``
and ``fn_mg_learned_up``: the two halves of a learned V-cycle;
``fn_conv2d_wgrad``: the partial tiles and their reduce;
``fn_conv2d_dgrad``: its one launch and, with splits, their reduce;
``fn_jacobi3_adjoint``: the mask launch and the transposed sweeps;
``fn_conv3d_dgrad``, ``fn_conv3d_wgrad``, ``fn_conv2d_bf16_dgrad`` and
``fn_conv2d_bf16_wgrad``: the tiles and the reduce of their splits;
``fn_bias_grad_bf16``: the windows' chains and the chain over them) on
the stream it is given,
returns the first ``cudaError_t`` as an int, does not synchronise and
allocates nothing; ``call`` raises if the status is not 0. The entries in
``QUERIES`` launch nothing: they answer a question of the kernels' own
limits, so each such decision is written once, in the CUDA source, and
``query`` returns the answer.

Run ``python -m fluidnet_cxx_tpu_torch.ops.kernels._build`` to build and
print nvcc's ``-Xptxas -v`` report (registers, shared memory, spills).
"""
import collections
import ctypes
import functools
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
# versions (and kernel B's 3xTF32 split x - tf32(x) stays exact); the SIMT
# conv asks for its fused multiply-adds with fmaf().
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false"]

_LIB = None
# C entry name -> calls through ``call`` (each one ctypes call).
calls = collections.Counter()

VP = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# extern "C" signatures, all returning the launch's cudaError_t.
SIGNATURES = {
    "fn_advect_forward": [VP] * 5 + [I, I, I, F, F, F, F, I, I, I, VP],
    "fn_advect_backward": [VP] * 7 + [I, I, I, F, F, F, F, F, I, I, I, VP],
    "fn_advect_scalar_forward": [VP, VP, VP, VP, I, I, I, F, F, F, F, I, I,
                                 I, VP],
    "fn_advect_scalar_backward": [VP, VP, VP, VP, VP, I, I, I, F, F, F, F,
                                  F, I, I, I, VP],
    "fn_advect_velocity": [VP] * 4 + [I, I, I, F, F, I, I, I, VP],
    "fn_tail": [VP] * 11 + [I] * 5 + [F, F, VP],
    "fn_conv2d_nhwc": [VP] * 7 + [I] * 18 + [VP, VP],
    "fn_conv2d_bf16": [VP] * 6 + [I] * 17 + [VP, VP],
    "fn_conv2d_dgrad": [VP] * 7 + [I] * 21 + [VP],
    "fn_conv2d_wgrad": [VP] * 5 + [I] * 22 + [VP],
    "fn_jacobi_solve": [VP] * 6 + [I] * 5 + [F, F, VP],
    "fn_jacobi_adjoint": [VP] * 5 + [I] * 4 + [F, F, VP],
    "fn_mg_solve": [VP] * 5 + [I] * 9 + [F, F, VP],
    "fn_mg_project": [VP] * 6 + [I] * 9 + [F, F, VP],
    "fn_mg_learned_down": [VP] * 6 + [I] * 10 + [F, F, VP],
    "fn_mg_learned_up": [VP] * 6 + [I] * 10 + [F, F, VP],
    "fn_mg_slab_coarsen": [VP, VP] + [I] * 5 + [VP],
    "fn_mg_slab_mask": [VP, VP] + [I] * 5 + [VP],
    "fn_mg_slab_partials": [VP] * 3 + [I] * 5 + [VP],
    "fn_mg_slab_down": [VP] * 8 + [I] * 12 + [F, F, VP],
    "fn_mg_slab_up": [VP] * 7 + [I] * 11 + [F, F, VP],
    "fn_mg_slab_epilogue": [VP] * 6 + [I] * 7 + [VP],
    "fn_mg_tail_solve": [VP] * 4 + [I] * 8 + [F, F, VP],
    "fn_jacobi3_solve": [VP, VP, VP, VP, VP, VP, I, I, I, I, I, I, F, F, VP],
    "fn_tail3": [VP] * 8 + [I] * 6 + [F, F, VP],
    "fn_conv3d_ndhwc": [VP] * 6 + [I] * 20 + [VP, VP],
    "fn_conv3d_dgrad": [VP] * 5 + [I] * 12 + [VP],
    "fn_conv3d_wgrad": [VP] * 4 + [I] * 13 + [VP],
    "fn_conv2d_bf16_dgrad": [VP] * 5 + [I] * 11 + [VP],
    "fn_conv2d_bf16_wgrad": [VP] * 4 + [I] * 12 + [VP],
    "fn_bias_grad_bf16": [VP] * 4 + [I, VP],
    "fn_jacobi3_adjoint": [VP] * 5 + [I] * 6 + [F, F, VP],
    "fn_advect3_forward": [I] + [VP] * 5 + [I, I, I, I, F, F, F, F, F, I,
                                             I, VP],
    "fn_advect3_backward": [I] + [VP] * 7 + [I, I, I, I, F, F, F, F, F, F,
                                             I, I, VP],
}
# extern "C" entries that launch nothing and return a number.
QUERIES = {
    "fn_jacobi_max_sweeps": [],
    "fn_tail_launches": [I],
    "fn_jacobi3_max_sweeps": [],
    "fn_mg_workspace": [I] * 8,
    "fn_mg_launches": [I] * 9,
    "fn_mg_cut_level": [I] * 3,
    "fn_mg_learned_launches": [I] * 10,
    "fn_mg_slab_parts": [I] * 6,
    "fn_mg_tail_launches": [I] * 7,
    "fn_advect_max_disp": [],
    "fn_advect_tile_smem": [I] * 3,
    "fn_advect3_velocity_max_disp": [I],
    "fn_advect3_velocity_smem": [I, I],
    "fn_conv2d_wgrad_plan": [I] * 8 + [VP],
    "fn_conv2d_dgrad_plan": [I] * 8 + [VP],
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


def _run(procs):
    """Wait for every (name, Popen) and return their stderr, joined; raise
    on the first that failed. No process outlives the call."""
    try:
        errs = []
        for name, proc in procs:
            _, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name} "
                                   f"({proc.returncode}):\n{err}")
            errs.append(err)
        return "".join(errs)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build(ptxas_verbose: bool = False) -> Path:
    """Compile the library if its sources changed; return its path. With
    ``ptxas_verbose`` the build always runs and prints nvcc's
    ``-Xptxas -v`` report."""
    lib = BUILD_DIR / f"libfluidnet_kernels_{source_hash()}.so"
    if lib.exists() and not ptxas_verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    compile_cmd = [nvcc()] + ARCH + FLAGS + (["-Xptxas", "-v"]
                                             if ptxas_verbose else [])
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            compile_cmd + ["-c", "-o", str(obj), str(src)],
            stderr=subprocess.PIPE, text=True)))
    report = _run(procs)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    _run([("link", subprocess.Popen(
        [nvcc()] + ARCH + ["-shared", "-o", str(tmp)] + [str(o) for o in objs],
        stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    if ptxas_verbose:
        print(f"nvcc build {time.perf_counter() - t0:.1f} s")
        for line in report.splitlines():
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
    """Launch one kernel through its C entry (counted in ``calls``); raise
    on a launch error."""
    calls[name] += 1
    status = getattr(library(), name)(*args)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")


def query(name: str, *args) -> int:
    """The answer of one of the ``QUERIES`` entries."""
    if name not in QUERIES:
        raise KeyError(f"{name} is not a query entry")
    return getattr(library(), name)(*args)


@functools.lru_cache(maxsize=None)
def constant(name: str) -> int:
    """The answer of a ``QUERIES`` entry that takes no arguments: a constant
    of the built library, asked once a process."""
    return query(name)


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
