"""nvcc build and ctypes binding of the port's CUDA kernels (csrc/*.cu).

Each `csrc/<name>.cu` has a plain C interface and becomes its own shared
library `lib<name>.so` in the package's build directory, compiled at first
use for Hopper (`sm_90a`). Nothing includes PyTorch's headers, so a build
takes seconds. Wrappers pass pointers from `tensor.data_ptr()` and the
stream from `torch.cuda.current_stream().cuda_stream` as `c_void_p`.
"""
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass

from .. import BUILD_DIR

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signatures of the kernels' entry points: name -> (argtypes, restype)
SIGNATURES = {
    "seg_scan": {
        "seg_scan": ([_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _L, _P, _P],
                     _I),
        "seg_scan_scratch_ints": ([_L], _L),
    },
    "rescore": {
        "rescore_e2e": ([_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _L, _P, _P,
                         _P, _P, _P, _P], _I),
        "rescore_e2e_rev": ([_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P], _I),
        "rescore_hamming": ([_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _L, _P, _P, _P, _P, _P, _P], _I),
        "rescore_align": ([_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P],
                          _I),
    },
    "sw_score": {
        "sw_score": ([_P] * 12 + [_L, _P, _I, _I, _I, _P, _P, _P, _L, _P],
                     _I),
        "sw_score_strip_rows": ([], _I),
        "sw_score_classes": ([], _I),
        "sw_score_class_rows": ([_I], _I),
        "sw_score_plan_size": ([], _I),
        "sw_score_counters": ([], _I),
        "sw_score_block_warps": ([], _I),
        "sw_score_resident_blocks": ([_I, _I], _I),
        "sw_score_attributes": ([_I, _I, _P, _P, _P], _I),
    },
}

_LOCK = threading.Lock()
_LIBS = {}


@dataclass
class BuildInfo:
    path: str
    seconds: float
    log: str  # nvcc's -Xptxas -v report: registers, shared memory, spills


def nvcc_path():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def build(name):
    """Compile csrc/<name>.cu into BUILD_DIR/lib<name>.so (always anew).
    Compiles into a temporary file and renames it into place, so a
    concurrent loader never sees a half-written library."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    so_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuildInfo(so_path, time.perf_counter() - t0,
                     proc.stdout + proc.stderr)


def load(name):
    """ctypes handle of lib<name>.so with its signatures set, building it
    when it is missing or older than its source."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, name + ".cu")
        so_path = os.path.join(BUILD_DIR, f"lib{name}.so")
        if (not os.path.exists(so_path)
                or os.path.getmtime(so_path) < os.path.getmtime(src)):
            build(name)
        lib = ctypes.CDLL(so_path)
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
        return lib


def ptr(t):
    """Device pointer of a tensor (None for a missing optional operand)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_of(device):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
