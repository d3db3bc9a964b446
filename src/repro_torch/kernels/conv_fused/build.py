"""Build and load the conv_fused CUDA library at first use.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles ``csrc/conv_fused.cu`` (a plain C interface, no PyTorch headers)
into ``build/repro_torch/`` at the repository root, or into
``$REPRO_TORCH_BUILD_DIR``.  The library's file name carries a hash of the
source, so an edited source is rebuilt and a built one is reused.  It is
bound with ``ctypes``: every pointer and the stream travel as
``c_void_p``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

SOURCE = pathlib.Path(__file__).parent / "csrc" / "conv_fused.cu"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[4]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(env) if env else REPO_ROOT / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the conv_fused kernels are built "
                       "with the CUDA toolkit's nvcc")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"conv_fused_{digest}.so"


def compile_library(extra_flags=()) -> tuple[pathlib.Path, str]:
    """Compile the library if it is not built yet; returns (path, the
    compiler's output).  ``extra_flags`` (e.g. ``-Xptxas -v``) only reach a
    fresh build."""
    path = library_path()
    if path.exists():
        return path, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


def library():
    """The loaded library (built at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = compile_library()
            lib = ctypes.CDLL(str(path))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.repro_fused_chain.argtypes = [vp, ci, vp, ci, ci, vp]
            lib.repro_fused_chain.restype = ci
            lib.repro_fused_horizontal.argtypes = [vp, vp, vp]
            lib.repro_fused_horizontal.restype = ci
            lib.repro_error_string.argtypes = [ci]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def error(rc: int) -> str:
    """Text of a CUDA error code returned by a launch."""
    return f"{rc} ({library().repro_error_string(rc).decode()})"
