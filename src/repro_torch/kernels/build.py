"""Build and load the port's CUDA libraries at first use.

Each library is one ``csrc/*.cu`` source with a plain C interface (no
PyTorch headers), compiled by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/repro_torch/`` at the repository root, or into
``$REPRO_TORCH_BUILD_DIR``.  A library's file name carries a hash of its
source and the flags, so an edited source is rebuilt and a built one is
reused; a file lock beside it keeps two processes from building it at once.
Libraries are bound with ``ctypes``: every pointer and the stream travel as
``c_void_p``.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

KERNELS = pathlib.Path(__file__).resolve().parent
REPO_ROOT = KERNELS.parents[2]
SOURCES = {
    "conv_fused": KERNELS / "conv_fused" / "csrc" / "conv_fused.cu",
    "flash_attention": KERNELS / "flash_attention" / "csrc" /
    "flash_attention.cu",
    "ssm_scan": KERNELS / "ssm_scan" / "csrc" / "ssm_scan.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(env) if env else REPO_ROOT / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built with the "
                       "CUDA toolkit's nvcc")


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"{name}_{digest}.so"


@contextlib.contextmanager
def _file_lock(path: pathlib.Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def compile_library(name: str,
                    extra_flags=()) -> tuple[pathlib.Path, str]:
    """Build library ``name`` unless it is built already; returns its path
    and the compiler's output (empty for a built one).  ``extra_flags``
    (e.g. ``-Xptxas -v``) only reach a fresh build."""
    path = library_path(name)
    with _file_lock(path):
        if path.exists():
            return path, ""
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
             str(SOURCES[name])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, path)
        return path, proc.stdout


def library(name: str, bind):
    """The loaded library ``name``, built at first use; ``bind(lib)`` sets
    its functions' ``argtypes`` and ``restype`` once."""
    with _LOCK:
        if name not in _LIBS:
            path, _ = compile_library(name)
            lib = ctypes.CDLL(str(path))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            bind(lib)
            _LIBS[name] = lib
    return _LIBS[name]


def error(lib, rc: int) -> str:
    """Text of a CUDA error code returned by a launch."""
    return f"{rc} ({lib.repro_error_string(rc).decode()})"
