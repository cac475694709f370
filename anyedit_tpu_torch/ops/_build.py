"""Build the port's CUDA kernels with nvcc at first use and bind them with ctypes.

Every `csrc/*.cu` file is compiled into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library lands
in `anyedit_tpu_torch/_build/`, named by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused. Nothing here runs
at import: `library()` builds and loads on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types: every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints.
_SIGNATURES = {
    "anyedit_flash_nomax_bf16": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    "anyedit_group_norm": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build() -> Path:
    """Compile csrc/*.cu into one shared library, unless a build of the same
    sources and flags exists. Returns the library's path; the compiler's
    output (registers, shared memory, spills) is kept beside it as `.log`."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libanyedit_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.anyedit_cuda_error_string.argtypes = (ctypes.c_int,)
        lib.anyedit_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().anyedit_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
