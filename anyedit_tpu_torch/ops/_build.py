"""Build the port's CUDA kernels with nvcc at first use and bind them with ctypes.

Every `csrc/*.cu` file is compiled on its own (one nvcc per source, all
started together) and the objects are linked into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in `anyedit_tpu_torch/_build/`, named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import: `library()` builds and loads on its first call.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C entry points and their argument types: every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints.
_SIGNATURES = {
    "anyedit_flash_nomax_bf16": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
    "anyedit_group_norm": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _LL, _LL, _I,
                           _P),
    "anyedit_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "anyedit_k4_quantize": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "anyedit_flash_int8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "anyedit_layer_norm": (_P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _I, _I, _I, _P),
    "anyedit_flash_sdpa": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
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
    sources, headers (csrc/*.cuh) and flags exists. Returns the library's
    path; the compiler's output (registers, shared memory, spills) is kept
    beside it as `.log`."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libanyedit_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out = proc.communicate()[0]
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr}")
    lib.with_suffix(".log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
