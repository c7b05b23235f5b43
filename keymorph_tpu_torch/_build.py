"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

One ``nvcc`` call compiles every source into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o libkm_kernels.so csrc/*.cu

The library lands in ``build/keymorph_tpu_torch/<hash>/`` at the repository
root, keyed by a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. ``--use_fast_math`` is
deliberately absent: the kernels' ``logf``/``sqrtf``/divisions must round
like the plain PyTorch versions they are tested against.

The wrappers in ``ops/cuda/`` declare each entry point's ``argtypes`` (every
pointer and the stream as ``c_void_p``) and call :func:`check` on its return
value, the ``cudaGetLastError()`` of the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "keymorph_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v"]
LIB_NAME = "libkm_kernels.so"

_lock = threading.Lock()
_lib = None  # the loaded ctypes.CDLL (the port's one kernel-library handle)


def sources():
    return sorted(SOURCE_DIR.glob("*.cu")) + sorted(SOURCE_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source at first use"
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these sources exists; return
    its path. The compiler's output (``-Xptxas=-v``: registers, shared
    memory, spills per kernel) is kept beside it in ``nvcc.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(SOURCE_DIR.glob("*.cu"))]
    # build to a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}"
        )
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.km_error_string.argtypes = [ctypes.c_int]
            lib.km_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = _lib.km_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    """The current PyTorch stream of ``device`` as a raw cudaStream_t."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
