"""ctypes binding of libkmio, the data layer's C++ host helper.

Port of ``keymorph_tpu/native/kmio.py``: gzip inflation of a whole file and
a trilinear / nearest volume resize, on the host. The library is built at
first use from ``kmio.cpp`` beside this file:

    g++ -O3 -fPIC -shared -std=c++17 kmio.cpp -o libkmio.so -lz

into ``build/keymorph_tpu_torch/<hash>/`` at the repository root
(``_build.BUILD_ROOT``, beside the CUDA kernels; the hash covers the source
and the flags); nothing is written into the package. Where the build
fails (no compiler, no zlib), :func:`available` is False,
:func:`build_error` says why, and the data layer reads ``.gz`` files through
Python's ``gzip`` instead.
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
from typing import Optional

import numpy as np

from keymorph_tpu_torch._build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parent / "kmio.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
LIB_NAME = "libkmio.so"

_lock = threading.Lock()
_lib = None
_tried = False
_error: Optional[str] = None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + ["-lz"]).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless one for this source exists; return its
    path (raises where the compiler fails)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp, "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = str(e)
            return None
        lib.km_gunzip.restype = ctypes.c_longlong
        lib.km_gunzip.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)]
        lib.km_free.argtypes = [ctypes.c_char_p]
        fp, i = ctypes.POINTER(ctypes.c_float), ctypes.c_int
        lib.km_resize_trilinear.restype = i
        lib.km_resize_trilinear.argtypes = [fp, i, i, i, fp, i, i, i, i]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it on first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None where it is)."""
    _load()
    return _error


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"libkmio is not available: {_error}")
    return lib


def gunzip_file(path: str) -> bytes:
    """Inflate a whole ``.gz`` file through zlib."""
    lib = _require()
    out = ctypes.c_char_p()
    n = lib.km_gunzip(str(path).encode(), ctypes.byref(out))
    if n < 0:
        raise IOError(f"km_gunzip failed on {path} (code {n})")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.km_free(out)


def resize_trilinear(src: np.ndarray, target, nearest: bool = False) -> np.ndarray:
    """Resize a 3D float32 volume to ``target`` (trilinear, or nearest with
    round half to even), output voxel centres mapped as ``align_corners=False``."""
    lib = _require()
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 3:
        raise ValueError(f"resize_trilinear: a 3D volume, got shape {src.shape}")
    out = np.empty(tuple(int(t) for t in target), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.km_resize_trilinear(src.ctypes.data_as(fp), *src.shape, out.ctypes.data_as(fp),
                                 *out.shape, 1 if nearest else 0)
    if rc != 0:
        raise RuntimeError(f"km_resize_trilinear failed ({rc})")
    return out
