"""ctypes bindings for the native host decode (``_native/fastdata.cpp``), the
port's copy of the JAX package's ``data/native.py``.

The C++ library does PNG/JPEG decode + PIL-compatible resize (+ the RGB ->
trainId LUT for on-the-fly GTA5 labels) in one GIL-released call per
sample, bit-identical to the PIL path. It runs on the host, not the device.

The shared library is compiled on first use with the system ``g++`` into
``build/native/`` at the repository root (as ``kernels/build.py`` places
the CUDA kernels), under a name keyed by a hash of the source. A host
without the toolchain or the libpng / libjpeg headers reports
``available() == False``; the datasets then decode with PIL under
``native_decode='auto'`` (with a warning) and raise under ``'on'``. The
environment variable ``RTDA_NATIVE_DECODE=1|0`` forces the library or PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "_native" / "fastdata.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lpng", "-ljpeg", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _build() -> str:
    """Compile fastdata.cpp -> build/native/libfastdata-<hash>.so; returns
    the library's path."""
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX_FLAGS + _LIBS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libfastdata-{tag}.so"
    if so_path.exists():
        return str(so_path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # atomic: build to a temp name, rename into place
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *_CXX_FLAGS, str(_SRC), "-o", tmp, *_LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, FileNotFoundError) as e:
        os.unlink(tmp)
        detail = getattr(e, "stderr", "") or str(e)
        raise RuntimeError(f"fastdata build failed: {detail[:500]}")
    os.replace(tmp, so_path)
    return str(so_path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        if os.environ.get("RTDA_NATIVE_DECODE", "") == "0":
            _lib_error = "disabled via RTDA_NATIVE_DECODE=0"
            return None
        try:
            lib = ctypes.CDLL(_build())
            lib.fd_load_image.restype = ctypes.c_int
            lib.fd_load_image.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.fd_load_label.restype = ctypes.c_int
            lib.fd_load_label.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
            lib.fd_error_name.restype = ctypes.c_char_p
            lib.fd_error_name.argtypes = [ctypes.c_int]
            if lib.fd_version() != 1:
                raise RuntimeError(f"fastdata ABI version {lib.fd_version()} != 1")
            _lib = lib
        except Exception as e:  # no toolchain: the datasets decide (auto -> PIL, on -> raise)
            _lib_error = str(e)
            if os.environ.get("RTDA_NATIVE_DECODE") == "1":
                raise
            warnings.warn(f"native data path unavailable ({_lib_error[:200]}); using the PIL decode path")
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    _load()
    return _lib_error


def _err(lib, path: str, code: int) -> OSError:
    return OSError(f"fastdata: {lib.fd_error_name(code).decode()} ({path})")


def load_image(path: str, size: Tuple[int, int]) -> np.ndarray:
    """Decode + bilinear-resize to (H, W); returns uint8 (H, W, 3)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native data path unavailable: {_lib_error}")
    h, w = size
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.fd_load_image(os.fsencode(path), out.ctypes.data_as(ctypes.c_void_p), h, w)
    if rc != 0:
        raise _err(lib, path, rc)
    return out


def load_label(path: str, size: Tuple[int, int], rgb_lut: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode + nearest-resize a label to (H, W); returns int32 (H, W).

    Grayscale / palette labels pass their raw values through; RGB labels are
    mapped via ``rgb_lut`` (the ``labels.build_color_to_id_lut()`` table) —
    without one, RGB labels raise and the caller falls back to PIL.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native data path unavailable: {_lib_error}")
    h, w = size
    out = np.empty((h, w), np.int32)
    lut_ptr = None
    if rgb_lut is not None:
        lut = np.ascontiguousarray(rgb_lut, np.uint8)
        if lut.size != 256**3:
            # a wrong-sized table would mean out-of-bounds reads in C
            raise ValueError(f"rgb_lut must have 256^3 entries, got {lut.shape}")
        lut_ptr = lut.ctypes.data_as(ctypes.c_void_p)  # lut stays alive for the call
    rc = lib.fd_load_label(os.fsencode(path), lut_ptr, out.ctypes.data_as(ctypes.c_void_p), h, w)
    if rc != 0:
        raise _err(lib, path, rc)
    return out
