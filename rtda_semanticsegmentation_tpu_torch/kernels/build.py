"""Build a CUDA source of the package into a shared library, at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the repository
root, under a name that carries a hash of the source, then loaded with
``ctypes``. Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# What the last build of each source printed (ptxas register and spill
# report) and how long it took, for chip_smoke.py to show.
build_log: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise FileNotFoundError("nvcc not found on PATH, in $CUDA_HOME or /usr/local/cuda")
    return path


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``source`` (relative to the package) if needed and load it."""
    src = PACKAGE_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
        build_log[source] = {
            "seconds": time.perf_counter() - t0,
            "log": (proc.stdout + proc.stderr).strip(),
        }
    return ctypes.CDLL(str(lib_path))
