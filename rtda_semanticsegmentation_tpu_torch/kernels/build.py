"""Build a CUDA source of the package into a shared library, at first use.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the repository
root, under a name that carries a hash of the source and of the shared
``csrc/*.cuh`` headers, then loaded with ``ctypes``. Nothing is compiled
when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..obs.spans import setup_span

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# What the build of each loaded source printed (ptxas register and spill
# report) and how long it took, from its ``kernels.build`` span (0 when the
# library was already built; the report is then read back from the log kept
# beside it), for chip_smoke.py and the benchmark to show.
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
    """Compile ``source`` (relative to the package) if needed and load it,
    in a ``kernels.build`` span (``obs/spans.py``)."""
    with setup_span("kernels.build") as build:
        src = PACKAGE_DIR / source
        headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
        digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
        log_path = lib_path.with_suffix(".log")
        built = not lib_path.exists()
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
            log = (proc.stdout + proc.stderr).strip()
            log_path.write_text(log)
            os.replace(tmp, lib_path)
        else:
            log = log_path.read_text() if log_path.exists() else ""
        library = ctypes.CDLL(str(lib_path))
    build_log[source] = {"seconds": build.host_ms * 1e-3 if built else 0.0, "log": log}
    return library


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_of(x: torch.Tensor) -> int:
    """The current stream of ``x``'s card, as the launch functions take it."""
    return torch._C._cuda_getCurrentRawStream(x.device.index or 0)


def launch(fn, x: torch.Tensor, *args) -> None:
    """Calls the library's launch function ``fn`` with ``x``'s card current
    and raises on the CUDA error it returns."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            err = fn(*args)
    else:
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
