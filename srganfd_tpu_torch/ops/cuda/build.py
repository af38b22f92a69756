"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``srganfd_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and
compiles, on first use, into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout. The hash covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. A failed
build raises with nvcc's stderr.

Nothing here runs at import: the CPU tests import every module of the
package, and only a CUDA tensor reaches :func:`load_library`.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "build_all", "load_library"]

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": nvcc wall time, "log": nvcc's stderr (ptxas register
# and spill report)}; filled only by builds made in this process
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from source on first use"
        )
    return found


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists;
    returns the library's path."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": proc.stderr}
    return lib


def build_all() -> list[str]:
    """Build every ``csrc/*.cu`` at once, one nvcc process per source."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()
    return names


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>`` (built first if needed), cached per process."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]
