"""ctypes bindings of the port's native (C++) data loader (counterpart of
``srganfd_tpu/data/native_loader.py``).

``NativeBatchLoader`` runs decode, crop and augmentation of the GT-crop
pipelines in a C++ thread pool (``csrc/loader.cc``, the port's copy of the
JAX package's ``native/loader.cc``) with no Python in the loop. Its batches
are the JAX loader's byte for byte for the same paths, crop, batch, seed,
``start_batch``, ``train`` and ``uint8``: every batch is a pure function of
(seed, batch id), emitted in id order whatever the thread count.

The library is built on first use with g++ into
``build/native/libloader-<hash>.so`` at the root of the checkout; the hash
covers the source and the flags, and the build writes a temporary name and
renames it, so processes that build at once never load half a file.
``available()`` is False where it cannot be built or loaded (no g++, no
libjpeg or libpng headers); ``unavailable_reason()`` says why, and callers
use the Python ``BatchLoader``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Iterator

import numpy as np
import torch

__all__ = ["available", "unavailable_reason", "NativeBatchLoader", "decode_image_native", "build", "BUILD_DIR",
           "CXX_FLAGS"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "loader.cc"
BUILD_DIR = _PKG.parent / "build" / "native"
# no -march=native: the library is built on the host that runs it, and the
# streams do not depend on the instruction set
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpng", "-lpthread")
# page-locked buffers of a pinned loader: a batch's buffer is written again
# RING batches later, so a prefetcher may keep fewer than RING in flight
RING = 4

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_reason = ""  # why the library is unavailable, once a load failed


def build() -> pathlib.Path:
    """Compile ``csrc/loader.cc`` unless a library of the same hash exists;
    returns its path. Raises ``RuntimeError`` with g++'s stderr on failure."""
    flags = " ".join(CXX_FLAGS + LIBS)
    digest = hashlib.sha256(SOURCE.read_bytes() + flags.encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libloader-{digest}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native loader is built from source on first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr.strip()}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    lib.loader_create3.restype = p
    lib.loader_create3.argtypes = [ctypes.POINTER(ctypes.c_char_p), i, i, i, u64, i, i, i, u64]
    lib.loader_next.restype = i
    lib.loader_next.argtypes = [p, p]
    lib.loader_destroy.argtypes = [p]
    lib.decode_image.restype = i
    lib.decode_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), i, i,
                                 ctypes.POINTER(i), ctypes.POINTER(i)]


def _load() -> ctypes.CDLL | None:
    global _lib, _reason
    with _lock:
        if _lib is None and not _reason:
            try:
                lib = ctypes.CDLL(str(build()))
                _bind(lib)
                _lib = lib
            except (OSError, AttributeError, RuntimeError) as e:
                _reason = str(e).splitlines()[0] if str(e) else type(e).__name__
                if isinstance(e, RuntimeError) and "\n" in str(e):  # the compiler's first error line
                    _reason += " " + next((ln for ln in str(e).splitlines()[1:] if "error" in ln), "").strip()
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    return _load() is not None


def unavailable_reason() -> str:
    """Why :func:`available` is False ("" when it is True)."""
    _load()
    return _reason


class NativeBatchLoader:
    """Infinite iterator of ``{"gt": (N, crop, crop, 3)}`` batches decoded
    and augmented natively: f32 in [0, 1], or with ``uint8`` the raw bytes
    (the chains divide by 255 on the device: a quarter of the transfer).

    ``pinned`` writes each batch straight into page-locked ``torch``
    buffers, a ring of ``RING`` of them, and yields the buffer itself, so
    that ``parallel.prefetch_to_device`` copies it to the card
    asynchronously; a yielded buffer is written again ``RING`` batches
    later, which a prefetcher of ``size`` < ``RING`` allows (it waits for
    each copy before it yields the batch). Without ``pinned`` each batch is
    a fresh numpy array, as the JAX loader yields."""

    def __init__(
        self,
        image_paths: list[str],
        crop: int,
        batch_size: int,
        seed: int = 0,
        num_threads: int = 4,
        train: bool = True,
        uint8: bool = False,
        start_batch: int = 0,
        pinned: bool = False,
    ) -> None:
        """``start_batch`` seeks the stream: the first batch yielded is
        batch ``start_batch``, an O(1) skip for a step-exact resume."""
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_reason}")
        self._lib = lib
        self.crop, self.batch_size, self.uint8 = crop, batch_size, uint8
        arr = (ctypes.c_char_p * len(image_paths))(*[p.encode() for p in image_paths])
        self._handle = lib.loader_create3(arr, len(image_paths), crop, batch_size, seed, num_threads, int(train),
                                          int(uint8), int(start_batch))
        shape = (batch_size, crop, crop, 3)
        if pinned:
            dtype = torch.uint8 if uint8 else torch.float32
            self._ring = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(RING)]
        else:
            self._ring = None
            self._buf = np.empty(shape, np.uint8 if uint8 else np.float32)

    def __iter__(self) -> Iterator[dict]:
        n = 0
        while True:
            if self._ring is not None:
                out = self._ring[n % len(self._ring)]
                n += 1
                if not self._lib.loader_next(self._handle, ctypes.c_void_p(out.data_ptr())):
                    return
                yield {"gt": out}
            else:
                if not self._lib.loader_next(self._handle, self._buf.ctypes.data_as(ctypes.c_void_p)):
                    return
                yield {"gt": self._buf.copy()}

    def close(self) -> None:
        """Stop the worker threads; the iterator then ends."""
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def decode_image_native(path: str, max_side: int = 8192) -> np.ndarray | None:
    """One image as f32 RGB [0, 1] through the native decoder; None where it
    cannot be decoded (or the library is unavailable)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty((max_side, max_side, 3), np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.decode_image(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_side, max_side,
                          ctypes.byref(h), ctypes.byref(w))
    if rc != 1:
        return None
    return buf.reshape(-1)[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()
