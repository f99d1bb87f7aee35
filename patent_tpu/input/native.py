"""ctypes bindings for the native data-loader (native/patent_io.cc).

Loads ``libpatent_io.so`` from ``native/build/<key>/``, building it with
native/build.sh (g++, ``-march=native``) on first use.  ``<key>`` hashes the
source, the build script, the machine type and the CPU's feature flags, so
a library built on another host is never loaded.  Exposes:

* ``native_available()`` — whether the fast path is usable,
* ``decode_image_native(path, size)`` — one image → CLIP-normalized
  [S, S, 3] float32 (None on failure, like pipeline.decode_image),
* ``decode_batch_native(paths, size, threads)`` — threaded C++ batch decode
  → (batch array, per-image ok mask).

Non-PNG/exotic files fail with a negative status; callers fall back to the
PIL path per image, preserving the skip policy (src/models.py:51-66).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

from .pipeline import CLIP_MEAN, CLIP_STD

_LIB = None
_TRIED = False

_MEAN = np.ascontiguousarray(CLIP_MEAN, np.float32)
_INV_STD = np.ascontiguousarray(1.0 / CLIP_STD, np.float32)


_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.processor()


def build_key() -> str:
    """Hash of the source, the build script and this host's CPU."""
    h = hashlib.sha256()
    for name in ("patent_io.cc", "build.sh"):
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(platform.machine().encode())
    h.update(_cpu_flags().encode())
    return h.hexdigest()[:16]


def _lib_path() -> str:
    return os.path.join(_NATIVE_DIR, "build", build_key(), "libpatent_io.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        try:
            subprocess.run(["/bin/sh", os.path.join(_NATIVE_DIR, "build.sh"),
                            path], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.patent_io_decode.restype = ctypes.c_int
    lib.patent_io_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.patent_io_decode_batch.restype = None
    lib.patent_io_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    lib.patent_io_probe.restype = ctypes.c_int
    lib.patent_io_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_image_native(path: str, image_size: int = 224) -> np.ndarray | None:
    """Native decode of one PNG; None on any failure (caller may fall back)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((image_size, image_size, 3), np.float32)
    rc = lib.patent_io_decode(path.encode(), image_size, _fptr(_MEAN),
                              _fptr(_INV_STD), _fptr(out))
    return out if rc == 0 else None


def probe_native(path: str) -> tuple[int, int, int] | None:
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.patent_io_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c))
    return (w.value, h.value, c.value) if rc == 0 else None


def decode_batch_native(paths: list[str], image_size: int = 224,
                        num_threads: int = 4
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded batch decode → ([n, S, S, 3] float32, [n] bool ok mask).

    Rows for failed decodes are zero; callers retry those via PIL.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(paths)
    out = np.zeros((n, image_size, image_size, 3), np.float32)
    status = np.empty(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.patent_io_decode_batch(arr, n, image_size, _fptr(_MEAN),
                               _fptr(_INV_STD), _fptr(out),
                               status.ctypes.data_as(
                                   ctypes.POINTER(ctypes.c_int32)),
                               num_threads)
    return out, status == 0


def decode_batch_native_u8(paths: list[str], image_size: int = 224,
                           num_threads: int = 4
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Threaded batch decode → ([n, S, S, 3] uint8 RGB, [n] ok mask).

    Normalization is deferred to the device (see
    retrieval.engine.device_normalize): uint8 transfer is 4× smaller than
    the float32 path — the host→device link is the encode pipeline's
    bottleneck at production batch sizes.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not hasattr(lib, "patent_io_decode_batch_u8"):
        raise RuntimeError("native library too old; rebuild native/build.sh")
    lib.patent_io_decode_batch_u8.restype = None
    lib.patent_io_decode_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    n = len(paths)
    out = np.zeros((n, image_size, image_size, 3), np.uint8)
    status = np.empty(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.patent_io_decode_batch_u8(
        arr, n, image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    return out, status == 0
