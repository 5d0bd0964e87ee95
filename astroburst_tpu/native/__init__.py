"""Native host kernels (C++/OpenMP) with build-on-demand + fallback.

The device does the pixel math; this covers the host-side byte work the
reference implements in Rust: big-endian FITS decode/encode and masked
scans over mmap'd bytes. Loaded via ctypes; everything degrades to the
vectorized numpy paths if the shared library can't be built.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libastro_io.so")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-s", "-C", _DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except (subprocess.SubprocessError, OSError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("ASTROBURST_NO_NATIVE"):
            return None
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.astro_decode_pixels.restype = ctypes.c_int
        lib.astro_decode_pixels.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_double, ctypes.c_double]
        lib.astro_encode_be_f32.restype = None
        lib.astro_encode_be_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.astro_encode_be_i16.restype = None
        lib.astro_encode_be_i16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double]
        try:
            lib.astro_encode_be_to_fd.restype = ctypes.c_int
            lib.astro_encode_be_to_fd.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_double, ctypes.c_double, ctypes.c_int]
        except AttributeError:
            pass  # stale .so without the symbol; writer falls back
        lib.astro_masked_scan.restype = None
        lib.astro_masked_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_lib() is not None


def decode_pixels_native(raw, bitpix: int, bscale: float,
                         bzero: float) -> Optional[np.ndarray]:
    """OpenMP BE decode; None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(raw, dtype=np.uint8)
    bpp = abs(bitpix) // 8
    n = len(buf) // bpp
    out = np.empty(n, np.float32)
    rc = lib.astro_decode_pixels(
        buf.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        n, bitpix, float(bscale), float(bzero))
    if rc != 0:
        return None
    return out


def encode_be_f32_native(data: np.ndarray) -> "Optional[memoryview]":
    """BE-encoded payload as a zero-copy memoryview (bytes-like for
    write()/len()/slicing; call bytes() if an actual bytes object is
    required — that costs a full copy)."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(data, np.float32).ravel()
    out = np.empty(flat.size * 4, np.uint8)
    lib.astro_encode_be_f32(flat.ctypes.data_as(ctypes.c_void_p),
                            out.ctypes.data_as(ctypes.c_void_p), flat.size)
    # return the buffer itself (bytes-like); .tobytes() was a second
    # full copy of the payload on every FITS export
    return out.data


def encode_be_i16_native(data: np.ndarray, bzero: float,
                         bscale: float) -> "Optional[memoryview]":
    """See encode_be_f32_native: zero-copy memoryview, not bytes."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(data, np.float32).ravel()
    out = np.empty(flat.size * 2, np.uint8)
    lib.astro_encode_be_i16(flat.ctypes.data_as(ctypes.c_void_p),
                            out.ctypes.data_as(ctypes.c_void_p), flat.size,
                            float(bzero), float(bscale))
    return out.data


def encode_be_to_fd(data: np.ndarray, fd: int, bitpix: int,
                    bzero: float, bscale: float) -> bool:
    """BE-encode + write() to an open fd in cache-resident 4 MB chunks
    (one fused native call per plane): the source crosses DRAM once,
    where encode-to-a-full-size-buffer + f.write() re-reads the cold
    payload a third time."""
    lib = get_lib()
    if (lib is None or bitpix not in (16, -32)
            or not hasattr(lib, "astro_encode_be_to_fd")):
        return False
    flat = np.ascontiguousarray(data, np.float32).ravel()
    rc = lib.astro_encode_be_to_fd(
        flat.ctypes.data_as(ctypes.c_void_p), flat.size, bitpix,
        float(bzero), float(bscale), fd)
    return rc == 0


def masked_scan_native(data: np.ndarray):
    """(min, max, sum, count) with the 1e-7 validity rule; None if
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(data, np.float32).ravel()
    mn = ctypes.c_double()
    mx = ctypes.c_double()
    sm = ctypes.c_double()
    cnt = ctypes.c_int64()
    lib.astro_masked_scan(flat.ctypes.data_as(ctypes.c_void_p), flat.size,
                          ctypes.byref(mn), ctypes.byref(mx),
                          ctypes.byref(sm), ctypes.byref(cnt))
    return mn.value, mx.value, sm.value, int(cnt.value)
