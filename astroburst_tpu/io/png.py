"""PNG encoding (reference: src-tauri/src/infra/render/{grayscale,rgb}.rs).

One direct chunk writer (signature + IHDR + zlib IDAT + IEND) covers
every mode the reference writes: 8- and 16-bit grayscale, 8-bit RGB and
true 16-bit RGB (``ColorType::Rgb16``, rgb.rs:49-95). Samples are
big-endian per the PNG spec; scanlines use filter 0 (None) — the
filter choice affects only compression, not decoded pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from astroburst_tpu.errors import InvalidInput

# PNG colour types: 0 = grayscale, 2 = truecolor (RGB)
_COLOR_TYPE = {1: 0, 3: 2}


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray, bit_depth: int = 8) -> bytes:
    """PNG bytes of an [H, W] grayscale or [H, W, 3] RGB plane at bit
    depth 8 (u8 samples) or 16 (u16 samples)."""
    arr = np.asarray(pixels)
    if bit_depth not in (8, 16):
        raise InvalidInput(f"PNG bit depth must be 8 or 16, got {bit_depth}")
    channels = 1 if arr.ndim == 2 else (arr.shape[2] if arr.ndim == 3
                                        else 0)
    if channels not in _COLOR_TYPE:
        raise InvalidInput(
            f"expected [H, W] grayscale or [H, W, 3] RGB, got {arr.shape}")
    h, w = arr.shape[:2]
    samples = np.ascontiguousarray(arr, ">u2" if bit_depth == 16 else
                                   np.uint8)
    row_bytes = w * channels * bit_depth // 8
    raw = samples.view(np.uint8).reshape(h, row_bytes)
    scanlines = np.concatenate(
        [np.zeros((h, 1), np.uint8), raw], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, _COLOR_TYPE[channels],
                       0, 0, 0)
    return b"".join([b"\x89PNG\r\n\x1a\n", _png_chunk(b"IHDR", ihdr),
                     _png_chunk(b"IDAT", zlib.compress(scanlines, 6)),
                     _png_chunk(b"IEND", b"")])


def write_png(pixels: np.ndarray, path: str, bit_depth: int = 8) -> None:
    data = encode_png(pixels, bit_depth)
    with open(path, "wb") as f:
        f.write(data)


def write_png_rgb16(rgb: np.ndarray, path: str) -> None:
    """Write [H, W, 3] u16 as a true 16-bit-per-channel RGB PNG
    (rgb.rs:49-95: bit depth 16, colour type 2)."""
    arr = np.asarray(rgb)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise InvalidInput(f"expected [H, W, 3] RGB, got {arr.shape}")
    write_png(arr.astype(np.uint16), path, 16)


def save_gray_png(pixels: np.ndarray, path: str, bit_depth: int = 8) -> None:
    """Save a mono u8/u16 plane as PNG."""
    arr = np.asarray(pixels)
    if arr.ndim != 2:
        raise InvalidInput(f"expected 2D grayscale, got {arr.shape}")
    dtype = np.uint16 if bit_depth == 16 else np.uint8
    write_png(arr.astype(dtype), path, bit_depth)


def save_rgb_png(r: np.ndarray, g: np.ndarray, b: np.ndarray, path: str,
                 bit_depth: int = 8) -> None:
    """Save three planes as an RGB PNG (u8, or true u16 at bit_depth 16)."""
    rgb = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1)
    dtype = np.uint16 if bit_depth == 16 else np.uint8
    write_png(rgb.astype(dtype), path, bit_depth)
