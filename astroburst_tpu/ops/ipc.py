"""Binary pixel protocol for raw previews.

Reference: src-tauri/src/infra/ipc.rs — 16-byte header
[w: u32, h: u32, min: f32, max: f32] little-endian, then raw f32
pixels; NaN/inf scrubbed to 0; nearest-neighbor downsample to a max
dimension (ipc.rs:105-147). The scan and scrub run on device; only the
downsampled plane crosses to the host.
"""

from __future__ import annotations

import struct

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _scrub_and_scan(x: jax.Array):
    finite = jnp.isfinite(x)
    clean = jnp.where(finite, x, 0.0)
    mn = jnp.min(jnp.where(finite, x, jnp.inf))
    mx = jnp.max(jnp.where(finite, x, -jnp.inf))
    mn = jnp.where(jnp.isfinite(mn), mn, 0.0)
    mx = jnp.where(jnp.isfinite(mx), mx, 0.0)
    return clean, mn, mx


def nearest_downsample(x: jax.Array, max_dim: int) -> jax.Array:
    """Nearest-neighbor downsample to fit max_dim — the reference's
    exact-ratio index map (ipc.rs:105-147): dst dims are
    round(src·max_dim/max(h,w)), source index floor(d·src/dst).

    Implemented as two index-VECTOR takes (the exact-ratio index map
    is not a uniform stride).
    """
    h, w = x.shape
    if h <= max_dim and w <= max_dim:
        return x
    scale = max_dim / max(h, w)
    dst_h = max(int(round(h * scale)), 1)
    dst_w = max(int(round(w * scale)), 1)
    rows = jnp.minimum((jnp.arange(dst_h) * (h / dst_h)).astype(jnp.int32),
                       h - 1)
    cols = jnp.minimum((jnp.arange(dst_w) * (w / dst_w)).astype(jnp.int32),
                       w - 1)
    return jnp.take(jnp.take(x, rows, axis=0), cols, axis=1)


def encode_with_header_views(x: jax.Array, max_dim: int):
    """(header bytes, pixel memoryview) — the pixel payload is a
    zero-copy view of the fetched plane, mirroring the reference's
    clean-path byte reinterpret (infra/ipc.rs:63-73). Scatter-gather
    writers (writev, websocket fragments) send both without ever
    copying the pixels; the single-buffer form below costs one copy.
    """
    small = nearest_downsample(x, max_dim)
    clean, mn, mx = _scrub_and_scan(small)
    arr = np.ascontiguousarray(np.asarray(clean), dtype="<f4")
    return frame_preview_host(arr, float(mn), float(mx))


def frame_preview_host(arr: np.ndarray, mn: float, mx: float):
    """Host-side framing of an already-fetched little-endian f32 plane:
    16-byte header + zero-copy pixel view."""
    h, w = arr.shape
    header = struct.pack("<IIff", w, h, mn, mx)
    return header, memoryview(arr).cast("B")


def encode_with_header_downsampled(x: jax.Array, max_dim: int) -> bytearray:
    header, pixels = encode_with_header_views(x, max_dim)
    out = bytearray(len(header) + len(pixels))
    out[:16] = header
    out[16:] = pixels  # ONE copy (the old header+tobytes form made two)
    return out


def decode_binary_pixels(data: bytes):
    """Inverse of encode_with_header_downsampled (for tests/clients)."""
    w, h, mn, mx = struct.unpack("<IIff", data[:16])
    arr = np.frombuffer(data[16:], dtype="<f4").reshape(h, w)
    return arr, mn, mx
