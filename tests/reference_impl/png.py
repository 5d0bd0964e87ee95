"""PNG decoder oracle (PNG spec, ISO/IEC 15948): chunks with CRC
checks, zlib IDAT, all five scanline filters, grayscale and truecolor
at bit depth 8 or 16, no interlace. Independent of io/png.py's writer,
which only ever emits filter 0."""

import struct
import zlib

import numpy as np


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def ref_decode_png(data: bytes) -> np.ndarray:
    """[H, W] (gray) or [H, W, 3] (RGB) array of u8 or u16 samples."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    off, idat, ihdr = 8, b"", None
    while off < len(data):
        ln, tag = struct.unpack(">I4s", data[off:off + 8])
        payload = data[off + 8:off + 8 + ln]
        crc, = struct.unpack(">I", data[off + 8 + ln:off + 12 + ln])
        assert crc == zlib.crc32(tag + payload) & 0xFFFFFFFF, tag
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        off += 12 + ln
    w, h, depth, color, _comp, _filt, interlace = ihdr
    assert interlace == 0 and depth in (8, 16) and color in (0, 2)
    channels = 1 if color == 0 else 3
    bpp = channels * depth // 8
    stride = w * bpp
    raw = zlib.decompress(idat)
    out = bytearray(h * stride)
    prev = bytearray(stride)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = bytearray(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        for i in range(stride):
            a = line[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            line[i] = (line[i] + pred) & 0xFF
        out[y * stride:(y + 1) * stride] = line
        prev = line
    arr = np.frombuffer(bytes(out), ">u2" if depth == 16 else np.uint8)
    arr = arr.astype(np.uint16 if depth == 16 else np.uint8)
    return arr.reshape((h, w) if channels == 1 else (h, w, 3))
