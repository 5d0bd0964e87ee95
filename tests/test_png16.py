"""True 16-bit RGB PNG writer (reference: render/rgb.rs:49-95 Rgb16)."""

import struct
import zlib

import numpy as np
import pytest

from astroburst_tpu.io.png import save_rgb_png, write_png_rgb16

cv2 = pytest.importorskip("cv2")


def test_rgb16_exact_roundtrip_independent_decoder(rng, tmp_path):
    rgb = rng.integers(0, 65536, (37, 53, 3)).astype(np.uint16)
    rgb[0, 0] = [0, 0, 0]
    rgb[-1, -1] = [65535, 65535, 65535]
    path = str(tmp_path / "t16.png")
    write_png_rgb16(rgb, path)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back[:, :, ::-1], rgb)  # cv2 is BGR


def test_rgb16_chunk_structure_and_be_samples(rng, tmp_path):
    rgb = rng.integers(0, 65536, (5, 7, 3)).astype(np.uint16)
    path = str(tmp_path / "s16.png")
    write_png_rgb16(rgb, path)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    ln, tag = struct.unpack(">I4s", data[8:16])
    assert tag == b"IHDR" and ln == 13
    w, h, depth, color, comp, filt, inter = struct.unpack(
        ">IIBBBBB", data[16:29])
    assert (w, h, depth, color) == (7, 5, 16, 2)
    # decode IDAT by hand: filter byte 0 + big-endian u16 triples
    off = 8
    idat = b""
    while off < len(data):
        ln, tag = struct.unpack(">I4s", data[off:off + 8])
        payload = data[off + 8:off + 8 + ln]
        crc = struct.unpack(">I", data[off + 8 + ln:off + 12 + ln])[0]
        assert crc == zlib.crc32(tag + payload) & 0xFFFFFFFF
        if tag == b"IDAT":
            idat += payload
        off += 12 + ln
    raw = zlib.decompress(idat)
    stride = 1 + 7 * 6
    rows = [raw[i * stride:(i + 1) * stride] for i in range(5)]
    assert all(r[0] == 0 for r in rows)  # filter None
    decoded = np.frombuffer(b"".join(r[1:] for r in rows),
                            dtype=">u2").reshape(5, 7, 3)
    np.testing.assert_array_equal(decoded.astype(np.uint16), rgb)


def test_save_rgb_png_16bit_no_longer_downgrades(rng, tmp_path):
    r = rng.integers(0, 65536, (9, 11)).astype(np.uint16)
    g = np.zeros((9, 11), np.uint16)
    b = np.full((9, 11), 257, np.uint16)  # would alias to 1 after >>8
    path = str(tmp_path / "rgb16.png")
    save_rgb_png(r, g, b, path, bit_depth=16)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == np.uint16
    np.testing.assert_array_equal(back[:, :, 2], r)
    np.testing.assert_array_equal(back[:, :, 0], b)


@pytest.mark.parametrize("shape", [(21, 33), (17, 19, 3)])
def test_decoder_oracle_reads_filtered_scanlines(rng, shape):
    """The spec decoder oracle undoes every scanline filter an encoder
    may choose (cv2/libpng picks adaptive filters per row)."""
    from tests.reference_impl import ref_decode_png
    img = (rng.random(shape) * 255).astype(np.uint8)
    img[: shape[0] // 2] = np.arange(shape[1], dtype=np.uint8)[
        :, None] if len(shape) == 3 else np.arange(shape[1], dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    back = ref_decode_png(buf.tobytes())
    np.testing.assert_array_equal(back[..., ::-1] if len(shape) == 3
                                  else back, img)
