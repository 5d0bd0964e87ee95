"""Pillow-free PNG writer (io/png.py) against the spec decoder in
tests/reference_impl/png.py: every mode the reference writes
(render/grayscale.rs, render/rgb.rs) round-trips exactly through zlib."""

import numpy as np
import pytest

from astroburst_tpu.errors import InvalidInput
from astroburst_tpu.io.png import (encode_png, save_gray_png, save_rgb_png,
                                   write_png)
from tests.reference_impl import ref_decode_png


@pytest.mark.parametrize("shape,depth", [((13, 17), 8), ((13, 17), 16),
                                         ((9, 11, 3), 8), ((9, 11, 3), 16)])
def test_png_roundtrip_exact(rng, shape, depth):
    top = 256 if depth == 8 else 65536
    px = rng.integers(0, top, shape).astype(np.uint8 if depth == 8
                                            else np.uint16)
    px.flat[0] = 0
    px.flat[-1] = top - 1
    back = ref_decode_png(encode_png(px, depth))
    assert back.dtype == px.dtype
    np.testing.assert_array_equal(back, px)


def test_png_header_and_file_writers(rng, tmp_path):
    g = rng.integers(0, 256, (6, 5)).astype(np.uint8)
    p = str(tmp_path / "g.png")
    save_gray_png(g, p)
    data = open(p, "rb").read()
    # IHDR: width, height, depth 8, colour type 0 (grayscale)
    assert data[16:26] == (5).to_bytes(4, "big") + (6).to_bytes(4, "big") \
        + bytes([8, 0])
    np.testing.assert_array_equal(ref_decode_png(data), g)
    r, gg, b = (rng.integers(0, 256, (4, 7)) for _ in range(3))
    p3 = str(tmp_path / "rgb.png")
    save_rgb_png(r, gg, b, p3)
    np.testing.assert_array_equal(ref_decode_png(open(p3, "rb").read()),
                                  np.stack([r, gg, b], -1).astype(np.uint8))
    p16 = str(tmp_path / "g16.png")
    write_png(np.full((3, 3), 40000, np.uint16), p16, 16)
    assert ref_decode_png(open(p16, "rb").read()).max() == 40000


@pytest.mark.parametrize("pixels,depth", [
    (np.zeros((4, 4, 2), np.uint8), 8),     # two channels: no such mode
    (np.zeros(16, np.uint8), 8),            # not a plane
    (np.zeros((4, 4), np.uint8), 12),       # unsupported depth
])
def test_png_rejects_unsupported_input(pixels, depth):
    with pytest.raises(InvalidInput):
        encode_png(pixels, depth)


_IMPORT_PROBE = r"""
import sys, os, json
import numpy as np, scipy, jax
before = set(sys.modules)
import astroburst_tpu.api as api
from astroburst_tpu.io.fits_writer import write_fits_mono
d = sys.argv[1]
rng = np.random.default_rng(0)
paths = []
for k in range(3):
    p = os.path.join(d, f"f{k}.fits")
    write_fits_mono(p, rng.normal(100, 5, (64, 80)).astype(np.float32),
                    None, bitpix=-32)
    paths.append(p)
api.stack(paths, os.path.join(d, "out"))
api.process_fits_full(paths[0], os.path.join(d, "out"))
new = {m.split(".")[0] for m in set(sys.modules) - before}
print(json.dumps(sorted(new - set(sys.stdlib_module_names))))
"""


def test_main_path_imports_only_jax_numpy_scipy(tmp_path):
    """api.stack and api.process_fits_full (PNG previews included) pull
    in no third-party module beyond what JAX, numpy and scipy bring."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               ASTROBURST_CONFIG_DIR=str(tmp_path / "config"),
               ASTROBURST_DATA_DIR=str(tmp_path / "data"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_PROBE, str(tmp_path)],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    new = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(new) <= {"astroburst_tpu", "jax", "jaxlib", "numpy",
                        "scipy"}, new
