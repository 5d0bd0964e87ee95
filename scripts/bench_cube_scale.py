"""2 GB IFU cube scale smoke (BASELINE config #5): write a real
500x1000x1000 f32 BITPIX=-32 cube to a temporary directory, open it
lazily and run the cube command surface end to end, then the sharded
FFT stages over an 8-device virtual CPU mesh.

Run from the repository root: python scripts/bench_cube_scale.py"""
import shutil, sys, time, os, tempfile
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
work = tempfile.mkdtemp(prefix="cube_scale_")
os.environ.setdefault("ASTROBURST_CONFIG_DIR", os.path.join(work, "config"))
os.environ.setdefault("ASTROBURST_DATA_DIR", os.path.join(work, "data"))
import jax
import numpy as np

p = os.path.join(work, "big_cube.fits")
B, H, W = 500, 1000, 1000

t0 = time.perf_counter()
# stream-write the FITS cube without holding 2 GB in RAM
hdr_cards = []
def card(k, v):
    return f"{k:<8}= {v:>20}".ljust(80).encode()
hdr = (card("SIMPLE", "T") + card("BITPIX", "-32") + card("NAXIS", "3")
       + card("NAXIS1", str(W)) + card("NAXIS2", str(H))
       + card("NAXIS3", str(B)) + "END".ljust(80).encode())
hdr += b" " * (2880 - len(hdr) % 2880)
rng = np.random.default_rng(0)
with open(p, "wb") as f:
    f.write(hdr)
    for b in range(B):
        plane = (100.0 + 0.05 * b + rng.standard_normal((H, W)).astype(np.float32))
        f.write(plane.astype(">f4").tobytes())
    pad = (2880 - (f.tell() % 2880)) % 2880
    f.write(b"\0" * pad)
print(f"wrote {os.path.getsize(p)/1e9:.2f} GB in {time.perf_counter()-t0:.0f}s", flush=True)

import astroburst_tpu.api as api
t0 = time.perf_counter()
info = api.get_cube_info(p)
print(f"get_cube_info: {info} in {time.perf_counter()-t0:.1f}s", flush=True)

t0 = time.perf_counter()
out = api.process_cube_lazy_cmd(p, work, frame_step=50)
print(f"process_cube_lazy: keys={sorted(out.keys())[:8]} "
      f"in {time.perf_counter()-t0:.0f}s", flush=True)

t0 = time.perf_counter()
fr = api.get_cube_frame(p, 250)
print(f"get_cube_frame(250): {sorted(fr.keys())[:5]} in {time.perf_counter()-t0:.1f}s", flush=True)

t0 = time.perf_counter()
sp = api.get_cube_spectrum(p, 500, 500)
spec = sp.get("spectrum") or sp.get("values")
print(f"get_cube_spectrum: len={len(spec)} in {time.perf_counter()-t0:.1f}s", flush=True)
# spectral ramp must show: frame b mean ~ 100 + 0.05 b
s = np.asarray(spec)
assert s[400] > s[100], (s[100], s[400])
print("CUBE SCALE OK", flush=True)

# sharded FFT stages over an 8-virtual-device mesh on a cube slice
# (BASELINE config #5: "FFT power spectrum + deconvolution sharded
# over mesh") — an 8-device virtual CPU mesh; the same code drives
# real cards
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax.extend as jex
jex.backend.clear_backends()
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from astroburst_tpu.analysis.deconvolution import generate_gaussian_psf
from astroburst_tpu.dtypes import RLConfig
from astroburst_tpu.parallel import make_mesh
from astroburst_tpu.parallel.fft import (sharded_deconvolve,
                                         sharded_power_spectrum)
from astroburst_tpu.cube.lazy import LazyCube

mesh = make_mesh(8, ("rows",), (8,))
cube = LazyCube(p)
frame = jnp.asarray(np.asarray(cube.get_frame(250), np.float32))
t0 = time.perf_counter()
est, iters, conv = sharded_deconvolve(mesh, frame,
                                      generate_gaussian_psf(15, 2.0),
                                      RLConfig(iterations=10))
est.block_until_ready()
print(f"sharded RL 1000x1000 x10 over 8 shards: {iters} iters in "
      f"{time.perf_counter()-t0:.1f}s", flush=True)
t0 = time.perf_counter()
spec = sharded_power_spectrum(mesh, frame)
spec.block_until_ready()
print(f"sharded power spectrum: {spec.shape} in "
      f"{time.perf_counter()-t0:.1f}s", flush=True)
print("SHARDED FFT STAGES OK", flush=True)
shutil.rmtree(work, ignore_errors=True)
