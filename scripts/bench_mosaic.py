"""Full-res JWST mosaic scale sanity: 13759x12451 f32 plane on one card.
BASELINE.json config #4: stats, auto-STF and preview at full res.

Run from the repository root: python scripts/bench_mosaic.py"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax, jax.numpy as jnp

H, W = 13759, 12451
print(f"plane: {H}x{W} = {H*W/1e6:.1f} Mpx = {H*W*4/1e9:.2f} GB f32",
      file=sys.stderr, flush=True)

key = jax.random.PRNGKey(0)
@jax.jit
def synth(key):
    base = 100.0 + 10.0 * jax.random.normal(key, (H, W), jnp.float32)
    yy = jnp.arange(H, dtype=jnp.float32)[:, None]
    xx = jnp.arange(W, dtype=jnp.float32)[None, :]
    glow = 400.0 * jnp.exp(-(((yy - H/2)**2 + (xx - W/2)**2) / 5e7))
    return base + glow

t0 = time.perf_counter()
plane = synth(key); plane.block_until_ready()
print(f"synth on device: {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)

from astroburst_tpu.ops.stats import stats_core
from astroburst_tpu.imaging.stf import auto_stf_traced, apply_stf_traced
from astroburst_tpu.ops.ipc import nearest_downsample

@jax.jit
def full_pipeline(x):
    mn, mx, _t, count, med, mad = stats_core(x, False)
    sigma = jnp.maximum(mad * 1.4826, 1e-30)
    shadow, midtone = auto_stf_traced(mn, mx, med, sigma, count)
    stretched = apply_stf_traced(x, mn, mx, shadow, midtone)
    preview = nearest_downsample(stretched, 4096)
    return (jnp.sum(preview[::64, ::64]).astype(jnp.float32), mn, mx, med)

t0 = time.perf_counter()
cs, mn, mx, med = full_pipeline(plane)
v = float(cs)
print(f"stats+stf+preview first (compile+run): {time.perf_counter()-t0:.1f}s",
      file=sys.stderr, flush=True)
print(f"  min={float(mn):.2f} max={float(mx):.2f} med={float(med):.2f}",
      file=sys.stderr, flush=True)
assert np.isfinite(v) and float(mn) < float(med) < float(mx)
t0 = time.perf_counter()
cs2, *_ = full_pipeline(plane + jnp.float32(1e-5))
_ = float(cs2)
print(f"steady: {(time.perf_counter()-t0)*1e3:.0f} ms", file=sys.stderr, flush=True)
print("MOSAIC SCALE OK", file=sys.stderr, flush=True)
