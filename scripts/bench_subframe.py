"""BASELINE config #3 scale evidence: star-based affine alignment +
subframe selector metrics on a 16-frame JWST-NIRCam-sized set
(5655×2206). Reference: `affine.rs:129-270` + `subframe.rs` chain,
0.8 s published for the align half alone (tex:616).

Run from the repository root: python scripts/bench_subframe.py
"""

import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax
import jax.numpy as jnp

import bench_ops
from astroburst_tpu.alignment.fused_chain import (align_and_warp,
                                                  detect_ref_stars)
from astroburst_tpu.analysis.subframe import (analyze_subframe,
                                              normalize_weights)

H, W, N = 5655, 2206, 16


def main():
    print("backend:", jax.default_backend(), flush=True)
    base = bench_ops._star_field(H, W, 90, seed=8, amp=5000.0, fwhm=3.0,
                                 halos=True)
    rng = np.random.default_rng(2)
    frames = [jnp.asarray(base)]
    for k in range(1, N):
        th = math.radians(rng.uniform(-0.3, 0.3))
        ct, st = math.cos(th), math.sin(th)
        cy, cx = H / 2.0, W / 2.0
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        sx = ct * (xx - cx) - st * (yy - cy) + cx + rng.uniform(-6, 6)
        sy = st * (xx - cx) + ct * (yy - cy) + cy + rng.uniform(-6, 6)
        xi = np.clip(sx.astype(np.int32), 0, W - 1)
        yi = np.clip(sy.astype(np.int32), 0, H - 1)
        frames.append(jnp.asarray(
            base[yi, xi] + rng.normal(0, 1.5, (H, W)).astype(np.float32)))
    jax.block_until_ready(frames)

    # subframe metrics for every frame (detect + medians + weights)
    t0 = time.perf_counter()
    metrics = [analyze_subframe(f, f"frame_{i:02d}.fits")
               for i, f in enumerate(frames)]
    normalize_weights(metrics)
    t_metrics = time.perf_counter() - t0
    acc = sum(m.accepted for m in metrics)
    print(f"subframe metrics x{N}: {t_metrics:.2f} s "
          f"({t_metrics / N * 1e3:.0f} ms/frame, compile included), "
          f"accepted {acc}/{N}", flush=True)

    # star-based affine alignment of every frame to frame 0, shared
    # reference detection
    stars = detect_ref_stars(frames[0])
    t0 = time.perf_counter()
    n_ok = 0
    for f in frames[1:]:
        warped, res = align_and_warp(frames[0], f, ref_stars=stars)
        warped.block_until_ready()
        n_ok += res.method in ("affine", "rigid")
    t_align = time.perf_counter() - t0
    print(f"affine align x{N - 1} (shared ref stars): {t_align:.2f} s "
          f"({t_align / (N - 1) * 1e3:.0f} ms/frame, first-compile "
          f"included), star method on {n_ok}/{N - 1}", flush=True)

    # steady-state repeat (compiles cached)
    t0 = time.perf_counter()
    metrics = [analyze_subframe(f, f"frame_{i:02d}.fits")
               for i, f in enumerate(frames)]
    for f in frames[1:]:
        warped, res = align_and_warp(frames[0], f, ref_stars=stars)
        warped.block_until_ready()
    t_steady = time.perf_counter() - t0
    print(f"steady-state metrics+align, {N} frames: {t_steady:.2f} s "
          f"({t_steady / N * 1e3:.0f} ms/frame)", flush=True)


if __name__ == "__main__":
    main()
