"""Richardson-Lucy deconvolution.

Reference: src-tauri/src/core/analysis/deconvolution.rs — PSF and
conjugate-PSF spectra precomputed once with center-origin wraparound
(deconvolution.rs:44-80); iterate convolve → ratio → correlate →
multiply with Tikhonov 1/(1+λ) damping; bidirectional deringing clamp;
L2 convergence early-exit (< 1e-6 after ≥ 3 iterations).

Design: matmul-FFT convolver (ops.fft); the data-dependent
early exit becomes a traced `stopped` flag over a fixed iteration
count — the estimate freezes once converged, so outputs match.
Cancellation is checked before the (single-program) launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.dtypes import RLConfig
from astroburst_tpu.ops import fft as F
from astroburst_tpu.runtime.progress import ProgressHandle

CONVERGENCE_THRESHOLD = 1e-6
EPSILON = 1e-6


def generate_gaussian_psf(size: int, sigma: float) -> np.ndarray:
    """Normalized Gaussian kernel (deconvolution.rs:12-33)."""
    center = (size - 1) / 2.0
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    val = np.exp(-(((x - center) ** 2 + (y - center) ** 2) /
                   (2.0 * sigma * sigma)))
    s = val.sum()
    if s > 0:
        val /= s
    return val.astype(np.float32)


@partial(jax.jit, static_argnames=("fft_rows", "fft_cols", "fast"))
def _psf_spectrum(psf, fft_rows: int, fft_cols: int, fast: bool = False):
    """Wraparound center-origin placement + half-spectrum FFT
    (deconvolution.rs:62-80).

    Only the small PSF crosses to the device; the padded buffer is
    built there (update-slice + roll) instead of uploading a
    (fft_rows, fft_cols) host buffer of zeros per call.

    Returns the rfft2 half spectrum [fft_rows, fft_cols//2 + 1]: the
    RL iteration is real-in/real-out end to end, so the redundant
    conjugate half is never materialized (~2× on the FFT matmuls)."""
    psf = jnp.asarray(psf, jnp.float32)
    pr, pc = psf.shape
    cy, cx = pr // 2, pc // 2
    buf = jnp.zeros((fft_rows, fft_cols), jnp.float32)
    buf = jax.lax.dynamic_update_slice(buf, psf, (0, 0))
    buf = jnp.roll(buf, (-cy, -cx), axis=(0, 1))
    with F.matmul_precision("default" if fast else "highest"):
        return F.rfft2(buf)


@dataclass
class RLResult:
    image: jax.Array
    iterations_run: int
    convergence: float


@partial(jax.jit, static_argnames=("fft_cols", "iterations", "deringing",
                                   "fast"))
def _rl_kernel(image, psf_r, psf_i, lam, dering_threshold,
               fft_cols: int, iterations: int, deringing: bool,
               fast: bool = False):
    # `fast` keys the jit cache: the FFT matmul precision is a
    # trace-time switch (ops/fft.py matmul_precision), so each flag
    # value must trace separately
    rows, cols = image.shape
    fft_rows = psf_r.shape[0]
    psf_conj_i = -psf_i

    def convolve(x, kr, ki):
        # real-packed convolution: half-spectrum forward, pointwise on
        # C/2+1 columns, half-packed real inverse (ops/fft.py rfft2)
        buf = jnp.pad(x, ((0, fft_rows - rows), (0, fft_cols - cols)))
        with F.matmul_precision("default" if fast else "highest"):
            xr, xi = F.rfft2(buf)
            pr = xr * kr - xi * ki
            pi = xr * ki + xi * kr
            out = F.irfft2(pr, pi, fft_cols)
        return out[:rows, :cols]

    inv_reg = jnp.where(lam > 0.0, 1.0 / (1.0 + lam), 1.0)
    estimate = image
    stopped = jnp.bool_(False)
    iterations_run = jnp.int32(0)
    convergence = jnp.float32(np.finfo(np.float32).max)

    for it in range(iterations):
        convolved = convolve(estimate, psf_r, psf_i)
        ratio = image / (convolved + EPSILON)
        correction = convolve(ratio, psf_r, psf_conj_i)
        new_est = jnp.maximum(estimate * correction * inv_reg, 0.0)
        if deringing:
            upper = image * (1.0 + dering_threshold)
            lower = jnp.maximum(image * (1.0 - dering_threshold), 0.0)
            new_est = jnp.clip(new_est, lower, upper)
        delta = jnp.sqrt(jnp.mean((new_est - estimate) ** 2))
        active = ~stopped
        estimate = jnp.where(active, new_est, estimate)
        iterations_run = jnp.where(active, it + 1, iterations_run)
        convergence = jnp.where(active, delta, convergence)
        stopped = stopped | (active & (delta < CONVERGENCE_THRESHOLD) &
                             jnp.bool_(it + 1 >= 3))
    return estimate, iterations_run, convergence


def richardson_lucy(image, psf, config: RLConfig = RLConfig(),
                    progress: Optional[ProgressHandle] = None) -> RLResult:
    img = jnp.asarray(image, jnp.float32)
    psf_np = np.asarray(psf, np.float32)
    rows, cols = img.shape
    # smallest engine-fast size with exact linear convolution — the
    # reference's next_power_of_two (deconvolution.rs:47, fft.rs:64)
    # wastes ~4× the FFT work at 2048²+small-PSF (4096 vs 2176)
    fft_rows = F.next_fast_size(rows + psf_np.shape[0] - 1)
    fft_cols = F.next_fast_size(cols + psf_np.shape[1] - 1)
    psf_r, psf_i = _psf_spectrum(psf_np, fft_rows, fft_cols,
                                 fast=config.fast_precision)

    if progress is not None:
        progress.check_cancelled()
        progress.tick_with_stage("deconvolving")
    est, iters, conv = _rl_kernel(
        img, psf_r, psf_i, jnp.float32(config.regularization),
        jnp.float32(config.dering_threshold), fft_cols,
        config.iterations, config.dering, fast=config.fast_precision)
    if progress is not None:
        progress.tick_with_stage(f"done ({int(iters)} iterations)")
    return RLResult(image=est, iterations_run=int(iters),
                    convergence=float(conv))
