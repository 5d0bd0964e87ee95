"""CCD noise model and flat fields.

Reference: src-tauri/src/core/synth/noise.rs — Poisson shot noise on
(signal + sky)·gain·t + dark·t electrons, Gaussian read noise, bias
pedestal, gain division; vignetted flat field with 1% pixel noise.

Design: jax.random (threefry) replaces the reference's StdRng —
distributions match, exact random sequences don't (documented).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp


@dataclass
class NoiseParams:
    gain: float = 1.5
    readout_noise: float = 8.0
    sky_background: float = 200.0
    dark_current: float = 0.05
    exposure_time: float = 300.0
    bias_level: float = 1000.0
    seed: int = 123


@jax.jit
def _noise_kernel(image, gain, readout_noise, sky, dark, t, bias, key):
    signal_e = jnp.maximum((image + sky) * gain * t + dark * t, 0.0)
    k1, k2 = jax.random.split(key)
    photon_e = jax.random.poisson(k1, signal_e).astype(jnp.float32)
    read_e = jax.random.normal(k2, image.shape) * readout_noise
    return jnp.maximum((photon_e + read_e + bias) / gain, 0.0)


def apply_noise(image, params: NoiseParams = NoiseParams()) -> jax.Array:
    key = jax.random.PRNGKey(params.seed)
    return _noise_kernel(jnp.asarray(image, jnp.float32),
                         jnp.float32(params.gain),
                         jnp.float32(params.readout_noise),
                         jnp.float32(params.sky_background),
                         jnp.float32(params.dark_current),
                         jnp.float32(params.exposure_time),
                         jnp.float32(params.bias_level), key)


@partial(jax.jit, static_argnames=("width", "height"))
def _flat_kernel(key, width: int, height: int, vignette_strength):
    cx, cy = width * 0.5, height * 0.5
    max_r = jnp.sqrt(cx * cx + cy * cy)
    yy = jnp.arange(height, dtype=jnp.float32)[:, None]
    xx = jnp.arange(width, dtype=jnp.float32)[None, :]
    r = jnp.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) / max_r
    pix_noise = 1.0 + jax.random.uniform(key, (height, width)) * 0.02 - 0.01
    return jnp.maximum((1.0 - vignette_strength * r * r) * pix_noise, 0.01)


def generate_flat_field(width: int, height: int, seed: int,
                        vignette_strength: float) -> jax.Array:
    return _flat_kernel(jax.random.PRNGKey(seed), width, height,
                        jnp.float32(vignette_strength))


@jax.jit
def apply_flat_field(image, flat) -> jax.Array:
    ok = flat > 1e-6
    return jnp.where(ok, image / jnp.where(ok, flat, 1.0), image)
