"""Empirical PSF estimation.

Reference: src-tauri/src/core/imaging/psf_estimation.rs — detect
candidates, quality-filter (saturation / min-peak / ellipticity /
edge-margin / center-distance), score-rank, take top-N; extract
cutouts → subpixel re-center (bilinear) → normalize → average into an
empirical kernel; moment FWHM/ellipticity per star; spread radius.

Design: detection reuses analysis.star_detection; cutout
extraction/recentering/averaging is one vmapped kernel over the
selected ≤N stars.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from astroburst_tpu.analysis.star_detection import detect_stars
from astroburst_tpu.errors import InvalidInput
from astroburst_tpu.ops.stats import compute_image_stats


@dataclass
class PsfEstimationConfig:
    num_stars: int = 30
    cutout_radius: int = 15
    saturation_threshold: float = 0.95
    min_peak_fraction: float = 0.10
    max_ellipticity: float = 0.3
    edge_margin: int = 30
    max_center_distance_fraction: float = 0.7
    detection_sigma: float = 5.0


@dataclass
class StarCandidate:
    x: float
    y: float
    peak: float
    flux: float
    fwhm: float
    ellipticity: float
    distance_from_center: float
    snr: float

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class PsfResult:
    kernel: np.ndarray          # [size, size] f32, sums to 1
    kernel_size: int
    average_fwhm: float
    average_ellipticity: float
    stars_used: List[StarCandidate]
    stars_rejected: int
    spread_pixels: float


def score_star(s: StarCandidate) -> float:
    """Quality score (psf_estimation.rs:509-516)."""
    roundness = 1.0 - s.ellipticity
    snr_score = min(s.snr / 100.0, 1.0)
    center_score = 1.0 / (1.0 + s.distance_from_center / 500.0)
    fwhm_consistency = 1.0 / (1.0 + abs(s.fwhm - 4.0) / 4.0)
    return (roundness * 0.35 + snr_score * 0.30 + center_score * 0.15 +
            fwhm_consistency * 0.20)


@partial(jax.jit, static_argnames=("radius",))
def _cutout_average_kernel(image, xs, ys, valid, radius: int):
    """Extract, bilinear-recenter, normalize and average cutouts."""
    size = radius * 2 + 1

    def one(x, y, ok):
        ix = jnp.round(x).astype(jnp.int32)
        iy = jnp.round(y).astype(jnp.int32)
        y0 = jnp.clip(iy - radius, 0, image.shape[0] - size)
        x0 = jnp.clip(ix - radius, 0, image.shape[1] - size)
        cut = jax.lax.dynamic_slice(image, (y0, x0), (size, size))
        cut = jnp.where(jnp.isfinite(cut), cut, 0.0)
        # weighted centroid → bilinear shift to geometric center
        yy = jnp.arange(size, dtype=jnp.float32)[:, None]
        xx = jnp.arange(size, dtype=jnp.float32)[None, :]
        w = jnp.maximum(jnp.sum(cut), 1e-30)
        cy = jnp.sum(yy * cut) / w
        cx = jnp.sum(xx * cut) / w
        target = (size - 1) / 2.0
        dy = cy - target  # sample at center + offset
        dx = cx - target
        ky = jnp.floor(dy).astype(jnp.int32)
        kx = jnp.floor(dx).astype(jnp.int32)
        fy = dy - ky
        fx = dx - kx

        def take(img, shift, off, axis):
            idx = jnp.clip(jnp.arange(size) + shift + off, 0, size - 1)
            return jnp.take(img, idx, axis=axis)

        t0 = take(cut, ky, 0, 0) * (1 - fy) + take(cut, ky, 1, 0) * fy
        shifted = take(t0, kx, 0, 1) * (1 - fx) + take(t0, kx, 1, 1) * fx
        s = jnp.sum(shifted)
        normalized = jnp.where(s > 0, shifted / jnp.maximum(s, 1e-30),
                               shifted)
        return jnp.where(ok, normalized, jnp.zeros((size, size), jnp.float32))

    cutouts = jax.vmap(one)(xs, ys, valid)
    count = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
    avg = jnp.sum(cutouts, axis=0) / count
    total = jnp.sum(avg)
    psf = jnp.where(total > 0, avg / jnp.maximum(total, 1e-30), avg)
    # spread radius (psf_estimation.rs:621+)
    yy = jnp.arange(size, dtype=jnp.float32)[:, None] - (size - 1) / 2.0
    xx = jnp.arange(size, dtype=jnp.float32)[None, :] - (size - 1) / 2.0
    wsum = jnp.maximum(jnp.sum(psf), 1e-30)
    spread = jnp.sqrt(jnp.sum((yy * yy + xx * xx) * psf) / wsum)
    return psf, spread


def estimate_psf(image, config: PsfEstimationConfig = PsfEstimationConfig()
                 ) -> PsfResult:
    img = jnp.asarray(image, jnp.float32)
    h, w = img.shape
    cx, cy = w / 2.0, h / 2.0
    max_dist = float(np.hypot(cx, cy)) * config.max_center_distance_fraction

    stats = compute_image_stats(img)
    det = detect_stars(img, config.detection_sigma)
    if not det.stars:
        raise InvalidInput("No stars detected in image")

    candidates: List[StarCandidate] = []
    for s in det.stars:
        dist = float(np.hypot(s.x - cx, s.y - cy))
        cand = StarCandidate(x=s.x, y=s.y, peak=s.peak, flux=s.flux,
                             fwhm=s.fwhm, ellipticity=s.eccentricity,
                             distance_from_center=dist, snr=s.snr)
        norm_peak = s.peak / max(stats.max, 1e-30)
        in_bounds = (config.edge_margin <= s.x < w - config.edge_margin and
                     config.edge_margin <= s.y < h - config.edge_margin)
        if (in_bounds and norm_peak < config.saturation_threshold and
                norm_peak > config.min_peak_fraction and
                cand.ellipticity < config.max_ellipticity and
                dist < max_dist):
            candidates.append(cand)

    if not candidates:
        raise InvalidInput("No stars passed quality filters")

    candidates.sort(key=score_star, reverse=True)
    selected = candidates[:config.num_stars]

    n = len(selected)
    xs = jnp.asarray([s.x for s in selected], jnp.float32)
    ys = jnp.asarray([s.y for s in selected], jnp.float32)
    valid = jnp.ones(n, bool)
    psf, spread = _cutout_average_kernel(img, xs, ys, valid,
                                         config.cutout_radius)
    size = config.cutout_radius * 2 + 1
    return PsfResult(
        kernel=np.asarray(psf, np.float32),
        kernel_size=size,
        average_fwhm=float(np.mean([s.fwhm for s in selected])),
        average_ellipticity=float(np.mean([s.ellipticity for s in selected])),
        stars_used=selected,
        stars_rejected=len(candidates) - n,
        spread_pixels=float(spread))


def psf_to_kernel(psf: PsfResult) -> np.ndarray:
    """Normalized kernel array for deconvolution (psf_estimation.rs:136)."""
    k = np.asarray(psf.kernel, np.float32)
    s = k.sum()
    return k / s if s > 0 else k
