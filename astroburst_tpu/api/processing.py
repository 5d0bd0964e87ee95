"""Processing commands (reference: src-tauri/src/cmd/processing/)."""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np

from astroburst_tpu import constants as C
from astroburst_tpu.api import helpers
from astroburst_tpu.api.common import (MAX_PREVIEW_DIM, Timer,
                                       load_cached, png_path_for)
from astroburst_tpu.analysis.deconvolution import (generate_gaussian_psf,
                                                   richardson_lucy)
from astroburst_tpu.dtypes import RLConfig, ScnrConfig, StfParams
from astroburst_tpu.errors import CacheMiss, InvalidInput
from astroburst_tpu.imaging.background import (BackgroundConfig,
                                               extract_background)
from astroburst_tpu.imaging.curves import (LevelsParams, SplineCurve,
                                           apply_curve_rgb, apply_levels_rgb,
                                           is_identity_curve)
from astroburst_tpu.imaging.masked_stretch import (MaskedStretchConfig,
                                                   masked_stretch,
                                                   masked_stretch_rgb_shared)
from astroburst_tpu.imaging.resample import resample_with_wcs
from astroburst_tpu.imaging.scnr import apply_scnr
from astroburst_tpu.imaging.stf import apply_stf_f32, auto_stf
from astroburst_tpu.imaging.stretch import (arcsinh_stretch_rgb,
                                            arcsinh_stretch_with_stats)
from astroburst_tpu.imaging.wavelet import WaveletConfig, wavelet_denoise
from astroburst_tpu.io import write_fits_mono
from astroburst_tpu.ops.stats import compute_image_stats
from astroburst_tpu.runtime.output import resolve_output_dir
from astroburst_tpu.runtime.progress import ProgressHandle


def _auto_preview(image, path: str) -> None:
    stats = compute_image_stats(image)
    helpers.save_stf_preview_png(image, auto_stf(stats), stats, path,
                                 MAX_PREVIEW_DIM)


def resample_fits_cmd(path: str, output_dir: str, target_width: int,
                      target_height: int) -> dict:
    """cmd/processing/resample.rs:12 — bicubic resize + WCS rescale."""
    from astroburst_tpu.io.header import HduHeader
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path)
    result = resample_with_wcs(entry.image, entry.header or HduHeader(),
                               target_height, target_width)
    header = entry.header.copy() if entry.header else None
    if header is not None:
        for k, v in result.header_updates:
            if k not in ("NAXIS1", "NAXIS2"):
                header.set_f64(k, v)
    stem = os.path.splitext(os.path.basename(path))[0]
    fits_path = os.path.join(out_dir, f"{stem}_{C.RESAMPLED}.fits")
    write_fits_mono(fits_path, np.asarray(result.image), header)
    png_path = png_path_for(path, out_dir, C.RESAMPLED)
    _auto_preview(result.image, png_path)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_ORIGINAL_DIMENSIONS: list(result.original_dims[::-1]),
        C.RES_DIMENSIONS: [target_width, target_height],
        C.RES_WCS_UPDATES: {k: v for k, v in result.header_updates},
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def deconvolve_rl_cmd(path: str, output_dir: str,
                      iterations: Optional[int] = None,
                      psf_sigma: Optional[float] = None,
                      kernel_size: Optional[int] = None,
                      regularization: Optional[float] = None,
                      dering: Optional[bool] = None,
                      dering_threshold: Optional[float] = None,
                      use_estimated_psf: Optional[bool] = None,
                      fast_precision: Optional[bool] = None) -> dict:
    """cmd/processing/deconvolution.rs:15 — RL with progress events.
    ``fast_precision`` is an extension (reduced-precision tensor-core
    FFT matmuls, see ops.fft); the default matches the reference's
    true-f32 arithmetic."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path)
    config = RLConfig(
        iterations=iterations if iterations is not None else 20,
        psf_sigma=psf_sigma if psf_sigma is not None else 2.0,
        regularization=regularization or 0.0,
        dering=dering if dering is not None else True,
        dering_threshold=(dering_threshold if dering_threshold is not None
                          else 0.1),
        fast_precision=bool(fast_precision))
    if use_estimated_psf:
        from astroburst_tpu.imaging.psf_estimation import (estimate_psf,
                                                           psf_to_kernel)
        psf = psf_to_kernel(estimate_psf(entry.image))
    else:
        size = kernel_size if kernel_size is not None else 15
        psf = generate_gaussian_psf(size, config.psf_sigma)
    progress = ProgressHandle(C.EVENT_DECONV_PROGRESS,
                              total=config.iterations)
    result = richardson_lucy(entry.image, psf, config, progress)
    stem = os.path.splitext(os.path.basename(path))[0]
    fits_path = os.path.join(out_dir, f"{stem}_{C.SUFFIX_DECONV}.fits")
    write_fits_mono(fits_path, np.asarray(result.image), entry.header)
    png_path = png_path_for(path, out_dir, C.SUFFIX_DECONV)
    _auto_preview(result.image, png_path)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_ITERATIONS_RUN: result.iterations_run,
        C.RES_CONVERGENCE: result.convergence,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def extract_background_cmd(path: str, output_dir: str,
                           grid_size: Optional[int] = None,
                           poly_degree: Optional[int] = None,
                           sigma_clip: Optional[float] = None,
                           iterations: Optional[int] = None,
                           mode: Optional[str] = None) -> dict:
    """cmd/processing/background.rs:18."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path)
    config = BackgroundConfig(
        grid_size=grid_size if grid_size is not None else 8,
        poly_degree=poly_degree if poly_degree is not None else 3,
        sigma_clip=sigma_clip if sigma_clip is not None else 2.5,
        iterations=iterations if iterations is not None else 3,
        mode=mode or "subtract")
    progress = ProgressHandle(C.PROGRESS_EVENT, total=C.PROGRESS_STEPS)
    result = extract_background(entry.image, config, progress)
    stem = os.path.splitext(os.path.basename(path))[0]
    corrected_fits = os.path.join(out_dir, f"{stem}_{C.DEFAULT_STEM}.fits")
    write_fits_mono(corrected_fits, np.asarray(result.corrected),
                    entry.header)
    corrected_png = png_path_for(path, out_dir, C.DEFAULT_STEM)
    _auto_preview(result.corrected, corrected_png)
    model_png = png_path_for(path, out_dir, "bg_model")
    _auto_preview(result.model, model_png)
    return {
        C.RES_CORRECTED_FITS: corrected_fits,
        C.RES_CORRECTED_PNG: corrected_png,
        C.RES_MODEL_PNG: model_png,
        C.RES_SAMPLE_COUNT: result.sample_count,
        C.RES_RMS_RESIDUAL: result.rms_residual,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def wavelet_denoise_cmd(path: str, output_dir: str,
                        num_scales: Optional[int] = None,
                        thresholds: Optional[Sequence[float]] = None,
                        linear_denoise: Optional[bool] = None) -> dict:
    """cmd/processing/wavelet.rs:13."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path)
    config = WaveletConfig(
        num_scales=num_scales if num_scales is not None else 5,
        thresholds=tuple(thresholds) if thresholds else
        (3.0, 2.5, 2.0, 1.5, 1.0),
        linear_denoise=linear_denoise if linear_denoise is not None else True)
    progress = ProgressHandle(C.EVENT_WAVELET_PROGRESS)
    result = wavelet_denoise(entry.image, config, progress)
    stem = os.path.splitext(os.path.basename(path))[0]
    fits_path = os.path.join(out_dir, f"{stem}_denoised.fits")
    write_fits_mono(fits_path, np.asarray(result.denoised), entry.header)
    png_path = png_path_for(path, out_dir, "denoised")
    _auto_preview(result.denoised, png_path)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_SCALES_PROCESSED: result.scales_processed,
        C.RES_NOISE_ESTIMATE: result.noise_estimate,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def apply_arcsinh_stretch_cmd(path: str, output_dir: str, factor: float,
                              gamma: Optional[float] = None) -> dict:
    """cmd/processing/stretch.rs:15."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path)
    clamped = min(max(float(factor), 1.0), 500.0)
    stretched = arcsinh_stretch_with_stats(
        entry.image, entry.stats.min, entry.stats.max, clamped,
        gamma if gamma is not None else 1.0)
    stem = os.path.splitext(os.path.basename(path))[0]
    fits_path = os.path.join(out_dir, f"{stem}_arcsinh.fits")
    write_fits_mono(fits_path, np.asarray(stretched), entry.header)
    png_path = png_path_for(path, out_dir, "arcsinh")
    _auto_preview(stretched, png_path)
    h, w = stretched.shape
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_STRETCH_FACTOR: clamped,
        C.RES_DIMENSIONS: [w, h],
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def _masked_stretch_config(iterations, target_background, mask_growth,
                           mask_softness, protection_amount,
                           luminance_protect) -> MaskedStretchConfig:
    return MaskedStretchConfig(
        iterations=iterations if iterations is not None else 10,
        target_background=(target_background if target_background is not None
                           else 0.25),
        mask_growth=mask_growth if mask_growth is not None else 2.5,
        mask_softness=mask_softness if mask_softness is not None else 4.0,
        protection_amount=(protection_amount if protection_amount is not None
                           else 0.85),
        luminance_protect=(luminance_protect if luminance_protect is not None
                           else True))


def masked_stretch_cmd(path: str, output_dir: str,
                       iterations: Optional[int] = None,
                       target_background: Optional[float] = None,
                       mask_growth: Optional[float] = None,
                       mask_softness: Optional[float] = None,
                       protection_amount: Optional[float] = None,
                       luminance_protect: Optional[bool] = None) -> dict:
    """cmd/processing/stretch.rs:46."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(path)
    config = _masked_stretch_config(iterations, target_background,
                                    mask_growth, mask_softness,
                                    protection_amount, luminance_protect)
    result = masked_stretch(entry.image, config)
    stem = os.path.splitext(os.path.basename(path))[0]
    fits_path = os.path.join(out_dir,
                             f"{stem}_{C.SUFFIX_MASKED_STRETCH}.fits")
    write_fits_mono(fits_path, np.asarray(result.image), entry.header)
    png_path = png_path_for(path, out_dir, C.SUFFIX_MASKED_STRETCH)
    _auto_preview(result.image, png_path)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_ITERATIONS_RUN: result.iterations_run,
        C.RES_FINAL_BACKGROUND: result.final_background,
        C.RES_STARS_MASKED: result.stars_masked,
        C.RES_MASK_COVERAGE: result.mask_coverage,
        C.RES_CONVERGED: result.converged,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def arcsinh_stretch_composite_cmd(output_dir: str, factor: float) -> dict:
    """cmd/processing/stretch.rs:94 — composite arcsinh (shared range)."""
    out_dir = resolve_output_dir(output_dir)
    er, eg, eb = helpers.load_composite_rgb()
    clamped = min(max(float(factor), 1.0), 500.0)
    t0 = Timer()
    r, g, b = arcsinh_stretch_rgb(er.image, eg.image, eb.image, clamped)
    png_path = os.path.join(out_dir,
                            f"composite_arcsinh_{int(time.time()*1000)}.png")
    helpers.render_rgb_preview(r, g, b, png_path, MAX_PREVIEW_DIM)
    h, w = np.asarray(r).shape
    return {
        C.RES_PNG_PATH: png_path,
        C.RES_STRETCH_FACTOR: clamped,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
        C.RES_DIMENSIONS: [w, h],
    }


def masked_stretch_composite_cmd(output_dir: str,
                                 iterations: Optional[int] = None,
                                 target_background: Optional[float] = None,
                                 mask_growth: Optional[float] = None,
                                 mask_softness: Optional[float] = None,
                                 protection_amount: Optional[float] = None,
                                 luminance_protect: Optional[bool] = None,
                                 shared_mask: Optional[bool] = None) -> dict:
    """cmd/processing/stretch.rs masked composite path."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    er, eg, eb = helpers.load_composite_rgb()
    config = _masked_stretch_config(iterations, target_background,
                                    mask_growth, mask_softness,
                                    protection_amount, luminance_protect)

    def ch_json(res):
        return {C.RES_ITERATIONS_RUN: res.iterations_run,
                C.RES_FINAL_BACKGROUND: res.final_background,
                C.RES_CONVERGED: res.converged}

    if shared_mask:
        result = masked_stretch_rgb_shared(er.image, eg.image, eb.image,
                                           config)
        r_img = result["r"].image
        g_img = result["g"].image
        b_img = result["b"].image
        per_channel = {"r": ch_json(result["r"]), "g": ch_json(result["g"]),
                       "b": ch_json(result["b"])}
        stars = result["shared_stars_masked"]
        coverage = result["shared_mask_coverage"]
        mask_mode = "shared_luminance"
    else:
        rr = masked_stretch(er.image, config)
        gg = masked_stretch(eg.image, config)
        bb = masked_stretch(eb.image, config)
        r_img, g_img, b_img = rr.image, gg.image, bb.image
        per_channel = {"r": ch_json(rr), "g": ch_json(gg), "b": ch_json(bb)}
        stars = rr.stars_masked + gg.stars_masked + bb.stars_masked
        coverage = (rr.mask_coverage + gg.mask_coverage +
                    bb.mask_coverage) / 3.0
        mask_mode = "per_channel"

    png_path = os.path.join(
        out_dir, f"composite_masked_{int(time.time()*1000)}.png")
    helpers.render_rgb_preview(r_img, g_img, b_img, png_path,
                               MAX_PREVIEW_DIM)
    return {
        C.RES_PNG_PATH: png_path,
        C.RES_STARS_MASKED: stars,
        C.RES_MASK_COVERAGE: coverage,
        "mask_mode": mask_mode,
        C.CHANNELS: per_channel,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def apply_tone_composite_cmd(output_dir: str,
                             stf_r: Optional[Sequence[float]] = None,
                             stf_g: Optional[Sequence[float]] = None,
                             stf_b: Optional[Sequence[float]] = None,
                             linked_stf: Optional[bool] = None,
                             levels_r: Optional[dict] = None,
                             levels_g: Optional[dict] = None,
                             levels_b: Optional[dict] = None,
                             curves_r: Optional[dict] = None,
                             curves_g: Optional[dict] = None,
                             curves_b: Optional[dict] = None,
                             scnr: Optional[dict] = None) -> dict:
    """cmd/processing/curves.rs:58 — KEY → STF → levels → curves →
    optional SCNR → preview (non-destructive)."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    src_r, src_g, src_b = helpers.load_composite_rgb()
    rows, cols = src_r.image.shape

    linked = bool(linked_stf)
    if linked:
        p, combined = helpers.compute_linked_stf_with_stats(
            src_r.stats, src_g.stats, src_b.stats)
        auto_params = (p, p, p)
        norms = (combined, combined, combined)
    else:
        auto_params = (auto_stf(src_r.stats), auto_stf(src_g.stats),
                       auto_stf(src_b.stats))
        norms = (src_r.stats, src_g.stats, src_b.stats)

    def stf_of(arr, auto_p):
        if arr is None:
            return auto_p
        return StfParams(shadow=arr[0], midtone=arr[1], highlight=arr[2])

    params = [stf_of(stf_r, auto_params[0]), stf_of(stf_g, auto_params[1]),
              stf_of(stf_b, auto_params[2])]
    planes = [apply_stf_f32(e.image, p, n) for e, p, n in
              zip((src_r, src_g, src_b), params, norms)]

    def levels_of(d):
        if not d:
            return LevelsParams()
        return LevelsParams(black=float(d.get("black", 0.0)),
                            gamma=float(d.get("gamma", 1.0)),
                            white=float(d.get("white", 1.0)))

    lv = [levels_of(levels_r), levels_of(levels_g), levels_of(levels_b)]
    levels_applied = not all(l.is_identity() for l in lv)
    if levels_applied:
        planes = list(apply_levels_rgb(*planes, *lv))

    def points_of(d):
        if not d:
            return []
        return [tuple(p) for p in d.get("points", [])]

    curve_pts = [points_of(curves_r), points_of(curves_g),
                 points_of(curves_b)]
    curves_applied = not all(is_identity_curve(p) for p in curve_pts)
    if curves_applied:
        curves = [SplineCurve(p if p else [(0.0, 0.0), (1.0, 1.0)])
                  for p in curve_pts]
        planes = list(apply_curve_rgb(*planes, *curves))

    scnr_applied = False
    if scnr is not None:
        cfg = helpers.parse_scnr_config(True, scnr.get("method"),
                                        scnr.get("amount"),
                                        scnr.get("preserveLuminance"))
        if cfg is not None:
            planes = list(apply_scnr(*planes, cfg))
            scnr_applied = True

    png_path = os.path.join(out_dir,
                            f"composite_tone_{int(time.time()*1000)}.png")
    helpers.render_rgb_preview(planes[0], planes[1], planes[2], png_path,
                               MAX_PREVIEW_DIM)
    return {
        C.RES_PNG_PATH: png_path,
        C.RES_COMPOSITE_DIMS: [cols, rows],
        C.RES_STF_APPLIED: True,
        C.RES_LEVELS_APPLIED: levels_applied,
        C.RES_CURVES_APPLIED: curves_applied,
        C.RES_SCNR_APPLIED: scnr_applied,
        C.RES_STF: params[0].to_dict(),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
