"""Stacking commands (reference: src-tauri/src/cmd/stacking/)."""

from __future__ import annotations

import base64
import os
from typing import Dict, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from astroburst_tpu import constants as C
from astroburst_tpu.api import helpers
from astroburst_tpu.api.common import (MAX_PREVIEW_DIM, Timer, load_cached,
                                       load_cached_many,
                                       png_path_for)
from astroburst_tpu.dtypes import (AlignmentMethod, DrizzleConfig,
                                   DrizzleKernel, StackConfig)
from astroburst_tpu.errors import InvalidInput
from astroburst_tpu.imaging.calibration_pipeline import (BatchStackConfig,
                                                         ChannelInput,
                                                         run_batch_pipeline)
from astroburst_tpu.imaging.stf import apply_stf_u8, auto_stf
from astroburst_tpu.io import resolve_inputs, write_fits_mono
from astroburst_tpu.ops.stats import compute_image_stats
from astroburst_tpu.runtime.cache import GLOBAL_IMAGE_CACHE
from astroburst_tpu.runtime.output import resolve_output_dir
from astroburst_tpu.runtime.progress import ProgressHandle
from astroburst_tpu.stacking.calibration import (CalibrationConfig,
                                                 calibrate_image,
                                                 create_master_bias,
                                                 create_master_dark,
                                                 create_master_flat)
from astroburst_tpu.stacking.combine import stack_images
from astroburst_tpu.stacking.drizzle import drizzle_stack


def _save_preview(image, path: str, stats=None) -> None:
    stats = stats or compute_image_stats(image)
    helpers.save_stf_preview_png(image, auto_stf(stats), stats, path,
                                 MAX_PREVIEW_DIM)


def _masters_from_paths(bias_paths, dark_paths, flat_paths
                        ) -> CalibrationConfig:
    bias = create_master_bias(bias_paths) if bias_paths else None
    dark = create_master_dark(dark_paths, bias) if dark_paths else None
    flat = create_master_flat(flat_paths, bias, dark) if flat_paths else None
    return CalibrationConfig(master_bias=bias, master_dark=dark,
                             master_flat=flat)


def calibrate(light_path: str, output_dir: str = "",
              bias_paths: Optional[Sequence[str]] = None,
              dark_paths: Optional[Sequence[str]] = None,
              flat_paths: Optional[Sequence[str]] = None,
              dark_exposure_ratio: float = 1.0) -> dict:
    """cmd/stacking/combine.rs:17 — calibrate one light frame."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    entry = load_cached(light_path)
    masters = _masters_from_paths(bias_paths, dark_paths, flat_paths)
    masters.dark_exposure_ratio = dark_exposure_ratio
    calibrated = calibrate_image(entry.image, masters)
    stats = compute_image_stats(calibrated)

    stem = os.path.splitext(os.path.basename(light_path))[0]
    fits_path = os.path.join(out_dir, f"{stem}_calibrated.fits")
    write_fits_mono(fits_path, np.asarray(calibrated), entry.header)
    png_path = png_path_for(light_path, out_dir, "calibrated")
    _save_preview(calibrated, png_path, stats)
    h, w = calibrated.shape
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_DIMENSIONS: [w, h],
        C.RES_HAS_BIAS: masters.master_bias is not None,
        C.RES_HAS_DARK: masters.master_dark is not None,
        C.RES_HAS_FLAT: masters.master_flat is not None,
        C.RES_STATS: helpers.stats_json_full(stats),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def stack(paths: Sequence[str], output_dir: str = "",
          sigma_low: Optional[float] = None,
          sigma_high: Optional[float] = None,
          max_iterations: Optional[int] = None,
          align: Optional[bool] = None) -> dict:
    """cmd/stacking/combine.rs:77 — sigma-clip stack with alignment."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    if len(paths) == 1:
        paths = resolve_inputs(paths[0])
    if not paths:
        raise InvalidInput("No frames to stack")
    entries = load_cached_many(paths)
    config = StackConfig(
        sigma_low=sigma_low if sigma_low is not None else 3.0,
        sigma_high=sigma_high if sigma_high is not None else 3.0,
        max_iterations=max_iterations if max_iterations is not None else 5,
        align=align if align is not None else True)
    progress = ProgressHandle(C.EVENT_STACK_PROGRESS, total=len(paths) + 1)
    result = stack_images([e.image for e in entries], config, progress)
    stats = compute_image_stats(result.image)

    fits_path = os.path.join(out_dir, "stacked.fits")
    write_fits_mono(fits_path, np.asarray(result.image), entries[0].header)
    png_path = os.path.join(out_dir, "stacked.png")
    _save_preview(result.image, png_path, stats)
    h, w = result.image.shape
    GLOBAL_IMAGE_CACHE.insert(fits_path, result.image, stats=stats,
                              header=entries[0].header)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_DIMENSIONS: [w, h],
        C.RES_FRAME_COUNT: result.frame_count,
        C.RES_REJECTED_PIXELS: result.rejected_pixels,
        C.RES_OFFSETS: [[dy, dx] for dy, dx in result.offsets],
        C.RES_STATS: helpers.stats_json_full(stats),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }


def _png_b64(image, stats=None) -> str:
    from astroburst_tpu.io.png import encode_png
    from astroburst_tpu.ops.ipc import nearest_downsample
    stats = stats or compute_image_stats(image)
    u8 = np.asarray(nearest_downsample(
        apply_stf_u8(image, auto_stf(stats), stats), 1024))
    return base64.b64encode(encode_png(u8)).decode("ascii")


def run_pipeline_cmd(channels: Sequence[dict], output_dir: str = "",
                     bias_paths: Optional[Sequence[str]] = None,
                     dark_paths: Optional[Sequence[str]] = None,
                     flat_paths: Optional[Sequence[str]] = None,
                     sigma_low: float = 2.5, sigma_high: float = 3.0,
                     max_iterations: int = 5,
                     normalize_before_stack: bool = True) -> dict:
    """cmd/stacking/pipeline.rs:71 — masters → calibrate → stack →
    base64 previews. channels: [{label, lights: [paths]}]."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    masters = _masters_from_paths(bias_paths, dark_paths, flat_paths)
    inputs = []
    for ch in channels:
        lights = [e.image for e in load_cached_many(ch["lights"])]
        inputs.append(ChannelInput(label=ch.get("label", "L"),
                                   lights=lights))
    result = run_batch_pipeline(
        inputs, masters,
        BatchStackConfig(sigma_low=sigma_low, sigma_high=sigma_high,
                         max_iterations=max_iterations,
                         normalize_before_stack=normalize_before_stack))
    channel_out = []
    for label, master in result.master_channels:
        fits_path = os.path.join(out_dir, f"master_{label}.fits")
        write_fits_mono(fits_path, np.asarray(master))
        channel_out.append({
            C.RES_LABEL: label,
            C.RES_FITS_PATH: fits_path,
            "preview_b64": _png_b64(master),
        })
    out = {
        C.CHANNELS: channel_out,
        "stats": result.stats,
        C.RES_HAS_BIAS: masters.master_bias is not None,
        C.RES_HAS_DARK: masters.master_dark is not None,
        C.RES_HAS_FLAT: masters.master_flat is not None,
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
    if result.rgb is not None:
        rgb_path = os.path.join(out_dir, "pipeline_rgb.fits")
        from astroburst_tpu.io import write_fits_rgb
        rgb = np.asarray(result.rgb)
        write_fits_rgb(rgb_path, rgb[0], rgb[1], rgb[2])
        out["rgb_fits_path"] = rgb_path
    return out


def drizzle_stack_cmd(paths: Sequence[str], output_dir: str = "",
                      scale: Optional[float] = None,
                      pixfrac: Optional[float] = None,
                      kernel: Optional[str] = None,
                      sigma: Optional[float] = None,
                      sigma_iterations: Optional[int] = None,
                      align: Optional[bool] = None,
                      alignment_method: Optional[str] = None) -> dict:
    """cmd/stacking/drizzle.rs (present in the reference but not
    registered — kept for API completeness)."""
    t0 = Timer()
    out_dir = resolve_output_dir(output_dir)
    entries = load_cached_many(paths)
    config = DrizzleConfig(
        scale=scale if scale is not None else C.DEFAULT_DRIZZLE_SCALE,
        pixfrac=pixfrac if pixfrac is not None else C.DEFAULT_DRIZZLE_PIXFRAC,
        kernel=DrizzleKernel.parse(kernel),
        sigma_low=sigma if sigma is not None else C.DEFAULT_DRIZZLE_SIGMA,
        sigma_high=sigma if sigma is not None else C.DEFAULT_DRIZZLE_SIGMA,
        sigma_iterations=(sigma_iterations if sigma_iterations is not None
                          else C.DEFAULT_DRIZZLE_SIGMA_ITERS),
        align=align if align is not None else True,
        alignment_method=AlignmentMethod.parse(alignment_method))
    progress = ProgressHandle(C.EVENT_DRIZZLE_RGB_PROGRESS,
                              total=len(paths) + 1)
    result = drizzle_stack([e.image for e in entries], config, progress)
    stats = compute_image_stats(result.image)
    fits_path = os.path.join(out_dir, "drizzled.fits")
    write_fits_mono(fits_path, np.asarray(result.image), entries[0].header)
    png_path = os.path.join(out_dir, "drizzled.png")
    _save_preview(result.image, png_path, stats)
    return {
        C.RES_FITS_PATH: fits_path,
        C.RES_PNG_PATH: png_path,
        C.RES_INPUT_DIMS: list(result.input_dims[::-1]),
        C.RES_OUTPUT_DIMS: list(result.output_dims[::-1]),
        C.RES_SCALE: result.output_scale,
        C.RES_FRAME_COUNT: result.frame_count,
        C.RES_REJECTED_PIXELS: result.rejected_pixels,
        C.RES_OFFSETS: [[dx, dy] for dx, dy in result.offsets],
        C.RES_STATS: helpers.stats_json_full(stats),
        C.RES_ELAPSED_MS: t0.elapsed_ms(),
    }
