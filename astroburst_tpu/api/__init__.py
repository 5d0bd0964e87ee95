"""Public command surface.

One function per reference IPC command, same names, same response keys
(reference: src-tauri/src/lib.rs:116-177 registers 60 commands across
src-tauri/src/cmd/). Returns plain dicts; binary responses return
bytes. Commands are synchronous — batch/async orchestration is the
caller's concern (the reference's spawn_blocking analog).

Importing the api turns on the persistent compilation cache
(runtime/compile_cache.py), so a second process reuses the first one's
compiled programs.
"""

from astroburst_tpu.runtime.compile_cache import enable_compile_cache

enable_compile_cache()

from astroburst_tpu.api.io import (process_fits, process_fits_full,
                                   get_raw_pixels_preview)
from astroburst_tpu.api.export import (export_fits, export_fits_rgb,
                                       export_png, export_rgb_png,
                                       export_zip_bundle)
from astroburst_tpu.api.compose import (
    compose_rgb_cmd, restretch_composite_cmd, clear_composite_cache_cmd,
    update_composite_channel_cmd, blend_channels_cmd, align_channels_cmd,
    crop_channels_cmd, export_aligned_channels_cmd, calibrate_and_scnr_cmd,
    compute_auto_wb_cmd, reset_wb_cmd)
from astroburst_tpu.api.metadata import (get_header, get_full_header,
                                         get_fits_extensions,
                                         get_header_by_hdu,
                                         detect_narrowband_filters)
from astroburst_tpu.api.analysis import (compute_histogram_cmd,
                                         compute_fft_spectrum, detect_stars,
                                         detect_stars_composite,
                                         analyze_subframes_cmd)
from astroburst_tpu.api.visualization import (apply_stf_render,
                                              generate_tiles,
                                              generate_tiles_rgb)
from astroburst_tpu.api.stacking import (calibrate, stack, run_pipeline_cmd,
                                         drizzle_stack_cmd)
from astroburst_tpu.api.processing import (
    resample_fits_cmd, deconvolve_rl_cmd, extract_background_cmd,
    wavelet_denoise_cmd, apply_arcsinh_stretch_cmd, masked_stretch_cmd,
    arcsinh_stretch_composite_cmd, masked_stretch_composite_cmd,
    apply_tone_composite_cmd)
from astroburst_tpu.api.cube import (process_cube_cmd, process_cube_lazy_cmd,
                                     get_cube_info, get_cube_frame,
                                     get_cube_spectrum)
from astroburst_tpu.api.astrometry import plate_solve_cmd, get_wcs_info
from astroburst_tpu.api.psf import estimate_psf_cmd
from astroburst_tpu.api.spcc import spcc_calibrate_cmd
from astroburst_tpu.api.config import (get_config, update_config,
                                       save_api_key, get_api_key)
from astroburst_tpu.api.synth import (generate_synth_cmd,
                                      generate_synth_stack_cmd)
from astroburst_tpu.api.output import get_output_dir_info, cleanup_output_cmd

# alias matching the reference's registered name
compute_histogram = compute_histogram_cmd

__all__ = [
    # io
    "process_fits", "process_fits_full", "get_raw_pixels_preview",
    # export
    "export_fits", "export_fits_rgb", "export_png", "export_rgb_png",
    "export_zip_bundle",
    # compose
    "compose_rgb_cmd", "restretch_composite_cmd",
    "clear_composite_cache_cmd", "update_composite_channel_cmd",
    "blend_channels_cmd", "align_channels_cmd", "crop_channels_cmd",
    "export_aligned_channels_cmd", "calibrate_and_scnr_cmd",
    "compute_auto_wb_cmd", "reset_wb_cmd",
    # metadata
    "get_header", "get_full_header", "get_fits_extensions",
    "get_header_by_hdu", "detect_narrowband_filters",
    # analysis
    "compute_histogram", "compute_histogram_cmd", "compute_fft_spectrum",
    "detect_stars", "detect_stars_composite", "analyze_subframes_cmd",
    # visualization
    "apply_stf_render", "generate_tiles", "generate_tiles_rgb",
    # stacking
    "calibrate", "stack", "run_pipeline_cmd", "drizzle_stack_cmd",
    # processing
    "resample_fits_cmd", "deconvolve_rl_cmd", "extract_background_cmd",
    "wavelet_denoise_cmd", "apply_arcsinh_stretch_cmd",
    "masked_stretch_cmd", "arcsinh_stretch_composite_cmd",
    "masked_stretch_composite_cmd", "apply_tone_composite_cmd",
    # cube
    "process_cube_cmd", "process_cube_lazy_cmd", "get_cube_info",
    "get_cube_frame", "get_cube_spectrum",
    # astrometry
    "plate_solve_cmd", "get_wcs_info",
    # psf / spcc
    "estimate_psf_cmd", "spcc_calibrate_cmd",
    # config
    "get_config", "update_config", "save_api_key", "get_api_key",
    # synth
    "generate_synth_cmd", "generate_synth_stack_cmd",
    # output
    "get_output_dir_info", "cleanup_output_cmd",
]
