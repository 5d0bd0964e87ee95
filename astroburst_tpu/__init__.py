"""astroburst_tpu — accelerator-native astronomical image processing.

A ground-up JAX/XLA rebuild of the capabilities of AstroBurst
(reference: samuelkriegerbonini-dev/AstroBurst, a Rust/Tauri desktop app):
FITS/ASDF ingestion, robust statistics, calibration, sigma-clipped
stacking, drizzle, phase-correlation and star-based affine alignment,
narrowband channel compositing, STF/arcsinh/masked stretching, tone
curves, SCNR, star detection, PSF estimation, Richardson-Lucy
deconvolution, wavelet denoising, background extraction, WCS/plate
solving, SPCC color calibration, IFU cube spectroscopy and synthetic
data generation.

Everything pixel-shaped runs on the GPU via jit-compiled JAX; the public
command surface lives in :mod:`astroburst_tpu.api` and mirrors the
reference's 60 IPC commands (reference: src-tauri/src/lib.rs:116-177).
"""

__version__ = "0.1.0"

from astroburst_tpu import constants  # noqa: F401
