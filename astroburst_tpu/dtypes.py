"""Shared data types.

Python dataclass equivalents of the reference's shared types
(reference: src-tauri/src/types/{image,compose,stacking,config}.rs).
Scalar fields are host-side f64 (plain floats); pixel data lives in
device float32 arrays and is never stored in these records.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from astroburst_tpu import constants as C


def _asdict(obj):
    return dataclasses.asdict(obj)


# --- image statistics (types/image.rs:1-24) -------------------------------


@dataclass(frozen=True)
class ImageStats:
    min: float = 0.0
    max: float = 0.0
    median: float = 0.0
    mad: float = 0.0
    sigma: float = 0.0
    mean: float = 0.0
    valid_count: int = 0

    def to_dict(self) -> dict:
        return {
            C.RES_MIN: self.min,
            C.RES_MAX: self.max,
            C.RES_MEDIAN: self.median,
            C.RES_MAD: self.mad,
            C.RES_SIGMA: self.sigma,
            C.RES_MEAN: self.mean,
            "valid_count": self.valid_count,
        }


@dataclass(frozen=True)
class Histogram:
    """Value histogram (types/image.rs:26-32). bins are counts."""

    bins: List[int]
    bin_edges: List[float]
    min: float
    max: float

    def to_dict(self) -> dict:
        return {
            C.RES_BINS: list(self.bins),
            C.RES_BIN_EDGES: list(self.bin_edges),
            C.RES_MIN: self.min,
            C.RES_MAX: self.max,
        }


# --- STF (types/image.rs:34-64) --------------------------------------------


@dataclass(frozen=True)
class StfParams:
    shadow: float = 0.0
    midtone: float = 0.5
    highlight: float = 1.0

    def to_dict(self) -> dict:
        return {
            C.RES_SHADOW: self.shadow,
            C.RES_MIDTONE: self.midtone,
            C.RES_HIGHLIGHT: self.highlight,
        }

    @staticmethod
    def from_dict(d: dict) -> "StfParams":
        return StfParams(
            shadow=float(d.get(C.RES_SHADOW, 0.0)),
            midtone=float(d.get(C.RES_MIDTONE, 0.5)),
            highlight=float(d.get(C.RES_HIGHLIGHT, 1.0)),
        )


@dataclass(frozen=True)
class AutoStfConfig:
    target_bg: float = 0.25
    shadow_k: float = -2.8


# --- SCNR (types/image.rs:66-96) -------------------------------------------


class ScnrMethod(str, enum.Enum):
    AVERAGE_NEUTRAL = "average"
    MAXIMUM_NEUTRAL = "maximum"

    @staticmethod
    def parse(s: Optional[str]) -> "ScnrMethod":
        if s and s.lower().startswith("max"):
            return ScnrMethod.MAXIMUM_NEUTRAL
        return ScnrMethod.AVERAGE_NEUTRAL


@dataclass(frozen=True)
class ScnrConfig:
    method: ScnrMethod = ScnrMethod.AVERAGE_NEUTRAL
    amount: float = 1.0
    preserve_luminance: bool = False


# --- compose (types/compose.rs) --------------------------------------------


class WhiteBalanceMode(str, enum.Enum):
    AUTO = "auto"
    MANUAL = "manual"
    NONE = "none"


class AlignMethod(str, enum.Enum):
    PHASE_CORRELATION = "phase_correlation"
    AFFINE = "affine"

    @staticmethod
    def parse(s: Optional[str]) -> "AlignMethod":
        if s and s.lower().startswith("aff"):
            return AlignMethod.AFFINE
        return AlignMethod.PHASE_CORRELATION


@dataclass(frozen=True)
class WhiteBalance:
    mode: WhiteBalanceMode = WhiteBalanceMode.AUTO
    r: float = 1.0
    g: float = 1.0
    b: float = 1.0


@dataclass(frozen=True)
class DimensionHarmonize:
    """Record of resampling applied to harmonize channel dims
    (types/compose.rs:38)."""

    resampled: bool = False
    original_dims: Tuple[int, int] = (0, 0)
    target_dims: Tuple[int, int] = (0, 0)
    scale: float = 1.0


@dataclass(frozen=True)
class RgbComposeConfig:
    white_balance: WhiteBalance = field(default_factory=WhiteBalance)
    align: bool = True
    align_method: AlignMethod = AlignMethod.PHASE_CORRELATION
    auto_stretch: bool = True
    linked_stf: bool = True
    stf_r: Optional[StfParams] = None
    stf_g: Optional[StfParams] = None
    stf_b: Optional[StfParams] = None
    scnr: Optional[ScnrConfig] = None
    auto_stf: AutoStfConfig = field(default_factory=AutoStfConfig)


# --- stacking (types/stacking.rs) ------------------------------------------


class AlignmentMethod(str, enum.Enum):
    NONE = "none"
    PHASE_CORRELATION = "phase_correlation"
    AFFINE = "affine"
    # Zncc is vestigial in the reference (types/stacking.rs:31); it routes
    # to Affine (core/stacking/drizzle.rs:302-306). We accept and reroute.
    ZNCC = "zncc"

    @staticmethod
    def parse(s: Optional[str]) -> "AlignmentMethod":
        if not s:
            return AlignmentMethod.PHASE_CORRELATION
        t = s.lower()
        if t.startswith("aff") or t == "zncc":
            return AlignmentMethod.AFFINE
        if t == "none":
            return AlignmentMethod.NONE
        return AlignmentMethod.PHASE_CORRELATION


@dataclass(frozen=True)
class StackConfig:
    sigma_low: float = 3.0
    sigma_high: float = 3.0
    max_iterations: int = 5
    align: bool = True
    alignment_method: AlignmentMethod = AlignmentMethod.PHASE_CORRELATION


class DrizzleKernel(str, enum.Enum):
    SQUARE = "square"
    GAUSSIAN = "gaussian"
    LANCZOS3 = "lanczos3"

    @staticmethod
    def parse(s: Optional[str]) -> "DrizzleKernel":
        if not s:
            return DrizzleKernel.SQUARE
        t = s.lower()
        if t == C.KERNEL_GAUSSIAN:
            return DrizzleKernel.GAUSSIAN
        if t in (C.KERNEL_LANCZOS3, C.KERNEL_LANCZOS):
            return DrizzleKernel.LANCZOS3
        return DrizzleKernel.SQUARE


@dataclass(frozen=True)
class DrizzleConfig:
    scale: float = C.DEFAULT_DRIZZLE_SCALE
    pixfrac: float = C.DEFAULT_DRIZZLE_PIXFRAC
    kernel: DrizzleKernel = DrizzleKernel.SQUARE
    sigma_low: float = C.DEFAULT_DRIZZLE_SIGMA
    sigma_high: float = C.DEFAULT_DRIZZLE_SIGMA
    sigma_iterations: int = C.DEFAULT_DRIZZLE_SIGMA_ITERS
    align: bool = True
    alignment_method: AlignmentMethod = AlignmentMethod.PHASE_CORRELATION


@dataclass(frozen=True)
class RLConfig:
    """Richardson-Lucy deconvolution config (types/stacking.rs:89)."""

    iterations: int = 20
    psf_sigma: float = 2.0
    regularization: float = 0.0
    dering: bool = True
    dering_threshold: float = 0.1
    kernel_image: Optional[object] = None  # empirical PSF kernel (np array)
    # extension: run the FFT matmuls at DEFAULT precision — TF32 on the
    # H100 — instead of the true-f32 HIGHEST default. Opt-in
    # speed/accuracy trade: bench_ops.py reports the error it costs
    # (max_rel_err_vs_f32).
    fast_precision: bool = False


# --- app config (types/config.rs:4-29) --------------------------------------


@dataclass
class AppConfig:
    astrometry_api_key: str = ""
    astrometry_api_url: str = C.DEFAULT_ASTROMETRY_API_URL
    output_dir: str = ""
    plate_solve_timeout_secs: int = 120
    plate_solve_max_stars: int = 200
    auto_stretch_target_bg: float = 0.25
    auto_stretch_shadow_k: float = -2.8
    output_max_bytes: int = C.DEFAULT_OUTPUT_MAX_BYTES

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "AppConfig":
        cfg = AppConfig()
        for f in dataclasses.fields(AppConfig):
            if f.name in d and d[f.name] is not None:
                setattr(cfg, f.name, f.type(d[f.name]) if not isinstance(
                    d[f.name], (int, float, str)) else d[f.name])
        return cfg


# --- star detection / PSF ---------------------------------------------------


@dataclass(frozen=True)
class Star:
    x: float
    y: float
    flux: float
    peak: float
    fwhm: float
    eccentricity: float
    snr: float

    def to_dict(self) -> dict:
        return {
            C.RES_X: self.x,
            C.RES_Y: self.y,
            C.RES_FLUX: self.flux,
            C.RES_PEAK: self.peak,
            C.RES_FWHM: self.fwhm,
            C.RES_ELLIPTICITY: self.eccentricity,
            C.RES_SNR: self.snr,
        }


@dataclass(frozen=True)
class AlignResult:
    """Result of pairwise alignment (core/alignment/pair.rs)."""

    dy: float
    dx: float
    confidence: float
    method: str
    inliers: int = 0
    residual: float = 0.0
    matrix: Optional[Tuple[float, float, float, float, float, float]] = None

    def to_dict(self) -> dict:
        d = {
            C.RES_DY: self.dy,
            C.RES_DX: self.dx,
            C.RES_CONFIDENCE: self.confidence,
            "method": self.method,
            "inliers": self.inliers,
            "residual": self.residual,
        }
        if self.matrix is not None:
            d["matrix"] = list(self.matrix)
        return d
