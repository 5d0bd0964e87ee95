"""Numpy oracles, one function per reference file, used by parity tests.

Each function is a direct, reviewable port of the cited Rust (the
reference binary cannot be built here — no cargo). Keep these SLOW and
OBVIOUS: scalar loops and numpy only, no jax, no cleverness. Pinned
outputs on fixed inputs live in ``fixtures/`` so a later edit of an
oracle cannot silently drift together with the implementation
(regenerate with ``python tests/reference_impl/make_fixtures.py`` and
review the diff).
"""

from tests.reference_impl.stats import (ref_mad, ref_median, ref_stats,
                                        ref_valid)
from tests.reference_impl.sigma_clip import ref_sigma_clip_combine
from tests.reference_impl.stf import (ref_apply_stf_f32, ref_apply_stf_u8,
                                      ref_auto_stf, ref_mtf)
from tests.reference_impl.scnr import ref_apply_scnr
from tests.reference_impl.curves import (ref_apply_levels, ref_spline_lut)
from tests.reference_impl.drizzle import ref_drizzle
from tests.reference_impl.shift import ref_shift_rows
from tests.reference_impl.png import ref_decode_png

__all__ = [
    "ref_valid", "ref_median", "ref_mad", "ref_stats",
    "ref_sigma_clip_combine",
    "ref_mtf", "ref_auto_stf", "ref_apply_stf_u8", "ref_apply_stf_f32",
    "ref_apply_scnr",
    "ref_spline_lut", "ref_apply_levels",
    "ref_drizzle",
    "ref_shift_rows",
    "ref_decode_png",
]
