"""Multi-device scale-out: meshes, sharded pipelines.

The reference is a single-node rayon app; its natural scale axes map
to a device mesh as: frame axis (per-exposure align/decode/metrics —
data-parallel) and spatial row axis (per-pixel reductions, stencils —
the sequence-parallel analog). See SURVEY.md §5.
"""

from astroburst_tpu.parallel.mesh import make_mesh
from astroburst_tpu.parallel.pipeline import (align_stack_stretch,
                                              make_sharded_stack_step)

__all__ = ["make_mesh", "align_stack_stretch", "make_sharded_stack_step"]
