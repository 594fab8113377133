"""Pure-jnp reference ops for the stereo engine.

Each module mirrors one reference OpenCL kernel family (file:line citations
in the module docstrings); these are the semantic ground truth that the
GPU kernels in `stereo_matchin_tpu.kernels` are tested against.
"""

from .common import (
    disparity_to_image,
    image_from_q,
    in_bounds_mask,
    quantize_disparity,
    shift2d,
    shift_axis,
    stack_shift_x,
    to_unit,
    unorm8,
    unorm8_code,
    unorm8_level,
)
from .cost import sad_cost_volume
from .median import median3x3, median_dispatch_truncate
from .cross import cross_arms
from .support import support_weights
from .aggregation import asw_aggregate, asw_aggregate_pass
from .oii import (
    combined_arms,
    cross_aggregate,
    integral_h,
    integral_v,
    oii_hcross,
    oii_vcross,
)
from .vote import histogram_vote, vote_indices
from .asw2d import asw_aggregate_2d
from .wta import (
    WTAResult,
    epipolar_target_scan,
    two_min_scan,
    wta,
    wta_argmin,
    wta_refined,
)
from .wta_fast import wta_fast, wta_refined_fast
from .consistency import ConsistencyResult, consistency, red_diagnostic
from .refinement import (
    refine_pass_h,
    refine_pass_v,
    refine_view,
    refinement_weights,
)

__all__ = [
    "ConsistencyResult",
    "WTAResult",
    "asw_aggregate",
    "asw_aggregate_2d",
    "asw_aggregate_pass",
    "combined_arms",
    "consistency",
    "cross_aggregate",
    "cross_arms",
    "epipolar_target_scan",
    "histogram_vote",
    "in_bounds_mask",
    "integral_h",
    "integral_v",
    "median3x3",
    "median_dispatch_truncate",
    "oii_hcross",
    "oii_vcross",
    "quantize_disparity",
    "red_diagnostic",
    "refine_pass_h",
    "refine_pass_v",
    "refine_view",
    "refinement_weights",
    "sad_cost_volume",
    "shift2d",
    "shift_axis",
    "stack_shift_x",
    "disparity_to_image",
    "image_from_q",
    "support_weights",
    "to_unit",
    "two_min_scan",
    "unorm8",
    "unorm8_code",
    "unorm8_level",
    "vote_indices",
    "wta",
    "wta_argmin",
    "wta_refined",
]
