"""End-to-end jitted stereo pipelines.

`cross_based` — Zhang/Lu/Lafruit orthogonal-integral-image method.
`asw`        — Kowalczuk/Psota/Pérez iterative adaptive-support-weight method.
`tiled`      — row-band drivers for frames bigger than device memory
               (the cross driver routes to the strip-carrying
               `wavefront_cross` when the band geometry supports it).
"""

from .cross_based import (
    CrossResult,
    cross_pipeline,
    cross_pipeline_fused,
    cross_pipeline_impl,
    cross_pipeline_staged,
)
from .asw import ASWResult, asw_pipeline, asw_pipeline_impl
from .tiled import asw_pipeline_tiled, auto_bands, cross_pipeline_tiled

__all__ = [
    "ASWResult",
    "CrossResult",
    "asw_pipeline",
    "asw_pipeline_impl",
    "asw_pipeline_tiled",
    "auto_bands",
    "cross_pipeline",
    "cross_pipeline_impl",
    "cross_pipeline_tiled",
]
