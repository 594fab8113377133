"""Quality metrics and golden-image regression."""

from .synthetic import synthetic_scene
from .metrics import (
    MapComparison,
    adjudicate_ties,
    argmin_tie_gap,
    bad_pixel_pct,
    compare_maps,
    compare_to_golden,
    golden_path,
)

__all__ = [
    "MapComparison",
    "adjudicate_ties",
    "argmin_tie_gap",
    "bad_pixel_pct",
    "compare_maps",
    "compare_to_golden",
    "golden_path",
    "synthetic_scene",
]
