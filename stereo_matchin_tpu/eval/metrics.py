"""Disparity-map quality metrics and golden-image regression.

The reference's verification was visual + offline bad-pixel rates against
Middlebury ground truth (thesis PDF p.34; SURVEY.md §4).  This module
systematizes both: bad-pixel percentage between any two maps, and golden
comparisons against the artifacts committed in the reference checkout
(`cross_based_initial.png`, `cross_based_disparity.png`,
`asw_disparity.png`, per-stage dumps under `sukub/`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MapComparison:
    exact_pct: float     # |d_got - d_ref| < 0.5  (on the disparity scale)
    bad1_pct: float      # |d_got - d_ref| > 1.0
    bad2_pct: float      # |d_got - d_ref| > 2.0
    mean_abs: float

    def __str__(self):
        return (f"exact={self.exact_pct:.2f}% bad1={self.bad1_pct:.2f}% "
                f"bad2={self.bad2_pct:.2f}% meanabs={self.mean_abs:.3f}")


def compare_maps(got, ref, d_max: int = 60, mask=None) -> MapComparison:
    """got/ref: (H, W) stored image values in [0,1] OR disparities when
    d_max=1.  Differences are evaluated on the [0, d_max] scale."""
    g = np.asarray(got, np.float64) * d_max
    r = np.asarray(ref, np.float64) * d_max
    diff = np.abs(g - r)
    if mask is not None:
        diff = diff[np.asarray(mask)]
    return MapComparison(
        exact_pct=float(np.mean(diff < 0.5) * 100.0),
        bad1_pct=float(np.mean(diff > 1.0) * 100.0),
        bad2_pct=float(np.mean(diff > 2.0) * 100.0),
        mean_abs=float(diff.mean()),
    )


def bad_pixel_pct(got_disp, gt_disp, threshold: float = 2.0, mask=None) -> float:
    """Classic Middlebury bad-pixel rate: % of pixels whose absolute
    disparity error exceeds `threshold` (both inputs on the same scale)."""
    diff = np.abs(np.asarray(got_disp, np.float64) - np.asarray(gt_disp, np.float64))
    if mask is not None:
        diff = diff[np.asarray(mask)]
    return float(np.mean(diff > threshold) * 100.0)


def golden_path(pair_name: str, artifact: str) -> str:
    from ..io.datasets import get_pair
    import os

    pair = get_pair(pair_name)
    assert pair.golden_dir is not None
    return os.path.join(pair.golden_dir, artifact)


def compare_to_golden(got_img, pair_name: str, artifact: str,
                      d_max: int = 60) -> MapComparison:
    """Compare an (H, W) [0,1] map against a committed reference PNG."""
    from ..io import png

    gold = png.read_gray(golden_path(pair_name, artifact))
    return compare_maps(got_img, gold, d_max=d_max)


def argmin_tie_gap(costs: np.ndarray) -> np.ndarray:
    """Relative gap between the two smallest costs along axis 0:
    (c2 - c1) / c1, the margin a float sum-order change has to flip."""
    v = np.sort(np.asarray(costs, np.float64), axis=0)
    return (v[1] - v[0]) / np.maximum(v[0], 1e-30)


def adjudicate_ties(got, want, aggregate, max_frac: float = 0.002,
                    max_gap: float = 2.4e-7) -> int:
    """Prove that every pixel where two WTA maps disagree is an argmin
    tie.  got/want: (B, H, W) maps; aggregate(b) -> (D, H, W) aggregated
    costs of frame b.  Raises AssertionError unless the disagreements are
    at most `max_frac` of the pixels and each one's top-two costs lie
    within `max_gap` relative (2.4e-7 is two float32 ulps).  Returns the
    number of disagreements."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.argwhere(got != want)
    if not len(bad):
        return 0
    assert len(bad) <= max_frac * got.size, (len(bad), got.size)
    for b in sorted(set(bad[:, 0].tolist())):
        aggr = np.asarray(aggregate(b))
        for _, y, x in bad[bad[:, 0] == b]:
            gap = float(argmin_tie_gap(aggr[:, y, x]))
            assert gap <= max_gap, (int(b), int(y), int(x), gap)
    return len(bad)
