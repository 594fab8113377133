"""Host-driven row-band tiling for frames whose working set exceeds the
device's memory.

BASELINE configs[3] (Middlebury 2014, ~2880x1988 at ~280 disparities)
needs a ~6.4 GB cost volume *per aggregation buffer* — too big to keep
the ten-odd live volumes of one ASW program on one card.  This driver
runs the ordinary single-device pipeline over horizontal bands with
enough overlap that every kept row is
beyond the pipeline's total vertical influence radius from the band cut,
making the banded result IDENTICAL to the full-image run (pinned by
tests).  The multi-chip analogue (all bands resident, ppermute halos) is
`parallel.make_asw_sharded`; this is the sequential fits-in-memory form.

Influence radii (one side):
  ASW:   aggregation r passes x R  +  support reads R  +  refinement
         k passes x R  +  final median 1   ->  (r + k + 1) * R + 1
  cross: median 1 + arm reads (L+1) + OII vertical window L + vote
         vertical reach L (arms re-read at visited rows add nothing
         vertically) + final median 1      ->  3L + 4
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..config import StereoConfig
from . import asw as asw_mod
from . import cross_based as cross_mod


def asw_reach(cfg: StereoConfig) -> int:
    return (cfg.r_iters + cfg.k_iters + 1) * cfg.radius + 1


#: Planned peak device memory of one ASW band program, in units of one
#: cost volume's bytes (D * W * rows * 4): `compiled.memory_analysis()`
#: of the 1219-row band program at BASELINE config 3 (280 disparities,
#: 2880 columns) on an H100 planned 19.77 GB, 5.03 volumes per row
#: (PERF.md).  The weight strips add a disparity-independent share, so
#: at far fewer disparities the estimate runs low.
_ASW_PLAN_FACTOR = 5.1


def device_memory_bytes(device=None) -> int:
    """The memory the allocator may hand out on `device` (default: the
    first device), from its `memory_stats()["bytes_limit"]`."""
    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise ValueError(
            f"{device.platform} device reports no memory limit; pass "
            "memory_bytes to auto_bands")
    return int(stats["bytes_limit"])


def auto_bands(shape, cfg: StereoConfig, memory_bytes: int | None = None,
               safety: float = 0.85) -> int:
    """Smallest ASW band count whose band program — kept rows plus the
    2 * asw_reach halo rows it recomputes — is expected to fit in
    `safety * memory_bytes` (default: the device's own limit); 1 means
    the whole frame fits.

    The estimate is `_ASW_PLAN_FACTOR` cost-volume-equivalents per
    program row.  It is a planning heuristic, not a guarantee: XLA's
    allocator decides.
    """
    H, W = shape[:2]
    if memory_bytes is None:
        memory_bytes = device_memory_bytes()
    per_row = _ASW_PLAN_FACTOR * cfg.num_disp * W * 4
    rows_fit = int(safety * memory_bytes / per_row)
    if rows_fit >= H:
        return 1
    halo = 2 * asw_reach(cfg)
    if rows_fit <= halo:
        raise ValueError(
            f"even one-row bands need {halo} halo rows; {rows_fit} rows "
            f"fit in {memory_bytes} bytes at {cfg.num_disp} disparities x "
            f"{W} columns")
    return math.ceil(H / (rows_fit - halo))


def cross_reach(cfg: StereoConfig) -> int:
    return 3 * cfg.arm_len + 4


def _run_banded(run_band: Callable, crop_axes, left, right, reach: int,
                num_bands: int, band_crop: Callable = None):
    """Generic band loop.  run_band(left_slice, right_slice, crop) ->
    pytree of arrays; crop_axes: matching pytree of the row axis per leaf;
    band_crop(halo_top, halo_bot) -> rows the pipeline itself sheds from
    each side mid-run (see asw_pipeline_impl's crop), (0, 0) when None.

    Each band is finished before the next is dispatched: the whole point
    of banding is bounding device memory, and async dispatch would
    otherwise keep every band's multi-GB workspace in flight at once."""
    H = left.shape[0]
    band = math.ceil(H / num_bands)
    pieces = []
    for b in range(num_bands):
        y0, y1 = b * band, min(H, (b + 1) * band)
        if y0 >= y1:
            break
        lo, hi = max(0, y0 - reach), min(H, y1 + reach)
        crop = band_crop(y0 - lo, hi - y1) if band_crop else (0, 0)
        out = run_band(left[lo:hi], right[lo:hi], crop)
        off = y0 - lo - crop[0]
        cropped = jax.tree.map(
            lambda leaf, ax: jax.lax.slice_in_dim(leaf, off, off + (y1 - y0),
                                                  axis=ax),
            out, crop_axes)
        jax.block_until_ready(cropped)
        pieces.append(cropped)

    def cat(*leaves_and_axis):
        *leaves, ax = leaves_and_axis
        return jnp.concatenate(leaves, axis=ax)

    return jax.tree.map(cat, *pieces, crop_axes)


# Select the two kept maps INSIDE the jit: asw_pipeline's full result
# includes the (D, H, W) aggregated cost volume, which would otherwise be
# materialised as a multi-GB output buffer per band at Middlebury-2014
# geometry.  Module-level so jax.jit's cache (keyed on function identity)
# persists across asw_pipeline_tiled calls — a per-call closure retraced
# every band of every frame.
@partial(jax.jit, static_argnums=(2, 3))
def _asw_band_jit(l, r, cfg, crop):
    res = asw_mod.asw_pipeline_impl(l, r, cfg, crop)
    return {"disparity": res.disparity, "filled": res.filled}


def asw_pipeline_tiled(left, right, cfg: StereoConfig, num_bands: int):
    """Banded ASW run; returns (disparity, filled) maps, identical to the
    full-image asw_pipeline outputs.  Every band recomputes asw_reach
    halo rows on each side."""
    reach = asw_reach(cfg)
    # Aggregation needs the full halo; everything after it reaches only
    # k*radius + 1 rows, so the pipeline sheds the difference per side
    # mid-run (asw_pipeline_impl's crop) — the aggregated volume, its
    # diagonal shear, and all post-aggregation compute shrink accordingly.
    keep = cfg.k_iters * cfg.radius + 1

    def run_band(l, r, crop):
        return _asw_band_jit(l, r, cfg, crop)

    def band_crop(h_top, h_bot):
        return max(0, h_top - keep), max(0, h_bot - keep)

    axes = {"disparity": 0, "filled": 0}
    out = _run_banded(run_band, axes, left, right, reach, num_bands,
                      band_crop)
    return out["disparity"], out["filled"]


def cross_pipeline_tiled(left, right, cfg: StereoConfig, num_bands: int,
                         wavefront: str | bool = "auto"):
    """Banded cross-method run; returns (initial, final) maps.

    wavefront: "auto" routes to the strip-carrying wavefront driver
    (models/wavefront_cross.py — no halo recompute) whenever the band
    geometry supports the strips; True forces it; False forces the plain
    halo-recompute band loop.  Both use the translation-invariant taps
    OII semantics.

    Forces the translation-invariant "taps" OII implementation — the
    prefix integral images are not (column cumsums start at the band
    top), which flips argmin ties between banded and full runs.  "taps"
    evaluates per-pixel windows whose only boundary effects (the dropped
    row/column-0 quirk and the edge clamp) stay within the influence halo
    that the band driver crops, so banded == full for the kept rows.
    """
    if cfg.median_dispatch_quirk:
        raise ValueError(
            "median_dispatch_quirk is a frame-level golden-comparison "
            "quirk (truncated full-frame Median dispatches) and is not "
            "meaningful per band; use cross_pipeline")
    if wavefront in ("auto", True):
        from . import wavefront_cross as wfc

        if wfc.cross_wavefront_supported(left.shape, cfg, num_bands):
            return wfc.cross_pipeline_wavefront(left, right, cfg, num_bands)
        if wavefront is True:
            raise ValueError(
                "wavefront=True but the cross wavefront band layout is "
                "unsupported at this geometry/config")
    cfg = cfg.replace(oii_impl="taps")
    reach = cross_reach(cfg)

    def run_band(l, r, crop):
        res = cross_mod.cross_pipeline(l, r, cfg)
        return {"initial": res.initial, "final": res.final}

    axes = {"initial": 0, "final": 0}
    out = _run_banded(run_band, axes, left, right, reach, num_bands)
    return out["initial"], out["final"]
