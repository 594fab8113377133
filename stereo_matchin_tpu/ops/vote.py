"""Histogram-vote disparity refinement over the adaptive cross region.

Reference: `kernels/disparity.cl` (`Disparity`).  For each pixel the kernel
walks its *left-image* vertical arms; for each visited row it re-reads that
row's horizontal arms and accumulates a 61-bin histogram of the (quantised)
initial disparity over the span, then outputs the mode.  Ties go to the
HIGHEST disparity (the `select` pair updates on `tab[i] >= result`).

The reference's per-pixel O(region) loop is 47-81% of the cross method's GPU
runtime (SURVEY.md §3.5).  This formulation is O(1) per pixel: build
one indicator plane per disparity, prefix-sum it, and evaluate the dynamic
arm-bounded window with the same two-gather trick as the OII aggregation —
plus explicit edge-clamp corrections, because `disparity.cl` reads through a
CLAMP_TO_EDGE sampler (taps beyond the border re-count the border pixel,
unlike the OII kernels' index-clamped prefix reads).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .common import disparity_to_image


def vote_indices(disp_img, d_max: int):
    """Truncate a stored disparity image to integer histogram bins.

    `disparity.cl:31-32` reads the UNORM8 image, multiplies by 60 and C-casts
    to int (truncation).  `disp_img` holds the image value on the [0,1] scale
    exactly as written (i.e. already UNORM8-quantised); float32 arithmetic
    matches the device.
    """
    return jnp.floor(disp_img.astype(jnp.float32) * d_max).astype(jnp.int32)


def _clamped_window_sum(prefix, raw, minus_arm, plus_arm, axis: int):
    """sum_{t=minus..plus} raw[clamp(i+t)] along `axis`, via prefix sums.

    prefix: inclusive cumsum of `raw` along `axis`; all arrays (D, H, W)
    (or broadcastable); minus_arm <= 0 < plus_arm are int32 arms.
    Clamped out-of-range taps re-count the border element, matching the
    reference sampler loop.
    """
    n = raw.shape[axis]
    if axis == 2:
        idx = jnp.arange(n, dtype=jnp.int32)[None, None, :]
        border_lo = raw[:, :, :1]
        border_hi = raw[:, :, n - 1:]
    else:
        idx = jnp.arange(n, dtype=jnp.int32)[None, :, None]
        border_lo = raw[:, :1, :]
        border_hi = raw[:, n - 1:, :]
    lo = idx + minus_arm            # window start (may be < 0)
    hi = idx + plus_arm             # window end (may be > n-1)
    hi_c = jnp.minimum(hi, n - 1)
    lo_c = jnp.maximum(lo, 0)
    upper = jnp.take_along_axis(prefix, jnp.broadcast_to(hi_c, prefix.shape), axis=axis)
    # S[lo_c - 1] with S[-1] = 0: gather at max(lo_c-1, 0) and zero when lo_c == 0.
    lower_idx = jnp.maximum(lo_c - 1, 0)
    lower = jnp.take_along_axis(prefix, jnp.broadcast_to(lower_idx, prefix.shape), axis=axis)
    lower = jnp.where(jnp.broadcast_to(lo_c > 0, lower.shape), lower, 0)
    in_range = upper - lower
    extra_lo = jnp.maximum(-lo, 0).astype(raw.dtype) * border_lo
    extra_hi = jnp.maximum(hi - (n - 1), 0).astype(raw.dtype) * border_hi
    return in_range + extra_lo + extra_hi


def _clamped_window_taps(vol, minus_arm, plus_arm, arm_len: int, axis: int):
    """sum_{j=minus..plus} vol[clamp(i+j)] as 2L+1 masked static shifts.

    Exactly the reference's sampler loop (integer counts — bit-identical
    to the prefix formulation), but gather-free and translation-invariant.
    """
    n = vol.shape[axis]
    pad = [(0, 0)] * 3
    pad[axis] = (arm_len, arm_len)
    ext = jnp.pad(vol, pad, mode="edge")  # clamp: border re-counted
    total = None
    for j in range(-arm_len, arm_len + 1):
        tap = jax.lax.slice_in_dim(ext, arm_len + j, arm_len + j + n,
                                   axis=axis)
        m = (j >= minus_arm) & (j <= plus_arm)
        term = jnp.where(m, tap, 0)
        total = term if total is None else total + term
    return total


def histogram_vote(disp_img, arms_l, d_max: int, quantize: bool = True,
                   arm_len: int = 25, impl: str = "auto"):
    """`Disparity`: mode of the initial disparity over the adaptive cross.

    disp_img: (H, W) stored image value in [0,1] (d/d_max after UNORM8).
    arms_l: (4, H, W) int32 left-image arms [h-, h+, v-, v+], minus negative.
    arm_len: static arm bound (sizes the taps implementation).
    impl: "prefix" (or "auto": cumsum + gathers, edge-corrected) or
    "taps" (masked static shifts — integer-identical).
    Returns the refined disparity as a stored image value in [0,1].
    """
    num_disp = d_max + 1
    idx = vote_indices(disp_img, d_max)                      # (H, W) int32
    ds = jnp.arange(num_disp, dtype=jnp.int32)[:, None, None]
    indicator = (idx[None] == ds).astype(jnp.int32)          # (D, H, W)

    h_minus, h_plus = arms_l[0][None], arms_l[1][None]
    v_minus, v_plus = arms_l[2][None], arms_l[3][None]
    if impl == "taps":
        row_counts = _clamped_window_taps(indicator, h_minus, h_plus,
                                          arm_len, axis=2)
        tab = _clamped_window_taps(row_counts, v_minus, v_plus,
                                   arm_len, axis=1)
    else:
        # Horizontal pass: per-row counts using each row's own h arms.
        row_prefix = jnp.cumsum(indicator, axis=2)
        row_counts = _clamped_window_sum(row_prefix, indicator, h_minus,
                                         h_plus, axis=2)
        # Vertical pass: anchor-pixel v arms over the per-row counts.
        col_prefix = jnp.cumsum(row_counts, axis=1)
        tab = _clamped_window_sum(col_prefix, row_counts, v_minus, v_plus,
                                  axis=1)

    # Mode with ties to the highest disparity (disparity.cl:39-42 select pair).
    mode = (num_disp - 1) - jnp.argmax(tab[::-1], axis=0).astype(jnp.int32)
    return disparity_to_image(mode, d_max, quantize)
