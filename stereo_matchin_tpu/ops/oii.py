"""Orthogonal-integral-image (OII) cross aggregation for the cross-based method.

Reference kernels: `kernels/integral_h.cl` (`Integral_h`, in-place row prefix
sums of the cost volume), `kernels/oii_hcross.cl` (`Oii_hcross`, windowed mean
over the combined horizontal arms), `kernels/integral_v.cl` (`Integral_v`,
column prefix sums of the horizontal result) and `kernels/oii_vcross.cl`
(`Oii_vcross`, windowed mean over the combined vertical arms).  Together they
implement Zhang/Lu/Lafruit adaptive-cross aggregation in O(1) per pixel.

The reference runs one *sequential* work-item per (row, disparity) for
the prefix sums (SURVEY.md §3.5).  Here the "prefix" implementation uses
`jnp.cumsum` (XLA lowers to a parallel scan) with arm-indexed
`take_along_axis` gathers; the "taps" implementation evaluates the same
index sets as 2L+1 masked static shifts, which is gather-free and
translation-invariant (the band and mesh drivers need that).

Faithful quirks (all from the .cl sources):
  * the window *mean* divides by ``h_plus - h_minus`` — one less than the
    number of pixels in the span (oii_hcross.cl `delta`);
  * the lower prefix index clamps as ``max(0, x + h_minus - 1)`` so when the
    span starts at pixel 0 the subtrahend is I[0], silently dropping pixel 0
    from the sum (same vertically);
  * the upper index clamps to the last pixel: ``min(W-1, x + h_plus)``;
  * the right image's arms are read at ``max(0, x - d)`` (clamp-to-edge).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .common import stack_shift_x


def integral_h(cost):
    """Row-wise inclusive prefix sum of a (D, H, W) cost volume (Integral_h)."""
    return jnp.cumsum(cost, axis=2)


def integral_v(vol):
    """Column-wise inclusive prefix sum of a (D, H, W) volume (Integral_v)."""
    return jnp.cumsum(vol, axis=1)


def _windowed_mean_from_prefix(prefix, minus_arm, plus_arm, axis: int):
    """Reference window read: (I[min(n-1, i+plus)] - I[max(0, i+minus-1)]) / (plus-minus).

    prefix: (D, H, W) prefix-summed volume along `axis` (1=y, 2=x).
    minus_arm / plus_arm: (D, H, W) int32 combined arms (minus stored negative).
    """
    n = prefix.shape[axis]
    if axis == 2:
        idx = jnp.arange(n, dtype=jnp.int32)[None, None, :]
    else:
        idx = jnp.arange(n, dtype=jnp.int32)[None, :, None]
    hi = jnp.minimum(idx + plus_arm, n - 1)
    lo = jnp.maximum(idx + minus_arm - 1, 0)
    upper = jnp.take_along_axis(prefix, jnp.broadcast_to(hi, prefix.shape), axis=axis)
    lower = jnp.take_along_axis(prefix, jnp.broadcast_to(lo, prefix.shape), axis=axis)
    delta = (plus_arm - minus_arm).astype(prefix.dtype)
    return (upper - lower) / delta


def combined_arms(arms_l, arms_r, num_disp: int, plane_minus: int, plane_plus: int):
    """Combine left/right arms per disparity (oii_hcross.cl:28-30 semantics).

    arms_l/arms_r: (4, H, W) int32 planes [h-, h+, v-, v+], minus negative.
    Right arms are read at x_r = max(0, x - d).  Minus arms combine with
    `max` (less negative = shorter), plus arms with `min`.
    Returns (minus, plus), each (D, H, W).
    """
    minus_r = stack_shift_x(arms_r[plane_minus], num_disp, x_axis=1)
    plus_r = stack_shift_x(arms_r[plane_plus], num_disp, x_axis=1)
    minus = jnp.maximum(minus_r, arms_l[plane_minus][None])
    plus = jnp.minimum(plus_r, arms_l[plane_plus][None])
    return minus, plus


def oii_hcross(cost_prefix_h, arms_l, arms_r):
    """Horizontal cross cost from row prefix sums (Oii_hcross)."""
    D = cost_prefix_h.shape[0]
    minus, plus = combined_arms(arms_l, arms_r, D, plane_minus=0, plane_plus=1)
    return _windowed_mean_from_prefix(cost_prefix_h, minus, plus, axis=2)


def oii_vcross(temp_prefix_v, arms_l, arms_r):
    """Vertical cross cost from column prefix sums (Oii_vcross)."""
    D = temp_prefix_v.shape[0]
    minus, plus = combined_arms(arms_l, arms_r, D, plane_minus=2, plane_plus=3)
    return _windowed_mean_from_prefix(temp_prefix_v, minus, plus, axis=1)


def _windowed_mean_taps(vol, minus_arm, plus_arm, arm_len: int, axis: int):
    """Tap-sum evaluation of the same index set the prefix difference reads.

    sum over positions c in (max(0, i+minus-1), min(n-1, i+plus)], i.e.
    taps j in [-L, L] masked by (j >= minus) & (j <= plus) & (1 <= i+j <=
    n-1) — note position 0 is always excluded, reproducing the reference's
    `max(0, i+minus-1)` lower-prefix quirk.  Gather-free: 2L+1 static
    shifts with masks, which XLA fuses into one pass.  Float sum order
    differs from the
    prefix difference (the reference's own in-order device sums differ
    from both); quality deltas are covered by the golden tolerances.
    """
    n = vol.shape[axis]
    if axis == 2:
        idx = jnp.arange(n, dtype=jnp.int32)[None, None, :]
    else:
        idx = jnp.arange(n, dtype=jnp.int32)[None, :, None]
    pad = [(0, 0)] * 3
    pad[axis] = (arm_len, arm_len)
    ext = jnp.pad(vol, pad)
    total = None
    for j in range(-arm_len, arm_len + 1):
        tap = jax.lax.slice_in_dim(ext, arm_len + j, arm_len + j + n,
                                   axis=axis)
        c = idx + j
        m = ((j >= minus_arm) & (j <= plus_arm) & (c >= 1) & (c <= n - 1))
        term = jnp.where(m, tap, 0.0)
        total = term if total is None else total + term
    delta = (plus_arm - minus_arm).astype(vol.dtype)
    return total / delta


def cross_aggregate(cost, arms_l, arms_r, arm_len: int = 25,
                    impl: str = "auto"):
    """Full adaptive-cross aggregation (Integral_h -> Oii_hcross ->
    Integral_v -> Oii_vcross).

    arm_len: static bound on arm length (StereoConfig.arm_len) — sizes the
    tap range of the "taps" implementation.
    impl: "prefix" (or "auto") = cumsum + arm-indexed gathers (mirrors the
    reference's integral-image reads); "taps" = masked static shifts
    (same index sets, different float sum order).
    """
    if impl in ("auto", "prefix"):
        temp = oii_hcross(integral_h(cost), arms_l, arms_r)
        return oii_vcross(integral_v(temp), arms_l, arms_r)
    D = cost.shape[0]
    hm, hp = combined_arms(arms_l, arms_r, D, plane_minus=0, plane_plus=1)
    vm, vp = combined_arms(arms_l, arms_r, D, plane_minus=2, plane_plus=3)
    temp = _windowed_mean_taps(cost, hm, hp, arm_len, axis=2)
    return _windowed_mean_taps(temp, vm, vp, arm_len, axis=1)
