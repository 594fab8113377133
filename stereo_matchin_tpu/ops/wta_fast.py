"""Vectorised WTA — exact replacement for the sequential epipolar scans.

`ops.wta` / `ops.wta_refined` replay asw_wta.cl's target-view derivation as
a D-step `fori_loop`, each step gathering from the full cost volume, and
the ASW pipeline runs it 1 + k times per frame.

Key identity: with the slope-1 `bresenham`, probe i touches
    (b, xq) with  b = d1 + max(0, x-i) - x,
so every *unclamped* probe (i <= x) of left pixel x reads
    cost[b, y, x - d1 + b]   for   b in [max(1, d1-x), d1],
i.e. one diagonal of the volume, addressable with a single
`take_along_axis` gather — followed by a masked two-min with ties to the
LARGEST b (earlier scan step).  The clamped tail (i > x, only pixels with
x < d1) revisits the single plane b0 = d1 - x with, in the WTA_REF case, a
varying penalty |ref - i|; its two-min is evaluated in closed form over
*maps* (no volume reads).  Disparities are bit-identical to the
sequential scans (pinned by tests against ops.wta / ops.wta_refined);
confidences may differ by an ulp where the compiler contracts the
penalty multiply-add differently.
"""

from __future__ import annotations

import jax.numpy as jnp

from .wta import WTAResult, two_min_scan


def _masked_two_min_high_tie(vals, fallback_d, big):
    """Two smallest of (D, H, W) `vals` (inf = missing) over axis 0 with
    ties to the LARGEST plane index; sequential big-cap semantics."""
    D = vals.shape[0]
    rev = vals[::-1]
    j = jnp.argmin(rev, axis=0)
    b_win = (D - 1) - j.astype(jnp.int32)
    c1_raw = jnp.min(vals, axis=0)
    ids = jnp.arange(D, dtype=jnp.int32)[:, None, None]
    masked = jnp.where(ids == b_win[None], jnp.inf, vals)
    c2_raw = jnp.min(masked, axis=0)
    any_update = c1_raw < big
    d = jnp.where(any_update, b_win, fallback_d)
    c1 = jnp.minimum(c1_raw, big)
    c2 = jnp.where(any_update, jnp.minimum(c2_raw, big), big)
    return c1, c2, d


def _gather_diagonal(cost, d1):
    """gathered[b, y, x] = cost[b, y, clip(x - d1[y,x] + b, 0, W-1)]: all
    probes of one pixel lie on one volume diagonal, so the unclamped
    target-scan probes are a single `take_along_axis` gather."""
    D, H, W = cost.shape
    xs = jnp.arange(W, dtype=jnp.int32)[None, :]
    bs = jnp.arange(D, dtype=jnp.int32)[:, None, None]
    idx = jnp.clip(xs[None] - d1[None] + bs, 0, W - 1)
    return jnp.take_along_axis(cost, idx, axis=2)


def _target_scan_fast(cost, d1, penalty_scale=None, penalty_center=None,
                      big: float = 1e5):
    """Exact vectorised asw_wta.cl:55-67 / asw_wta_ref.cl:40-51 target scan."""
    D, H, W = cost.shape
    xs = jnp.arange(W, dtype=jnp.int32)[None, :]
    dt = cost.dtype

    # --- unclamped probes: one diagonal gather -----------------------------
    bs = jnp.arange(D, dtype=jnp.int32)[:, None, None]
    gathered = _gather_diagonal(cost, d1)               # (D, H, W)
    if penalty_scale is not None:
        i_of_b = (d1[None] - bs).astype(dt)             # step index i = d1 - b
        pen = penalty_scale[None] * jnp.abs(penalty_center[None] - i_of_b)
        vals = gathered + pen
    else:
        vals = gathered
    lo = jnp.maximum(1, d1[None] - xs[None])            # b >= max(1, d1-x)
    mask = (bs >= lo) & (bs <= d1[None]) & (vals < big)
    vals = jnp.where(mask, vals, jnp.inf)
    mc1, mc2, md = _masked_two_min_high_tie(vals, d1, big)

    # --- clamped tail: i in (x, d1), all probing plane b0 = d1 - x ---------
    b0 = jnp.maximum(d1 - xs, 0)                        # (H, W); valid iff d1 > x
    base = jnp.take_along_axis(gathered, b0[None].astype(jnp.int32),
                               axis=0)[0]               # cost[b0, y, 0]
    return _tail_and_merge(d1, xs, mc1, mc2, md, base, b0,
                           penalty_scale, penalty_center, big, dt, D, H, W)


def _tail_and_merge(d1, xs, mc1, mc2, md, base, b0, penalty_scale,
                    penalty_center, big, dt, D, H, W):
    # Clamped-tail two-min in CLOSED FORM.  The scanned value
    # v(i) = base + sc*|ct - i| over the integer interval
    # i in [lo, hi] = [max(1, x+1), min(D-2, d1-1)] is V-shaped in i, so
    # the two smallest v's sit at the in-range integer nearest ct and at
    # its best in-range neighbour — no D-iteration fori (it was ~280
    # compare/select sweeps over (H, W) at config-3 scale, ~45 ms/band).
    # Values are bit-identical to the scan: the winning v is computed by
    # the same f32 expression, v is monotone in |ct - i| so the v < big
    # mask keeps exactly the near candidates, and ties (ct exactly
    # half-integer) have EQUAL v on both neighbours — the scan's
    # first-wins order changes which i wins, never the (c1, c2) values.
    inf = jnp.float32(jnp.inf)
    lo = jnp.maximum(jnp.float32(1.0), xs.astype(dt) + 1.0)
    hi = jnp.minimum(jnp.float32(D - 2), d1.astype(dt) - 1.0)
    n = hi - lo + 1.0                                    # valid count
    if penalty_scale is not None:
        ct = penalty_center
        p = jnp.clip(jnp.round(ct), lo, hi)              # nearest in range
        v_of = lambda i: base + penalty_scale * jnp.abs(ct - i)
        v1 = v_of(p)
        q_lo = jnp.where(p - 1.0 >= lo, v_of(p - 1.0), inf)
        q_hi = jnp.where(p + 1.0 <= hi, v_of(p + 1.0), inf)
        v2 = jnp.minimum(q_lo, q_hi)
    else:
        v1 = base
        v2 = base
    tc1 = jnp.where((n >= 1.0) & (v1 < big), v1, inf)
    tc2 = jnp.where((n >= 2.0) & (v2 < big), v2, inf)
    t_any = tc1 < big
    tc1c = jnp.minimum(tc1, big)
    tc2c = jnp.where(t_any, jnp.minimum(tc2, big), big)

    # --- merge (main is earlier in scan order; ties keep main) -------------
    take_t = tc1c < mc1
    c1 = jnp.where(take_t, tc1c, mc1)
    d = jnp.where(take_t, b0, md)
    c2 = jnp.minimum(jnp.minimum(mc2, tc2c), jnp.maximum(mc1, tc1c))
    conf = (c2 - c1) / c2
    return d, conf


def _two_min(cost, pen_scale=None, pen_center=None, big: float = 1e5):
    """Reference-view two-min, with the WTA_REF penalty when given."""
    if pen_scale is None:
        return two_min_scan(cost, big=big)
    ds = jnp.arange(cost.shape[0], dtype=cost.dtype)[:, None, None]
    pen = pen_scale[None] * jnp.abs(pen_center[None] - ds)
    return two_min_scan(cost, penalty=pen, big=big)


def wta_fast(cost, big: float = 1e5) -> WTAResult:
    """Drop-in replacement for ops.wta (bit-identical results)."""
    c1, c2, d1 = _two_min(cost, big=big)
    conf_ref = (c2 - c1) / c2
    d_t, conf_t = _target_scan_fast(cost, d1, big=big)
    return WTAResult(d1.astype(cost.dtype), conf_ref,
                     d_t.astype(cost.dtype), conf_t)


def wta_refined_fast(cost, ref_value, ref_denom, ref_value_t, ref_denom_t,
                     penalty: float, big: float = 1e5) -> WTAResult:
    """Drop-in replacement for ops.wta_refined (bit-identical
    disparities)."""
    c1, c2, d1 = _two_min(cost, penalty * ref_denom, ref_value, big=big)
    conf_ref = (c2 - c1) / c2
    d_t, conf_t = _target_scan_fast(
        cost, d1, penalty_scale=penalty * ref_denom_t,
        penalty_center=ref_value_t, big=big)
    return WTAResult(d1.astype(cost.dtype), conf_ref,
                     d_t.astype(cost.dtype), conf_t)
