"""Separable iterated ASW cost aggregation — the hot loop (94% of runtime).

Reference: kernels/asw_vcost_aggregation.cl (`asw_vCostAggregation`) and
kernels/asw_hcost_aggregation.cl (`asw_hCostAggregation`), enqueued r=7
times back-to-back (main.cpp:492-515).  Each pass computes, per
(d, y, x):

    num = eps + sum_t  wL[t, y, x] * wR[t, y, max(x-d, 0)] * C[d, nb(t), x]
    den = eps + sum_t  wL[t, y, x] * wR[t, y, max(x-d, 0)]
    out = num / den

with nb(t) the clamped neighbour offset t-R along the pass axis.  The
joint left*right (bilateral) weighting is the Kowalczuk/Psota/Perez
formulation.  This module is the pure-jnp reference implementation; the
Triton kernel in kernels/asw_aggregation.py computes the same function
(the GPU path) with the denominator hoisted out of the r-loop.

Memory note: the joint weight tensor (D, T, H, W) is never materialised —
for tsukuba it would be ~900 MB.  Each tap's (D, H, W) joint weight is
formed on the fly from one gather of the shifted right strip, which XLA
fuses into the multiply-accumulate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .common import shift_axis, stack_shift_x


def asw_aggregate_pass(cost, w_left, w_right, axis: int, radius: int, eps: float = 1e-5):
    """One separable aggregation pass.

    cost: (D, H, W); w_left / w_right: (T, H, W) support-weight strips.
    axis: 1 for the vertical pass (neighbours along y), 2 for horizontal.
    Returns (out, den), both (D, H, W) — den is the reference's denominator
    volume (asw_vcost_aggregation.cl:370 output_denom).
    """
    D = cost.shape[0]
    T = w_left.shape[0]
    num = jnp.full_like(cost, eps)
    den = jnp.full_like(cost, eps)
    for t in range(T):
        ww = w_left[t][None] * stack_shift_x(w_right[t], D)  # (D, H, W)
        c_nb = shift_axis(cost, t - radius, axis=axis)
        num = num + ww * c_nb
        den = den + ww
    return num / den, den


def asw_aggregate(cost, wv_left, wv_right, wh_left, wh_right, radius: int,
                  r_iters: int, eps: float = 1e-5):
    """r_iters x (vertical pass -> horizontal pass), as main.cpp:492-515."""

    def body(c, _):
        cv, _ = asw_aggregate_pass(c, wv_left, wv_right, axis=1, radius=radius, eps=eps)
        ch, _ = asw_aggregate_pass(cv, wh_left, wh_right, axis=2, radius=radius, eps=eps)
        return ch, None

    out, _ = jax.lax.scan(body, cost, None, length=r_iters)
    return out
