"""Wavefront band pipeline for the cross-based method.

The plain band driver (models/tiled.cross_pipeline_tiled) recomputes a
3L+4-row influence halo of EVERY stage per band side; here band b hands
band b+1 strips sized by
each stage's own vertical reach, and every volume-stage row is computed
exactly once:

  * `temp` (OII horizontal pass output), 2L rows — feeds the OII
    vertical pass (reach L, `oii_vcross.cl`);
  * `initial` (WTA disparity map), 2L rows — feeds the histogram vote
    (reach L, `disparity.cl`);
  * `voted`, 2 rows — feeds the final median.

The cheap 2D stages (median, cross arms, SAD cost) recompute fresh from
the image slice — they are row-local and cost nothing next to the
D-plane volume stages.  Stage windows shift down by the consumer-chain
reach (temp 2L+1, initial L+1, voted 1 rows below the kept window) and
every window is an exact fit: no validity margins, no recompute.
Bit-identical to cross_pipeline with the translation-invariant taps OII
implementation (pinned by tests/test_wavefront.py).

Global-coordinate subtleties are inherited from the row-sharded tile
(parallel/cross_sharded.py, whose anchored helpers this module reuses):
arm walks test bounds in global rows, the OII row-quirk masks take
row0/h_glob, and frame-bottom overflow rows are materialised as
row-(H-1) replicas (the reference kernels' clamp reads).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .. import ops
from ..config import StereoConfig
from ..ops.oii import combined_arms
from ..parallel.cross_sharded import (_cross_arms_tiled, _oii_htaps,
                                      _oii_vtaps_tiled)


@dataclass(frozen=True)
class _GeomC:
    s: int       # first kept row
    e: int       # one past last kept row
    g0: int      # image slice start
    g1: int      # image slice end
    H: int       # frame height
    first: bool
    last: bool


def plan_bands_cross(H: int, num_bands: int, cfg: StereoConfig):
    """Band geometries, or None when bands are too short for the strips
    (the temp/initial strips are the last 2L rows of this band's fresh
    windows, and every stage window must start at a real row)."""
    L = cfg.arm_len
    if num_bands < 2 or H < 2 * num_bands:
        return None
    band = math.ceil(H / num_bands)
    n_min = 2 * L + 2
    edges = list(range(0, H, band)) + [H]
    geoms = []
    for i in range(len(edges) - 1):
        s, e = edges[i], edges[i + 1]
        first, last = i == 0, i == len(edges) - 2
        if not first and (e - s < n_min or s - 2 * L - 1 < 0):
            return None
        g0 = 0 if first else s - 2 * L - 1
        g1 = min(H, e + 3 * L + 3)
        geoms.append(_GeomC(s, e, g0, g1, H, first, last))
    return geoms if len(geoms) >= 2 else None


def _canon_c(g: _GeomC) -> _GeomC:
    """Slice-local translation: the band program bakes in only
    differences of geometry fields, so equal-shape interior bands share
    one jit/XLA cache entry.  When g1 is unclamped
    (g1 < H) the frame height folds to g1: the deepest read of any stage
    window is row e + 3L + 1 (arm walks below the temp window) < g1 =
    e + 3L + 3, so bottom masks and clamps are equal either way, and the
    frame-top mask arm is unreachable (plan keeps s - 2L - 1 >= 0)."""
    if g.first:
        return g
    o = g.g0
    H = (g.g1 if g.g1 < g.H else g.H) - o
    return _GeomC(g.s - o, g.e - o, 0, g.g1 - o, H, g.first, g.last)


def _pad_rows_edge(arr, n: int, axis: int):
    """Edge-replicate `n` rows at the end of `axis` (frame-bottom clamp)."""
    if n <= 0:
        return arr
    pads = [(0, 0)] * arr.ndim
    pads[axis] = (0, n)
    return jnp.pad(arr, pads, mode="edge")


def _fix_bottom(arr, first_virtual: int, axis: int = 0):
    """Rows at/past the frame bottom become row-(H-1) replicas — the
    clamp value every downstream read of them must see."""
    n = arr.shape[axis] - first_virtual
    if n <= 0:
        return arr
    real = lax.slice_in_dim(arr, 0, first_virtual, axis=axis)
    return _pad_rows_edge(real, n, axis)


def _cross_band_impl(l, r, strips, cfg: StereoConfig, geom: _GeomC):
    """One wavefront band.  l/r: image slice rows [g0, g1); strips: None
    for the first band, else dict(temp=(D, 2L, W), initial=(2L, W),
    voted=(2, W)) covering the rows just above each fresh window.
    Returns kept-row outputs and this band's strips (None for the last).
    """
    L, D = cfg.arm_len, cfg.num_disp
    s, e, g0, g1, H = geom.s, geom.e, geom.g0, geom.g1, geom.H
    N = e - s
    M = L + 1

    # Stage fresh windows (absolute rows): each sits its consumer-chain
    # reach below the kept window; the first band starts every window at
    # the frame top instead.
    t_lo = 0 if geom.first else s + 2 * L + 1      # OII-h (temp)
    i_lo = 0 if geom.first else s + L + 1          # OII-v + WTA (initial)
    v_lo = 0 if geom.first else s + 1              # vote (voted)
    t_hi, i_hi, v_hi = e + 2 * L + 1, e + L + 1, e + 1
    # 2D support windows.
    a_lo = 0 if geom.first else s + 1 - L          # arms
    a_hi = t_hi
    loc = lambda y: y - g0                          # slice-local row index

    # Virtual rows past the frame bottom: edge-replicated images make the
    # 2D stages' values there row-(H-1) replicas by construction.
    need = e + 3 * L + 3
    lp = _pad_rows_edge(l, need - g1, 0)
    rp = _pad_rows_edge(r, need - g1, 0)

    ml = ops.median3x3(lp)          # valid from row g0+1 on; row g0 is a
    mr = ops.median3x3(rp)          # slice-clamp row no stage consumes
    median_left = ml[loc(s):loc(e)]

    # Arms over [a_lo, a_hi) with the global in-bounds walk; the helper
    # computes arms for every row of its input with M margin rows of
    # median (the global mask kills frame-top taps, so the first band
    # needs no real margin above row 0).
    def arms_of(m):
        if geom.first:
            win = lax.slice_in_dim(m, 0, loc(a_hi) + M, axis=0)
            r0, lo = jnp.int32(0), 0
        else:
            win = lax.slice_in_dim(m, loc(a_lo) - M, loc(a_hi) + M, axis=0)
            r0, lo = jnp.int32(a_lo - M), M
        a = _cross_arms_tiled(win, 0, r0, H, L, cfg.tau,
                              cfg.legacy_cross_arm_quirk)
        return a[:, lo:lo + (a_hi - (0 if geom.first else a_lo))]

    arms_l = arms_of(ml)
    arms_r = arms_of(mr)
    asl = lambda arr, y0, y1: lax.slice_in_dim(     # arms rows [y0, y1)
        arr, y0 - a_lo, y1 - a_lo, axis=1)

    # SAD cost over the fresh temp window (cost.py [0,1] scale, as
    # cross_pipeline_impl).
    ml_w = lax.slice_in_dim(ml, loc(t_lo), loc(t_hi), axis=0)
    mr_w = lax.slice_in_dim(mr, loc(t_lo), loc(t_hi), axis=0)

    al_t, ar_t = asl(arms_l, t_lo, t_hi), asl(arms_r, t_lo, t_hi)
    cost = ops.sad_cost_volume(ml_w, mr_w, D)
    hm, hp = combined_arms(al_t, ar_t, D, plane_minus=0, plane_plus=1)
    temp_fresh = _oii_htaps(cost, hm, hp, L)

    # temp rows [i_lo - L, t_hi): previous band's strip + fresh rows (the
    # first band has no rows above the frame top to seed).
    temp = (temp_fresh if geom.first else
            jnp.concatenate([strips["temp"], temp_fresh], axis=1))
    alc, arc = asl(arms_l, i_lo, i_hi), asl(arms_r, i_lo, i_hi)
    vm, vp = combined_arms(alc, arc, D, plane_minus=2, plane_plus=3)
    # Uniform halo=L form: the first band gets L zero rows on top, which
    # the global row-quirk mask (r >= 1) never reads.
    tin = jnp.pad(temp, [(0, 0), (L, 0), (0, 0)]) if geom.first else temp
    aggr = _oii_vtaps_tiled(tin, vm, vp, L, L, jnp.int32(i_lo), H)

    initial_fresh = ops.disparity_to_image(ops.wta_argmin(aggr),
                                           cfg.d_max, cfg.quantize_maps)
    initial_fresh = _fix_bottom(initial_fresh, H - i_lo)

    # initial rows [v_lo - L, i_hi).
    initial = (initial_fresh if geom.first else
               jnp.concatenate([strips["initial"], initial_fresh], axis=0))
    al_vote = asl(arms_l, v_lo - L if not geom.first else 0, i_hi)
    # Rows at/past the frame bottom must vote with row-(H-1)'s ARMS, not
    # the virtual rows' own walks: disparity.cl samples the arms image
    # with the same CLAMP_TO_EDGE as the disparity (the virtual rows'
    # median values are row-(H-1) replicas, but their arm WALKS see
    # different neighbours at each distance).  Replicate the arm rows
    # exactly like the values.
    al_vote = _fix_bottom(al_vote, H - (0 if geom.first else v_lo - L),
                          axis=1)
    # The taps vote clamps row reads at its input edges — the frame top
    # for the first band; interior bands' centre rows never reach the
    # window edge (L margin rows on each side).
    voted_win = ops.histogram_vote(initial, al_vote, cfg.d_max,
                                   quantize=cfg.quantize_maps,
                                   arm_len=L, impl="taps")
    voted_fresh = lax.slice_in_dim(voted_win, 0 if geom.first else L,
                                   None, axis=0)
    voted_fresh = lax.slice_in_dim(voted_fresh, 0, v_hi - v_lo, axis=0)
    voted_fresh = _fix_bottom(voted_fresh, H - v_lo)

    # voted rows [s - 1, v_hi) — exactly the final median's reach.
    voted = (voted_fresh if geom.first else
             jnp.concatenate([strips["voted"], voted_fresh], axis=0))
    final = ops.median3x3(voted)

    off_i = s - (0 if geom.first else v_lo - L)
    off_f = s - (0 if geom.first else s - 1)
    out = {
        "initial": lax.slice_in_dim(initial, off_i, off_i + N, axis=0),
        "final": lax.slice_in_dim(final, off_f, off_f + N, axis=0),
        "median_left": median_left,
    }
    if geom.last:
        return out, None
    return out, {"temp": temp[:, -2 * L:],
                 "initial": initial[-2 * L:],
                 "voted": voted[-2:]}


@partial(jax.jit, static_argnums=(2, 3))
def _first_band_c(l, r, cfg, geom):
    return _cross_band_impl(l, r, None, cfg, geom)


@partial(jax.jit, static_argnums=(3, 4), donate_argnums=(2,))
def _mid_band_c(l, r, strips, cfg, geom):
    return _cross_band_impl(l, r, strips, cfg, geom)


@partial(jax.jit, static_argnums=(3, 4))
def _last_band_c(l, r, strips, cfg, geom):
    # No donation: the last band emits no strips, so the donated input
    # would have no output to alias (XLA warns and ignores).
    return _cross_band_impl(l, r, strips, cfg, geom)


def cross_wavefront_supported(left_shape, cfg: StereoConfig,
                              num_bands: int) -> bool:
    H = left_shape[0]
    return plan_bands_cross(H, num_bands, cfg) is not None


def cross_pipeline_wavefront(left, right, cfg: StereoConfig,
                             num_bands: int):
    """Banded cross-method run with inter-band strip carry; returns
    (initial, final), bit-identical to cross_pipeline with the
    translation-invariant taps OII implementation.  At most two bands
    are in flight (bounding live device memory, as models/tiled)."""
    if cfg.median_dispatch_quirk:
        raise ValueError(
            "median_dispatch_quirk models the reference's truncated "
            "full-frame Median dispatches (golden comparisons only) and "
            "is not implemented by the banded driver; use cross_pipeline")
    H = left.shape[0]
    geoms = plan_bands_cross(H, num_bands, cfg)
    if geoms is None:
        raise ValueError(
            f"cross wavefront layout unsupported at H={H}, "
            f"num_bands={num_bands}; use models/tiled.cross_pipeline_tiled")
    pieces = []
    strips = None
    prev = None
    for g in geoms:
        l_sl, r_sl = left[g.g0:g.g1], right[g.g0:g.g1]
        gc = _canon_c(g)
        if g.first:
            out, strips = _first_band_c(l_sl, r_sl, cfg, gc)
        elif g.last:
            out, strips = _last_band_c(l_sl, r_sl, strips, cfg, gc)
        else:
            out, strips = _mid_band_c(l_sl, r_sl, strips, cfg, gc)
        # Wait for band b-1 only after dispatching band b: at most two
        # bands' transients are live, and the device never idles between
        # bands.
        if prev is not None:
            jax.block_until_ready(prev)
        prev = out["final"]
        pieces.append(out)
    initial = jnp.concatenate([p["initial"] for p in pieces], axis=0)
    final = jnp.concatenate([p["final"] for p in pieces], axis=0)
    return initial, final
