"""Shared array helpers for the stereo ops.

These encode the reference's OpenCL sampler semantics
(CLK_ADDRESS_CLAMP_TO_EDGE nearest-neighbour, main.cpp:10) and the
UNORM8 image round-trips (write_imagef to CL_UNORM_INT8 images) as
pure, jit-friendly JAX functions with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# k/255 for every 8-bit code, correctly rounded to f32 (computed in f64).
# Constants make the UNORM8 read-back value compiler-stable: a runtime
# x/255 is rewritten to x*(1/255) by some XLA backends (1-ulp different
# for some k), so two differently-fused programs disagreed at the ulp.
_UNORM8_LEVELS = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)


def shift2d(img: jax.Array, dy: int, dx: int) -> jax.Array:
    """out[y, x] = img[clamp(y+dy), clamp(x+dx)] with clamp-to-edge.

    Works on (H, W) or (H, W, C) arrays; dy/dx are static Python ints.
    """
    H, W = img.shape[0], img.shape[1]
    out = img
    if dy:
        out = jnp.pad(out, [(max(-dy, 0), max(dy, 0))] + [(0, 0)] * (out.ndim - 1), mode="edge")
        lo = dy + max(-dy, 0)
        out = jax.lax.slice_in_dim(out, lo, lo + H, axis=0)
    if dx:
        out = jnp.pad(out, [(0, 0)] + [(max(-dx, 0), max(dx, 0))] + [(0, 0)] * (out.ndim - 2), mode="edge")
        lo = dx + max(-dx, 0)
        out = jax.lax.slice_in_dim(out, lo, lo + W, axis=1)
    return out


def shift_axis(x: jax.Array, shift: int, axis: int) -> jax.Array:
    """out[..., i, ...] = x[..., clamp(i+shift), ...] (clamp-to-edge), static shift."""
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (max(-shift, 0), max(shift, 0))
    out = jnp.pad(x, pad, mode="edge")
    lo = shift + max(-shift, 0)
    return jax.lax.slice_in_dim(out, lo, lo + n, axis=axis)


def disparity_columns(width: int, num_disp: int, d0=0) -> jax.Array:
    """(num_disp, width) int32 index max(x - (d0 + d), 0): the column of
    the right image that left column x reads at disparity d0 + d — the
    reference's clamp-to-edge lookup `max(0, pos.x - pos.z)` (e.g.
    asw_vcost_aggregation.cl:353, oii_hcross.cl:874).  d0 may be traced."""
    xs = jnp.arange(width, dtype=jnp.int32)[None, :]
    ds = d0 + jnp.arange(num_disp, dtype=jnp.int32)[:, None]
    return jnp.maximum(xs - ds, 0)


def stack_shift_x(x: jax.Array, num_disp: int, x_axis: int = 1,
                  d0=0) -> jax.Array:
    """Stack left-shifted, edge-clamped copies along a new leading axis.

    out[d, ..., xpos, ...] = x[..., max(xpos - (d0 + d), 0), ...] for d in
    [0, num_disp).  One gather, whatever num_disp is: a stack of
    num_disp static slices grows the program (and its compile time) with
    the disparity count.
    """
    idx = disparity_columns(x.shape[x_axis], num_disp, d0)
    return jnp.moveaxis(jnp.take(x, idx, axis=x_axis), x_axis, 0)


def unorm8(v: jax.Array) -> jax.Array:
    """Round-trip a [0,1] float through an 8-bit UNORM image channel.

    Rounds to nearest with ties TOWARD ZERO — the measured conversion
    behavior of the device that produced the reference artifacts.  The
    d/60 disparity grid hits exact 8-bit halves at every d ≡ 2 (mod 4)
    (d*255/60 = k + 0.5 exactly, and the f32 chain d/60*255 rounds onto
    that tie), so the tie rule is visible in every committed map:
    diffing our initial cross maps against the goldens (reference
    init_disparity.cl:18 writes d/60 to a CL_UNORM_INT8 image), 100% of
    the one-8-bit-unit disagreements sat at d ≡ 6 (mod 8) with our
    value one ABOVE — i.e. round-half-even (jnp.round) goes up at odd
    floors (25.5 -> 26) where the reference device goes down (-> 25),
    while both go down at even floors (8.5 -> 8).  Ties-down matches
    the goldens on all d classes (measured: tsukuba initial exact
    94.7% -> 99.99% in 8-bit space).

    Implementation note (round 4): the obvious `ceil(v*255 - 0.5)/255`
    is NOT compiler-stable — measured on XLA:CPU, (a) the mul-sub chain
    contracts into a single-rounded FMA under jit (2563 of 4096 pixels
    flipped between the jitted and eager programs at d_max=23: the tie
    the golden semantics depend on exists in fl(v*255), not in the
    infinitely-precise v*255 - 0.5), and (b) the final /255 is rewritten
    to *(1/255), 1 ulp off fl(k/255) for some k.  So (a) round fl(v*255)
    with exact arithmetic only — floor() is exact, t - floor(t) is exact
    (Sterbenz for t >= 1; trivially for t < 1), the compare carries no
    rounding, and no mul+add chain remains to contract — and (b) compute
    the correctly rounded fl(k/255) in closed form (the OpenCL UNORM8
    read-back semantics, clamp included):

        m = k * 65793                # 255 * 65793 = 2^24 - 1, so
                                     # m / (2^24 - 1) == k / 255 exactly
        base = float(m) * 2^-24      # EXACT: m <= 2^24 - 1 and the
                                     # power-of-two scale is lossless
        k/255 = base * (1 + 2^-24 + 2^-48 + ...), and the residual
        beyond base is m * 2^-48 * (1 + ...) — strictly between 0.5
        and 1 ulp of base for EVERY k >= 1 (r/ulp = m * 2^-b for m of
        b bits, in (0.5, 1) since m is never a power of two: 65793 is
        odd) — so fl(k/255) is exactly ONE integer-bitcast increment
        above base, including the k=255 exponent crossing
        (0x3F7FFFFF + 1 = 1.0f).

    Every step is a single exact op (int multiply, int->float of a
    24-bit value, one power-of-two multiply, integer bitcast add): no
    mul+add chain for FMA contraction, no division for a reciprocal
    rewrite, and — unlike the 256-entry gather this replaced — it fuses
    into the surrounding elementwise fusion (the gather lowered to a
    ~17x-slower loop inside the ASW refinement k-loop: profiler-traced
    76.9 vs 4.5 ms per config-3 band fusion).  Verified equal to the
    correctly-rounded table on all 256 k and bit-identical to the
    oracle's eager ceil form on the full [0,1] f32 grid sweep."""
    return unorm8_level(unorm8_code(v))


def unorm8_code(v: jax.Array) -> jax.Array:
    """[0,1] float -> int32 8-bit code, ties toward zero (the rounding
    half of `unorm8`; see its docstring for the exact-arithmetic
    argument: floor is exact, t - floor(t) is exact, the compare carries
    no rounding)."""
    t = v * 255.0
    f = jnp.floor(t)
    return jnp.clip(f + (t - f > 0.5), 0, 255).astype(jnp.int32)


def unorm8_level(k: jax.Array) -> jax.Array:
    """int32 code k in [0, 255] -> correctly rounded fl32(k/255), the
    closed-form half of `unorm8` (see its docstring): every step exact,
    nothing for a compiler to contract or rewrite."""
    base = (k * 65793).astype(jnp.float32) * jnp.float32(2.0 ** -24)
    bits = jax.lax.bitcast_convert_type(base, jnp.int32) + (k > 0)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def to_unit(d: jax.Array, d_max) -> jax.Array:
    """Deterministic `d / d_max` for NON-quantized [0,1] rescales.

    A literal runtime division by a non-power-of-two constant is NOT
    stable across compilation contexts: sharded and unsharded ASW
    outputs once diverged by exactly 2^-24 on 16.2% of pixels because of
    it (XLA:CPU).  One source expression `x / d_max` compiles to THREE
    different value semantics: (1) a true IEEE divide, (2) the
    simplifier's x*(1/d_max) rewrite, (3) the rewrite with the
    reciprocal constant-folded into a downstream constant multiply —
    and which fires depends on fusion context.  Forcing (1) with an
    optimization_barrier'd divisor is NOT the answer either: a backend
    may lower `divide` to a reciprocal-Newton approximation rather than
    IEEE division.

    The resolution splits by use:
      * GOLDEN-SEMANTICS conversions (integer disparity -> stored UNORM8
        image value) never divide at all — `disparity_to_image` computes
        the 8-bit code with exact integer arithmetic and reconstructs
        the level in closed form; `image_from_q` recovers levels from
        quantized [0, d_max] values.  Backend-independent, context-
        independent, bit-equal to the golden encoding.
      * This helper covers the remaining RAW rescales (quantize_maps=
        False fast mode, diagnostic scalings): ONE explicit multiply by
        the trace-time fl32(1/d_max).  A single constant multiply has
        the same bits in every context and on every backend.  Do NOT
        feed its result into another constant multiply chain (e.g.
        unorm8's *255) — that re-opens the constant-fold ambiguity
        (class 3 above); quantized paths must use the helpers above.
    tests/test_to_unit.py pins all three contracts and that no raw
    `/ d_max` division survives anywhere in the package.
    """
    return d * np.float32(np.float32(1.0) / np.float32(d_max))


# (A, B, S) multiply-shift parameters per d_max — see _disp_code_params.
_DISP_CODE_CACHE: dict = {}


def _golden_codes(d_max: int) -> np.ndarray:
    """The 8-bit code of every integer disparity, in the GOLDEN device's
    semantics: k = round-ties-toward-zero(fl32(fl32(d / d_max) * 255))
    with a true IEEE division — computed on the HOST with numpy, where
    division is correctly rounded by definition.  The committed maps pin
    this chain: e.g. d_max=60 stores byte 110 at d=26 (fl(fl(26/60)*255)
    = 110.5 exactly, tie toward zero), which reciprocal-multiply forms
    break (-> 111)."""
    d = np.arange(d_max + 1, dtype=np.float32)
    v = d / np.float32(d_max)
    t = v * np.float32(255.0)
    f = np.floor(t)
    return np.clip(f + (t - f > np.float32(0.5)), 0, 255).astype(np.int64)


def _disp_code_params(d_max: int):
    """Integer multiply-shift (A, B, S) with (A*d + B) >> S equal to
    _golden_codes(d_max)[d] for EVERY integer d in [0, d_max] —
    exhaustively verified here at trace time (search succeeds for every
    d_max in [1, 2048]; tests/test_to_unit.py re-checks a spread).
    Returns None if no triple exists (then callers gather from the
    level table instead)."""
    if d_max in _DISP_CODE_CACHE:
        return _DISP_CODE_CACHE[d_max]
    k = _golden_codes(d_max)
    d = np.arange(d_max + 1, dtype=np.int64)
    params = None
    for S in range(14, 27):
        A0 = int(round(255 / d_max * 2 ** S))
        for A in (A0 - 1, A0, A0 + 1):
            if A <= 0 or A * d_max >= 2 ** 31 - 2 ** S:
                continue
            b_lo = int(((k << S) - A * d).max())
            b_hi = int((((k + 1) << S) - A * d - 1).min())
            if b_lo <= b_hi and b_lo >= 0 and A * d_max + b_lo < 2 ** 31:
                params = (A, b_lo, S)
                break
        if params:
            break
    if params is not None:
        A, B, S = params
        assert (((A * d + B) >> S) == k).all(), (d_max, params)
    _DISP_CODE_CACHE[d_max] = params
    return params


def disparity_to_image(d: jax.Array, d_max: int,
                       quantize: bool = True) -> jax.Array:
    """Store an INTEGER-VALUED disparity (WTA argmin / vote mode index on
    the [0, d_max] scale) as the reference's UNORM8 image value — the
    compiler- and backend-stable replacement for `unorm8(d / d_max)`
    (see to_unit's docstring for the full instability story).

    quantize=True: the 8-bit code comes from exact int32 arithmetic
    ((A*d + B) >> S, trace-time-verified against the golden host-IEEE
    chain), the level from unorm8's closed form — every op exact, so
    every backend and every fusion context produces the same bits, and
    they are the GOLDEN bits (init_disparity.cl:18 / disparity.cl
    semantics).  quantize=False: the raw multiply rescale (to_unit).
    """
    if not quantize:
        return d * np.float32(1.0 / np.float32(d_max))
    if jnp.issubdtype(jnp.result_type(d), jnp.floating):
        di = jnp.round(d).astype(jnp.int32)
    else:
        di = d.astype(jnp.int32)
    di = jnp.clip(di, 0, d_max)
    params = _disp_code_params(d_max)
    if params is None:  # no exact mul-shift (never for d_max <= 2048)
        table = jnp.asarray(_UNORM8_LEVELS[_golden_codes(d_max)])
        return jnp.take(table, di)
    A, B, S = params
    return unorm8_level((di * jnp.int32(A) + jnp.int32(B)) >> S)


def image_from_q(q: jax.Array, d_max: int) -> jax.Array:
    """Recover the exact UNORM8 image value from a disparity on the
    QUANTIZED [0, d_max] grid — the values the quantized pipelines carry
    (every element is unorm8_level(k) * d_max for some code k, e.g. the
    consistency-filled map).  Replaces the output-boundary `q / d_max`
    (the exact site of the sharded-vs-unsharded 1-ulp divergence).

    The code is recovered by one multiply + round: with q =
    fl(fl(k/255)*d_max) and c = fl(255/d_max), the relative error of
    q*c vs k is < 4 ulp, i.e. |q*c - k| < 255 * 2^-22 ~ 6e-5 << 0.5 —
    the round is never near a boundary, so a 1-ulp wobble in the
    multiply cannot change it.  The level is then closed-form exact."""
    c = np.float32(np.float32(255.0) / np.float32(d_max))
    k = jnp.clip(jnp.round(q * c), 0, 255).astype(jnp.int32)
    return unorm8_level(k)


def quantize_disparity(d: jax.Array, d_max: int, enabled: bool = True) -> jax.Array:
    """Round-trip an integer-valued disparity (in [0, d_max] units)
    through a UNORM8 image.

    The reference stores every disparity map as d/d_max in a CL_UNORM_INT8
    image and reads it back multiplied by d_max (e.g. asw_wta.cl:466-470,
    consist.cl:564-565).  Returns the value on the [0, d_max] scale.
    """
    if not enabled:
        return d
    return disparity_to_image(d, d_max) * d_max


def in_bounds_mask(H: int, W: int, dy: int, dx: int, dtype=jnp.bool_) -> jax.Array:
    """Mask of pixels whose (y+dy, x+dx) neighbour lies inside the image."""
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    ok_y = (ys + dy >= 0) & (ys + dy <= H - 1)
    ok_x = (xs + dx >= 0) & (xs + dx <= W - 1)
    return (ok_y & ok_x).astype(dtype)
