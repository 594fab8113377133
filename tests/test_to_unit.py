"""Regression tests for the compiler-stable disparity rescaling.

A sharded-vs-unsharded output divergence was root-caused to runtime
`x / d_max` divisions on output paths.  One source expression was
measured compiling to THREE different value semantics by context (true
divide / reciprocal multiply / folded reciprocal), and a backend may
lower the `divide` HLO itself to a reciprocal-Newton approximation — so
NO division-based form can be both context- and backend-stable.  The fix (ops/common.py) is division-free:

  * `disparity_to_image`: integer disparity -> UNORM8 image value via an
    exact int32 multiply-shift for the code (trace-time-verified against
    the golden host-IEEE chain) + the closed-form level;
  * `image_from_q`: quantized [0, d_max] value -> exact level via one
    multiply + never-near-a-boundary round + closed-form level;
  * `to_unit`: the remaining raw rescales as ONE explicit constant
    multiply (deterministic everywhere; not for unorm8-feeding paths).

These tests pin the three value contracts, their stability across
jit/eager/vmap/scan/fusion, and that no raw `/ d_max` division survives
on any runtime path in the package.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_matchin_tpu import ops
from stereo_matchin_tpu.ops.common import _disp_code_params, _golden_codes

REPO = pathlib.Path(__file__).resolve().parents[1]

D_MAXES = [15, 23, 59, 60, 255, 280, 299]


def _golden_levels(d_max):
    """unorm8 level of every integer disparity, via the host-IEEE chain
    the committed maps pin (numpy true division; codes then correctly
    rounded k/255 computed in f64)."""
    k = _golden_codes(d_max)
    return (k.astype(np.float64) / 255.0).astype(np.float32)


@pytest.mark.parametrize("d_max", D_MAXES)
def test_disparity_to_image_matches_golden_chain(d_max):
    d = jnp.arange(d_max + 1, dtype=jnp.float32)
    want = _golden_levels(d_max)
    got_eager = np.asarray(ops.disparity_to_image(d, d_max))
    got_jit = np.asarray(jax.jit(
        lambda v: ops.disparity_to_image(v, d_max))(d))
    got_int = np.asarray(ops.disparity_to_image(
        jnp.arange(d_max + 1, dtype=jnp.int32), d_max))
    np.testing.assert_array_equal(got_eager, want)
    np.testing.assert_array_equal(got_jit, want)
    np.testing.assert_array_equal(got_int, want)


def test_disparity_to_image_pins_the_golden_ties():
    """d_max=60 stores byte 110 at d=26 (fl(fl(26/60)*255) = 110.5
    exactly, ties toward zero) — the tie the reciprocal-multiply rewrite
    breaks (-> 111) and the committed maps pin at every d = 2 mod 4."""
    d = jnp.arange(61, dtype=jnp.float32)
    got = np.round(np.asarray(jax.jit(
        lambda v: ops.disparity_to_image(v, 60))(d)) * 255).astype(int)
    assert got[26] == 110
    np.testing.assert_array_equal(got, _golden_codes(60))


@pytest.mark.parametrize("d_max", [23, 60, 280])
def test_disparity_to_image_stable_across_contexts(d_max):
    d = jnp.tile(jnp.arange(d_max + 1, dtype=jnp.float32), 4).reshape(4, -1)
    want = np.asarray(jax.jit(lambda v: ops.disparity_to_image(v, d_max))(d))
    fused = jax.jit(lambda v: jnp.tanh(v * 3.0) * 0
                    + ops.disparity_to_image(v, d_max))
    vmapped = jax.jit(jax.vmap(lambda v: ops.disparity_to_image(v, d_max)))
    scanned = jax.jit(lambda v: jax.lax.scan(
        lambda c, row: (c, ops.disparity_to_image(row, d_max)), 0, v)[1])
    for f in (fused, vmapped, scanned):
        np.testing.assert_array_equal(np.asarray(f(d)), want)


def test_mulshift_params_exist_and_are_exact():
    """The exact multiply-shift exists for every d_max the search was
    swept over (1..2048 offline); spot-check a spread here, including
    the exhaustive code equality the trace-time assert enforces."""
    for d_max in [1, 2, 7, 15, 23, 60, 61, 255, 256, 280, 299, 1024, 2048]:
        params = _disp_code_params(d_max)
        assert params is not None, d_max
        A, B, S = params
        d = np.arange(d_max + 1, dtype=np.int64)
        np.testing.assert_array_equal((A * d + B) >> S, _golden_codes(d_max))


@pytest.mark.parametrize("d_max", D_MAXES)
def test_image_from_q_recovers_exact_levels(d_max):
    levels = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)
    q = (levels * np.float32(d_max)).astype(np.float32)  # the grid values
    got = np.asarray(jax.jit(lambda v: ops.image_from_q(v, d_max))(
        jnp.asarray(q)))
    np.testing.assert_array_equal(got, levels)
    got_eager = np.asarray(ops.image_from_q(jnp.asarray(q), d_max))
    np.testing.assert_array_equal(got_eager, levels)


@pytest.mark.parametrize("d_max", D_MAXES)
def test_to_unit_is_the_explicit_reciprocal_multiply(d_max):
    rng = np.random.default_rng(7)
    x = (rng.random(512, dtype=np.float32) * d_max).astype(np.float32)
    want = x * (np.float32(1.0) / np.float32(d_max))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda v: ops.to_unit(v, d_max))(jnp.asarray(x))),
        want)
    np.testing.assert_array_equal(
        np.asarray(ops.to_unit(jnp.asarray(x), d_max)), want)


def test_quantize_disparity_roundtrip():
    for d_max in (23, 60, 280):
        d = jnp.arange(d_max + 1, dtype=jnp.float32)
        got = np.asarray(jax.jit(
            lambda v: ops.quantize_disparity(v, d_max))(d))
        want = _golden_levels(d_max) * np.float32(d_max)
        np.testing.assert_array_equal(got, want)


_DIV_RE = re.compile(r"/\s*\(?\s*(cfg\s*\.\s*)?d_max\b")


def test_no_raw_dmax_division_survives():
    """Structural pin: outside ops/common.py (where the helpers live), no runtime source line
    divides by d_max.  Comment and string/docstring tokens are stripped
    with the tokenize module first, so only real code can match."""
    import io
    import tokenize

    offenders = []
    files = list((REPO / "stereo_matchin_tpu").rglob("*.py"))
    files += [REPO / "__graft_entry__.py", REPO / "bench.py"]
    for path in files:
        if path.name == "common.py" and path.parent.name == "ops":
            continue
        src = path.read_text()
        code_lines = {}
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type in (tokenize.STRING, tokenize.COMMENT):
                continue
            if tok.start[0] == tok.end[0]:
                code_lines.setdefault(tok.start[0], []).append(tok.string)
        for ln in sorted(code_lines):
            code = " ".join(code_lines[ln])
            if _DIV_RE.search(code):
                offenders.append(f"{path.relative_to(REPO)}:{ln}: {code.strip()}")
    assert not offenders, "raw / d_max division on a runtime path:\n" + \
        "\n".join(offenders)
