"""End-to-end golden regression: pipelines vs. the reference's committed
artifacts (SURVEY.md §4.1).  Thresholds are set from measured round-1
fidelity (cross initial 99.8% exact / ASW final 99.75% exact on tsukuba)
with slack for float reassociation; real regressions blow well past them.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from stereo_matchin_tpu import REFERENCE_CONFIG
from stereo_matchin_tpu.eval import compare_to_golden
from stereo_matchin_tpu.io import get_pair, load_pair
from stereo_matchin_tpu.models import asw, cross_based

pytestmark = pytest.mark.skipif(
    not get_pair("tsukuba").exists(), reason="reference checkout not mounted"
)


@pytest.fixture(scope="module")
def tsukuba():
    left, right = load_pair("tsukuba")
    return jnp.asarray(left), jnp.asarray(right)


def test_cross_pipeline_matches_goldens(tsukuba):
    """Tsukuba cross goldens are the PRISTINE originals (the mount was
    refreshed before round 3; the manifest pins them).  Measured after
    the round-3 unorm8 ties-toward-zero fix (the reference device's
    UNORM8 write rounding — see ops/common.py): initial 99.82% exact in
    8-BIT space / bad2 0.10%, final 99.71% exact / bad2 0.21%.  The
    final map's former ~2.8% one-level vote spread was entirely the tie
    rounding feeding the vote; thresholds sit just below measured."""
    left, right = tsukuba
    res = cross_based.cross_pipeline(left, right, REFERENCE_CONFIG)
    initial = compare_to_golden(np.asarray(res.initial), "tsukuba",
                                "cross_based_initial.png")
    final = compare_to_golden(np.asarray(res.final), "tsukuba",
                              "cross_based_disparity.png")
    assert initial.exact_pct > 99.5, initial
    assert initial.bad2_pct < 0.3, initial
    assert final.exact_pct > 99.3, final
    assert final.bad2_pct < 0.4, final


def test_asw_pipeline_matches_goldens(tsukuba):
    """Bit-perfect since the unorm8 tie fix: measured 100.00% exact /
    bad2 0.000 (CPU)."""
    left, right = tsukuba
    res = asw.asw_pipeline(left, right, REFERENCE_CONFIG)
    final = compare_to_golden(np.asarray(res.disparity), "tsukuba",
                              "asw_disparity.png")
    assert final.exact_pct > 99.9, final
    assert final.bad2_pct < 0.05, final


def test_asw_consistency_diagnostics_match_goldens(tsukuba):
    """The red-marked consistency diagnostics (consist.cl's diagnostic
    image, dumped pre- and post-refinement at main.cpp:625-631) are
    PIXEL-EXACT against the committed goldens since the unorm8 tie fix —
    every channel of every pixel, including which pixels are red."""
    from PIL import Image

    from stereo_matchin_tpu.eval.metrics import golden_path

    left, right = tsukuba
    res = asw.asw_pipeline(left, right, REFERENCE_CONFIG)
    for name, got in (("asw_consistency_pre-reff.png", res.consistency_pre),
                      ("asw_consistency_post-reff.png",
                       res.consistency_post)):
        gold = np.asarray(Image.open(golden_path("tsukuba", name))
                          .convert("RGB")).astype(np.int32)
        g = np.round(np.asarray(got) * 255).astype(np.int32)
        exact = float((np.abs(g - gold).max(axis=2) == 0).mean())
        assert exact > 0.999, f"{name}: pixel-exact {exact:.4f}"


@pytest.mark.slow
@pytest.mark.parametrize("pair", ["teddy", "cones", "art", "laundry"])
def test_asw_other_pairs(pair):
    """Measured round 3 (CPU, after the unorm8 tie fix): exact
    99.90-100.00% / bad2 <= 0.011 on all four pairs."""
    left, right = load_pair(pair)
    res = asw.asw_pipeline(jnp.asarray(left), jnp.asarray(right),
                           REFERENCE_CONFIG)
    final = compare_to_golden(np.asarray(res.disparity), pair,
                              "asw_disparity.png")
    assert final.exact_pct > 99.7, f"{pair}: {final}"
    assert final.bad2_pct < 0.1, f"{pair}: {final}"


@pytest.mark.slow
@pytest.mark.parametrize("pair", ["teddy", "cones", "art", "laundry"])
def test_cross_other_pairs(pair):
    """Cross-method goldens on the other four pairs (all pristine).

    Run with median_dispatch_quirk: the reference's Median work-group
    count uses integer division inside ceil (main.cpp:193), so the
    bottom H mod 3 rows of its uninitialized median images are never
    written (zero on the golden device) — a no-op for teddy/cones/
    laundry (heights divide by 3) and the round-3 'art residual' in
    full: art initial went 98.91% -> 99.90% exact with the quirk
    modeled.  Measured round 4 (CPU, prefix impl): initial exact
    99.68-99.76 / bad2 <= 0.12; final exact 99.63-99.81 / bad2 <= 0.30
    across the four pairs.

    Round 5: EVERY residual below these thresholds is measured
    irreducible, on all five pairs (scratch/adjudicate_cross.py;
    numbers pinned in PARITY.md quality section):
      * initial diffs (taps impl 0.08-0.21%/pair) are float-order
        argmin ties — relative cost margin p50 = 0 (bit-equal), 100%
        <= 1.3e-4, and our winner's cost <= the golden winner's on
        100% of them;
      * final diffs are 100% PROPAGATION of those initial ties: our
        vote+median tail applied to the GOLDEN initial image
        reproduces the golden final BIT-EXACTLY (0 diffs on all five
        pairs) — the tail itself has no divergence at all."""
    left, right = load_pair(pair)
    cfg = REFERENCE_CONFIG.replace(median_dispatch_quirk=True)
    res = cross_based.cross_pipeline(jnp.asarray(left), jnp.asarray(right),
                                     cfg)
    initial = compare_to_golden(np.asarray(res.initial), pair,
                                "cross_based_initial.png")
    final = compare_to_golden(np.asarray(res.final), pair,
                              "cross_based_disparity.png")
    assert initial.exact_pct > 99.6, f"{pair}: {initial}"
    assert initial.bad2_pct < 0.2, f"{pair}: {initial}"
    assert final.exact_pct > 99.5, f"{pair}: {final}"
    assert final.bad2_pct < 0.4, f"{pair}: {final}"


def test_cross_staged_matches_fused(tsukuba):
    from stereo_matchin_tpu.models.cross_based import (
        cross_pipeline_fused, cross_pipeline_staged)

    left, right = tsukuba
    fused = cross_pipeline_fused(left, right, REFERENCE_CONFIG)
    staged = cross_pipeline_staged(left, right, REFERENCE_CONFIG)
    np.testing.assert_array_equal(np.asarray(staged.initial),
                                  np.asarray(fused.initial))
    np.testing.assert_array_equal(np.asarray(staged.final),
                                  np.asarray(fused.final))
