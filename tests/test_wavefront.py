"""Wavefront-banded vs full-frame equality for the cross method
(models/wavefront_cross.py): bit-identical to the full-frame run with the
translation-invariant taps OII implementation."""

import numpy as np
import pytest

import jax.numpy as jnp

from stereo_matchin_tpu import StereoConfig

# --- cross method ---------------------------------------------------------

from stereo_matchin_tpu.models import cross_based
from stereo_matchin_tpu.models.wavefront_cross import (
    cross_pipeline_wavefront, cross_wavefront_supported, plan_bands_cross)

CROSS_CFG = StereoConfig(d_max=7, radius=2, arm_len=3, r_iters=2, k_iters=2)


@pytest.fixture(scope="module")
def cross_pair():
    rng = np.random.default_rng(21)
    left = (rng.integers(0, 256, (96, 40, 3)) / np.float32(255.0)).astype(
        np.float32)
    right = np.roll(left, -2, axis=1)
    noise = rng.integers(-10, 11, right.shape) / np.float32(255.0)
    right = np.clip(np.round((right + noise) * 255) / 255.0, 0, 1).astype(
        np.float32)
    return jnp.asarray(left), jnp.asarray(right)


@pytest.mark.parametrize("bands", [2, 3, 4, 5, 6])
def test_cross_wavefront_matches_full_taps(cross_pair, bands):
    left, right = cross_pair
    cfg = CROSS_CFG.replace(oii_impl="taps")
    assert cross_wavefront_supported(left.shape, cfg, bands)
    full = cross_based.cross_pipeline(left, right, cfg)
    initial, final = cross_pipeline_wavefront(left, right, cfg, bands)
    np.testing.assert_array_equal(np.asarray(initial),
                                  np.asarray(full.initial))
    np.testing.assert_array_equal(np.asarray(final), np.asarray(full.final))


def test_cross_wavefront_non_dividing_last_band(cross_pair):
    left, right = cross_pair
    left, right = left[:91], right[:91]
    cfg = CROSS_CFG.replace(oii_impl="taps")
    assert plan_bands_cross(91, 4, cfg) is not None
    full = cross_based.cross_pipeline(left, right, cfg)
    initial, final = cross_pipeline_wavefront(left, right, cfg, 4)
    np.testing.assert_array_equal(np.asarray(initial),
                                  np.asarray(full.initial))
    np.testing.assert_array_equal(np.asarray(final), np.asarray(full.final))


def _bottom_detail_scene(H=64, W=48, seed=5):
    """A seeded pair whose last rows carry horizontal detail at the arm
    threshold tau = 0.1: colour steps of 0.08-0.12 between neighbouring
    columns, so arm walks stop or continue depending on which rows the
    median mixed in.  Above them, the smooth synthetic texture."""
    from stereo_matchin_tpu.eval import synthetic_scene

    rng = np.random.default_rng(seed)
    left, right, _, _ = synthetic_scene(rng, H, W, 6)
    steps = rng.choice([-1, 1], (4, W, 1)) * rng.uniform(0.08, 0.12,
                                                         (4, W, 3))
    rows = 0.5 + np.cumsum(steps, axis=1) % 0.4
    rows = np.round(rows * 255) / 255.0
    left[-4:] = rows
    right[-4:] = np.roll(rows, -2, axis=1)
    return jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32)


@pytest.mark.parametrize("bands", [2, 3])
def test_cross_wavefront_bottom_clamp_arms(bands):
    """Frame-bottom vote rows must use row-(H-1)'s ARMS for clamped
    reads — disparity.cl samples the arms image with the same
    CLAMP_TO_EDGE as the disparity map, while a virtual (replicated)
    row's own arm walk sees different neighbours at each distance.

    The trigger needs near-tau detail in the true bottom rows: the median
    of edge-replicated raw rows is not a replicated median, so the
    virtual rows' horizontal arm walks diverge only then (noise pairs
    grow no arms at all; smooth gradients grow identical ones)."""
    left, right = _bottom_detail_scene()
    cfg = StereoConfig(d_max=7, arm_len=6, oii_impl="taps")
    full = cross_based.cross_pipeline(left, right, cfg)
    initial, final = cross_pipeline_wavefront(left, right, cfg, bands)
    np.testing.assert_array_equal(np.asarray(initial),
                                  np.asarray(full.initial))
    np.testing.assert_array_equal(np.asarray(final), np.asarray(full.final))


def test_cross_plan_rejects_short_bands():
    assert plan_bands_cross(96, 16, CROSS_CFG) is None
