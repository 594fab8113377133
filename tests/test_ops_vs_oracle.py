"""Unit tests: vectorised jnp ops vs. per-pixel numpy oracles (tiny shapes).

The oracles in tests/oracle.py transliterate the reference OpenCL kernels'
semantics; these tests pin the ops layer to them exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from stereo_matchin_tpu import ops

from . import oracle

H, W, D, R, L = 11, 13, 6, 3, 4
TAU = 0.10


def _rand_img(rng, h=H, w=W):
    """Random RGB image on the UNORM8 grid (like decoded PNG / CL images)."""
    return (rng.integers(0, 256, size=(h, w, 3)) / np.float32(255.0)).astype(
        np.float32
    )


def _rand_pair(rng):
    left = _rand_img(rng)
    # Right = shifted left + noise so disparities/arms are non-trivial.
    right = np.roll(left, -2, axis=1)
    noise = rng.integers(-8, 9, size=right.shape) / np.float32(255.0)
    right = np.clip(np.round((right + noise) * 255) / 255.0, 0, 1).astype(np.float32)
    return left, right


def test_median3x3(rng):
    img = _rand_img(rng)
    got = np.asarray(ops.median3x3(jnp.asarray(img)))
    np.testing.assert_array_equal(got, oracle.median3x3(img))


def test_cross_arms_legacy(rng):
    img = _rand_img(rng)
    got = np.asarray(ops.cross_arms(jnp.asarray(img), arm_len=L, tau=TAU,
                                    legacy_quirk=True))
    np.testing.assert_array_equal(got, oracle.cross_arms(img, L, TAU, True))


def test_cross_arms_long(rng):
    img = np.tile(_rand_img(rng, 4, 4), (8, 8, 1))[: 2 * L + 6, : 2 * L + 6]
    got = np.asarray(ops.cross_arms(jnp.asarray(img), arm_len=L, tau=0.5,
                                    legacy_quirk=True))
    np.testing.assert_array_equal(got, oracle.cross_arms(img, L, 0.5, True))


@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_sad_cost_volume(rng, scale):
    left, right = _rand_pair(rng)
    got = np.asarray(ops.sad_cost_volume(jnp.asarray(left), jnp.asarray(right),
                                         D, scale=scale))
    want = oracle.sad_cost_volume(left, right, D, scale)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_oii_chain(rng):
    left, right = _rand_pair(rng)
    arms_l = oracle.cross_arms(left, L, TAU, True)
    arms_r = oracle.cross_arms(right, L, TAU, True)
    cost = oracle.sad_cost_volume(left, right, D, 1.0)
    got = np.asarray(ops.cross_aggregate(jnp.asarray(cost), jnp.asarray(arms_l),
                                         jnp.asarray(arms_r)))
    want = oracle.oii_chain(cost, arms_l, arms_r)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_histogram_vote(rng):
    left, _ = _rand_pair(rng)
    arms_l = oracle.cross_arms(left, L, TAU, True)
    d_max = D - 1
    raw = rng.integers(0, D, size=(H, W)).astype(np.float32)
    disp_img = np.round(raw / d_max * 255) / np.float32(255.0)
    got = np.asarray(ops.histogram_vote(jnp.asarray(disp_img),
                                        jnp.asarray(arms_l), d_max))
    want = oracle.histogram_vote(disp_img, arms_l, d_max)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1])
def test_support_weights(rng, axis):
    img = _rand_img(rng)
    got = np.asarray(ops.support_weights(jnp.asarray(img), R, 30.91, 28.21, axis))
    want = oracle.support_weights(img, R, 30.91, 28.21, axis)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axis", [1, 2])
def test_asw_aggregate_pass(rng, axis):
    left, right = _rand_pair(rng)
    cost = oracle.sad_cost_volume(left, right, D, 255.0)
    waxis = 0 if axis == 1 else 1
    wl = oracle.support_weights(left, R, 30.91, 28.21, waxis)
    wr = oracle.support_weights(right, R, 30.91, 28.21, waxis)
    got, got_den = ops.asw_aggregate_pass(
        jnp.asarray(cost), jnp.asarray(wl), jnp.asarray(wr), axis=axis, radius=R
    )
    want, want_den = oracle.asw_aggregate_pass(cost, wl, wr, axis, R)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_den), want_den, rtol=1e-4, atol=1e-5)


def test_wta(rng):
    left, right = _rand_pair(rng)
    cost = oracle.sad_cost_volume(left, right, D, 255.0)
    res = ops.wta(jnp.asarray(cost))
    d_ref, conf_ref, d_tar, conf_tar = oracle.wta(cost)
    np.testing.assert_array_equal(np.asarray(res.disp_ref), d_ref)
    np.testing.assert_allclose(np.asarray(res.conf_ref), conf_ref, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(res.disp_target), d_tar)
    np.testing.assert_allclose(np.asarray(res.conf_target), conf_tar, rtol=1e-5)


def test_wta_with_duplicate_minima():
    cost = np.ones((4, 3, 5), np.float32)
    cost[1], cost[3] = 0.25, 0.25  # duplicate minimum -> c2 == c1, conf 0
    res = ops.wta(jnp.asarray(cost))
    d_ref, conf_ref, d_tar, conf_tar = oracle.wta(cost)
    np.testing.assert_array_equal(np.asarray(res.disp_ref), d_ref)
    np.testing.assert_allclose(np.asarray(res.conf_ref), conf_ref, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(res.disp_target), d_tar)


def test_wta_refined(rng):
    left, right = _rand_pair(rng)
    cost = oracle.sad_cost_volume(left, right, D, 255.0)
    rv = rng.uniform(0, D - 1, (H, W)).astype(np.float32)
    rd = rng.uniform(0.5, 40.0, (H, W)).astype(np.float32)
    rvt = rng.uniform(0, D - 1, (H, W)).astype(np.float32)
    rdt = rng.uniform(0.5, 40.0, (H, W)).astype(np.float32)
    res = ops.wta_refined(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(rd),
                          jnp.asarray(rvt), jnp.asarray(rdt), penalty=0.085)
    d_ref, conf_ref, d_tar, conf_tar = oracle.wta_ref(cost, rv, rd, rvt, rdt)
    np.testing.assert_array_equal(np.asarray(res.disp_ref), d_ref)
    np.testing.assert_allclose(np.asarray(res.conf_ref), conf_ref, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(res.disp_target), d_tar)
    np.testing.assert_allclose(np.asarray(res.conf_target), conf_tar, rtol=1e-4)


def test_consistency(rng):
    d_max = D - 1
    d_ref = rng.integers(0, D, (H, W)).astype(np.float32)
    d_tar = np.where(rng.uniform(size=(H, W)) < 0.5, d_ref,
                     rng.integers(0, D, (H, W))).astype(np.float32)
    cr = rng.uniform(0, 1, (H, W)).astype(np.float32)
    ct = rng.uniform(0, 1, (H, W)).astype(np.float32)
    res = ops.consistency(jnp.asarray(d_ref), jnp.asarray(d_tar),
                          jnp.asarray(cr), jnp.asarray(ct))
    filled, w_cr, w_ct, cons = oracle.consistency(d_ref, d_tar, cr, ct)
    np.testing.assert_array_equal(np.asarray(res.filled), filled)
    np.testing.assert_array_equal(np.asarray(res.conf_ref), w_cr)
    np.testing.assert_array_equal(np.asarray(res.conf_target), w_ct)
    np.testing.assert_array_equal(np.asarray(res.consistent), cons)


def test_refinement(rng):
    left, _ = _rand_pair(rng)
    d_max = D - 1
    d_est = oracle.unorm8(
        rng.integers(0, D, (H, W)).astype(np.float32) / d_max
    ) * d_max
    conf = rng.uniform(0, 1, (H, W)).astype(np.float32)
    wv, wh = ops.refinement_weights(jnp.asarray(left), R, 10.94, 118.78)
    vv, dv = ops.refine_pass_v(wv, jnp.asarray(d_est), jnp.asarray(conf), R)
    want_vv, want_dv = oracle.refine_v(left, d_est, conf, R)
    np.testing.assert_allclose(np.asarray(vv), want_vv, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dv), want_dv, rtol=1e-4, atol=1e-5)
    vh, dh = ops.refine_pass_h(wh, vv, dv, jnp.asarray(conf), R)
    want_vh, want_dh = oracle.refine_h(left, want_vv, want_dv, conf, R)
    np.testing.assert_allclose(np.asarray(vh), want_vh, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dh), want_dh, rtol=1e-4, atol=1e-4)


def test_wta_argmin(rng):
    cost = rng.uniform(0, 3, (D, H, W)).astype(np.float32)
    got = np.asarray(ops.wta_argmin(jnp.asarray(cost)))
    np.testing.assert_array_equal(got, np.argmin(cost, axis=0).astype(np.float32))


def test_wta_fast_matches_wta(rng):
    left, right = _rand_pair(rng)
    cost = oracle.sad_cost_volume(left, right, D, 255.0)
    slow = ops.wta(jnp.asarray(cost))
    fast = ops.wta_fast(jnp.asarray(cost))
    for a, b in zip(slow, fast):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_wta_refined_fast_matches_wta_refined(rng):
    left, right = _rand_pair(rng)
    cost = oracle.sad_cost_volume(left, right, D, 255.0)
    rv = rng.uniform(0, D - 1, (H, W)).astype(np.float32)
    rd = rng.uniform(0.5, 40.0, (H, W)).astype(np.float32)
    rvt = rng.uniform(0, D - 1, (H, W)).astype(np.float32)
    rdt = rng.uniform(0.5, 40.0, (H, W)).astype(np.float32)
    slow = ops.wta_refined(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(rd),
                           jnp.asarray(rvt), jnp.asarray(rdt), penalty=0.085)
    fast = ops.wta_refined_fast(jnp.asarray(cost), jnp.asarray(rv),
                                jnp.asarray(rd), jnp.asarray(rvt),
                                jnp.asarray(rdt), penalty=0.085)
    # Disparities bit-exact; confidences may differ by 1 ulp (XLA fuses the
    # penalty multiply-add differently between the two formulations).
    np.testing.assert_array_equal(np.asarray(slow.disp_ref),
                                  np.asarray(fast.disp_ref))
    np.testing.assert_array_equal(np.asarray(slow.disp_target),
                                  np.asarray(fast.disp_target))
    np.testing.assert_allclose(np.asarray(slow.conf_ref),
                               np.asarray(fast.conf_ref), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(slow.conf_target),
                               np.asarray(fast.conf_target), rtol=1e-6)


def test_wta_fast_edge_cases():
    # Monotone-increasing planes -> d1 = 0 everywhere (no target probes);
    # duplicate minima -> conf 0; big-valued planes never tracked.
    cost = np.ones((5, 6, 40), np.float32)
    cost[0] = 0.5
    cost[3] = 0.5  # duplicate min
    cost[4] = 2e5  # above big
    slow = ops.wta(jnp.asarray(cost))
    fast = ops.wta_fast(jnp.asarray(cost))
    for a, b in zip(slow, fast):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gather_diagonal_matches_take(rng):
    import importlib

    wf = importlib.import_module("stereo_matchin_tpu.ops.wta_fast")
    cost = rng.uniform(0, 700, (D, H, W)).astype(np.float32)
    d1 = rng.integers(0, D, (H, W)).astype(np.int32)
    xs = np.arange(W)[None, :]
    bs = np.arange(D)[:, None, None]
    idx = np.clip(xs[None] - d1[None] + bs, 0, W - 1)
    want = np.take_along_axis(cost, idx, axis=2)
    got = np.asarray(wf._gather_diagonal(jnp.asarray(cost), jnp.asarray(d1)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(5, 7, 9), (12, 4, 33), (17, 6, 16),
                                   (31, 3, 40)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("penalty", [False, True], ids=["wta", "wta_ref"])
def test_wta_fast_matches_sequential(shape, penalty):
    """The vectorised WTA (one diagonal gather + closed-form clamped
    tail) against the sequential epipolar scans, over plane counts and
    widths on both sides of each other (d1 > x exercises the tail)."""
    Dd, Hh, Ww = shape
    r = np.random.default_rng(Dd * 100 + Ww)
    cost = jnp.asarray(r.uniform(0, 50, shape).astype(np.float32))
    if not penalty:
        slow, fast = ops.wta(cost), ops.wta_fast(cost)
        for a, b in zip(slow, fast):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return
    maps = [jnp.asarray(r.uniform(lo, hi, (Hh, Ww)).astype(np.float32))
            for lo, hi in ((0, Dd - 1), (0.5, 40), (0, Dd - 1), (0.5, 40))]
    slow = ops.wta_refined(cost, *maps, penalty=0.085)
    fast = ops.wta_refined_fast(cost, *maps, penalty=0.085)
    np.testing.assert_array_equal(np.asarray(slow.disp_ref),
                                  np.asarray(fast.disp_ref))
    np.testing.assert_array_equal(np.asarray(slow.disp_target),
                                  np.asarray(fast.disp_target))
    # conf = (c2 - c1) / c2 in [0, 1]: an ulp of penalty contraction in
    # c1 or c2 moves it by up to two ulps of 1.0.
    for a, b in ((slow.conf_ref, fast.conf_ref),
                 (slow.conf_target, fast.conf_target)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=2.4e-7)


def test_oii_taps_matches_prefix(rng):
    left, right = _rand_pair(rng)
    arms_l = oracle.cross_arms(left, L, TAU, True)
    arms_r = oracle.cross_arms(right, L, TAU, True)
    cost = oracle.sad_cost_volume(left, right, D, 1.0)
    prefix = ops.cross_aggregate(jnp.asarray(cost), jnp.asarray(arms_l),
                                 jnp.asarray(arms_r), arm_len=L, impl="prefix")
    taps = ops.cross_aggregate(jnp.asarray(cost), jnp.asarray(arms_l),
                               jnp.asarray(arms_r), arm_len=L, impl="taps")
    np.testing.assert_allclose(np.asarray(taps), np.asarray(prefix),
                               rtol=1e-5, atol=1e-5)


def test_vote_taps_matches_prefix(rng):
    left, _ = _rand_pair(rng)
    arms_l = oracle.cross_arms(left, L, TAU, True)
    d_max = D - 1
    raw = rng.integers(0, D, size=(H, W)).astype(np.float32)
    disp_img = np.round(raw / d_max * 255) / np.float32(255.0)
    prefix = ops.histogram_vote(jnp.asarray(disp_img), jnp.asarray(arms_l),
                                d_max, arm_len=L, impl="prefix")
    taps = ops.histogram_vote(jnp.asarray(disp_img), jnp.asarray(arms_l),
                              d_max, arm_len=L, impl="taps")
    np.testing.assert_array_equal(np.asarray(taps), np.asarray(prefix))


def test_asw_aggregate_2d(rng):
    from stereo_matchin_tpu.ops.asw2d import asw_aggregate_2d

    left, right = _rand_pair(rng)
    cost = oracle.sad_cost_volume(left, right, D, 255.0)
    wv_l = oracle.support_weights(left, R, 30.91, 28.21, 0)
    wv_r = oracle.support_weights(right, R, 30.91, 28.21, 0)
    wh_l = oracle.support_weights(left, R, 30.91, 28.21, 1)
    wh_r = oracle.support_weights(right, R, 30.91, 28.21, 1)
    got = np.asarray(asw_aggregate_2d(
        jnp.asarray(cost), jnp.asarray(wv_l), jnp.asarray(wv_r),
        jnp.asarray(wh_l), jnp.asarray(wh_r), R))
    want = oracle.asw_aggregate_2d(cost, wv_l, wv_r, wh_l, wh_r, R)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_pipeline_determinism(rng):
    """Functional purity: two identical runs produce identical bits (the
    reference relied on an event DAG for this; SURVEY.md §5 race notes)."""
    from stereo_matchin_tpu import StereoConfig
    from stereo_matchin_tpu.models import asw

    cfg = StereoConfig(d_max=5, radius=2, arm_len=3, r_iters=2, k_iters=1)
    left, right = _rand_pair(rng)
    a = asw.asw_pipeline(jnp.asarray(left), jnp.asarray(right), cfg)
    b = asw.asw_pipeline(jnp.asarray(left), jnp.asarray(right), cfg)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_unorm8_closed_form_vs_correctly_rounded_table():
    """ops.unorm8's bitcast closed form == round-half-toward-zero to the
    8-bit grid followed by the CORRECTLY ROUNDED fl(k/255), jitted and
    eager alike — on every d/d_max grid the pipelines feed it, the exact
    8-bit tie points, and a dense [0,1] sweep.  (The closed form
    replaced a 256-entry gather that lowered ~17x slower inside the
    refinement k-loop; the table here is the semantics oracle.)"""
    import jax

    from stereo_matchin_tpu import ops

    table = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)

    def expect(v):
        t = v.astype(np.float32) * np.float32(255.0)
        f = np.floor(t)
        k = (f + (t - f > np.float32(0.5))).astype(np.int64)
        return table[np.clip(k, 0, 255)]

    cases = [np.linspace(0.0, 1.0, 1 << 16, dtype=np.float32)]
    for d_max in (5, 23, 60, 231, 279):
        cases.append((np.arange(d_max + 1) / np.float32(d_max)).astype(
            np.float32))
    # exact 8-bit half points (the tie rule's visible set) and +-1 ulp
    halves = ((np.arange(255, dtype=np.float64) + 0.5) / 255.0).astype(
        np.float32)
    cases += [halves, np.nextafter(halves, 0, dtype=np.float32),
              np.nextafter(halves, 1, dtype=np.float32)]
    fn = jax.jit(ops.unorm8)
    for v in cases:
        np.testing.assert_array_equal(np.asarray(fn(jnp.asarray(v))),
                                      expect(v))
        np.testing.assert_array_equal(np.asarray(ops.unorm8(jnp.asarray(v))),
                                      expect(v))
