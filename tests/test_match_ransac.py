"""Tests for exact matching and vmapped RANSAC."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from computervisionimagestich2_tpu.core.types import Features, MatchPairs
from computervisionimagestich2_tpu.models.matcher import match_count, match_features
from computervisionimagestich2_tpu.models.ransac import (
    ransac_warp,
    reprojection_errors,
)


def make_features(desc, xy):
    n, d = desc.shape
    cap = 64
    pad_desc = np.zeros((cap, d), np.float32)
    pad_desc[:n] = desc
    pad_xy = np.zeros((cap, 2), np.float32)
    pad_xy[:n] = xy
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return Features(desc=pad_desc, xy=pad_xy,
                    scale=np.ones(cap, np.float32), valid=valid)


def test_match_features_pairs_aligned(rng):
    # B's descriptors are noisy copies of a subset of A's
    da = rng.normal(size=(10, 16)).astype(np.float32)
    da /= np.linalg.norm(da, axis=1, keepdims=True)
    perm = [3, 7, 1]
    db = da[perm] + 0.001
    xa = rng.uniform(0, 100, (10, 2)).astype(np.float32)
    xb = rng.uniform(0, 100, (3, 2)).astype(np.float32)
    fa = make_features(da, xa)
    fb = make_features(db, xb)
    pairs = match_features(fa, fb, ratio=0.5, max_matches=32)
    n = int(np.asarray(pairs.count()))
    assert n == 3
    got_src = np.asarray(pairs.src_xy)[:n]
    got_dst = np.asarray(pairs.dst_xy)[:n]
    # src must be A's keypoint of the matched descriptor, dst B's keypoint
    np.testing.assert_allclose(got_src, xa[perm], atol=1e-5)
    np.testing.assert_allclose(got_dst, xb, atol=1e-5)
    assert int(np.asarray(match_count(fa, fb))) == 3


def test_ransac_recovers_warp_with_outliers(rng):
    true_c = np.array([1.01, 0.04, 2e-5, 35.0, -0.03, 0.99, -1e-5, -12.0],
                      np.float32)
    n, cap = 60, 128
    src = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    x, y = src[:, 0], src[:, 1]
    dst = np.stack([
        true_c[0] * x + true_c[1] * y + true_c[2] * x * y + true_c[3],
        true_c[4] * x + true_c[5] * y + true_c[6] * x * y + true_c[7],
    ], axis=-1).astype(np.float32)
    dst[:20] += rng.uniform(50, 200, (20, 2)).astype(np.float32)  # outliers

    pad = lambda a: np.pad(a, ((0, cap - n), (0, 0)))
    valid = np.zeros(cap, bool)
    valid[:n] = True
    pairs = MatchPairs(pad(src), pad(dst), valid)

    coeffs, mask, count = ransac_warp(pairs, jax.random.PRNGKey(0),
                                      n_hypotheses=128, threshold=4.0)
    count = int(np.asarray(count))
    assert count >= 38, count  # the 40 inliers (allow edge effects)
    errs = np.asarray(reprojection_errors(coeffs, pairs))[20:n]
    assert errs.max() < 1.0, errs.max()


def test_ransac_deterministic(rng):
    n, cap = 30, 64
    src = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    dst = src + np.array([25.0, -3.0], np.float32)
    pad = lambda a: np.pad(a, ((0, cap - n), (0, 0)))
    valid = np.zeros(cap, bool)
    valid[:n] = True
    pairs = MatchPairs(pad(src), pad(dst), valid)
    c1, _, _ = ransac_warp(pairs, jax.random.PRNGKey(666666))
    c2, _, _ = ransac_warp(pairs, jax.random.PRNGKey(666666))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


def test_l2pre_matches_exact_sets(rng):
    """The matmul-prefiltered matcher (match.method='l2pre') must reproduce
    the exact-L1 ratio-test decisions AND nearest indices."""
    from computervisionimagestich2_tpu.ops import distance as D

    base = np.abs(rng.normal(size=(384, 128))).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    q = np.abs(base[:256] + rng.normal(size=(256, 128)).astype(np.float32)
               * 0.01).astype(np.float32)
    qv = np.arange(256) < 200
    rv = np.arange(384) < 350
    ex = D.ratio_match_bidir(q, base, qv, rv, 0.5, "l1", "exact")
    l2 = D.ratio_match_bidir(q, base, qv, rv, 0.5, "l1", "l2pre", 32)
    np.testing.assert_array_equal(np.asarray(ex[0]), np.asarray(l2[0]))
    np.testing.assert_array_equal(np.asarray(ex[2]), np.asarray(l2[2]))
    okq = np.asarray(ex[0])
    np.testing.assert_array_equal(np.asarray(ex[1])[okq],
                                  np.asarray(l2[1])[okq])
    assert int(okq.sum()) == 200


def test_l2pre_respects_validity(rng):
    """Invalid reference rows must never be selected as candidates."""
    from computervisionimagestich2_tpu.ops import distance as D

    q = np.abs(rng.normal(size=(64, 128))).astype(np.float32)
    r = np.zeros((128, 128), np.float32)
    r[:8] = np.abs(rng.normal(size=(8, 128)))
    # rows 8.. are exact copies of the queries but INVALID
    r[8:72] = q
    rv = np.arange(128) < 8
    qv = np.ones(64, bool)
    d1, d2, i1 = D.two_nearest(q, r, qv, rv, "l1", "l2pre", 16)
    assert np.all(np.asarray(i1) < 8)


def test_ransac_lo_never_shrinks_consensus(rng):
    """lo_iters rounds keep the model bit-for-bit when consensus does not
    grow and can only grow it otherwise (models/ransac.py LO-RANSAC)."""
    import jax

    from computervisionimagestich2_tpu.core.types import MatchPairs

    n = 256
    src = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    coeffs_true = np.asarray([1.02, 0.03, 1e-5, 4.0,
                              -0.02, 0.98, -1e-5, 7.0], np.float32)
    x, y = src[:, 0], src[:, 1]
    dst = np.stack([coeffs_true[0] * x + coeffs_true[1] * y
                    + coeffs_true[2] * x * y + coeffs_true[3],
                    coeffs_true[4] * x + coeffs_true[5] * y
                    + coeffs_true[6] * x * y + coeffs_true[7]], axis=-1)
    dst += rng.normal(0, 1.2, dst.shape)          # inlier noise ~ threshold
    out = rng.random(n) < 0.3                     # 30% gross outliers
    dst[out] += rng.uniform(30, 90, (int(out.sum()), 2))
    pairs = MatchPairs(src_xy=jnp.asarray(src), dst_xy=jnp.asarray(dst),
                       valid=jnp.ones(n, bool), n_raw=jnp.int32(n))
    key = jax.random.PRNGKey(3)
    c0, m0, k0 = ransac_warp(pairs, key, 64, 4.0, 4, "bilinear", 0)
    c1, m1, k1 = ransac_warp(pairs, key, 64, 4.0, 4, "bilinear", 2)
    assert int(k1) >= int(k0)
    if int(k1) == int(k0):
        np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))


def test_ransac_corner_gate_clean_identical(rng):
    """The degenerate-model corner gate must be a no-op on sane data:
    same model bit-for-bit with and without it."""
    import jax
    import jax.numpy as jnp

    from computervisionimagestich2_tpu.core.types import MatchPairs
    from computervisionimagestich2_tpu.models.ransac import ransac_warp

    n = 64
    src = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    c = np.array([1.02, 0.03, 1e-5, 5.0, -0.02, 0.98, -2e-5, 9.0],
                 np.float32)
    dst_x = c[0] * src[:, 0] + c[1] * src[:, 1] \
        + c[2] * src[:, 0] * src[:, 1] + c[3]
    dst_y = c[4] * src[:, 0] + c[5] * src[:, 1] \
        + c[6] * src[:, 0] * src[:, 1] + c[7]
    dst = np.stack([dst_x, dst_y], -1).astype(np.float32)
    dst[:12] += rng.uniform(30, 90, (12, 2)).astype(np.float32)  # outliers
    pairs = MatchPairs(jnp.asarray(src), jnp.asarray(dst),
                       jnp.ones(n, bool))
    key = jax.random.PRNGKey(3)
    corners = jnp.asarray([[0.0, 0.0], [199.0, 0.0], [0.0, 199.0],
                           [199.0, 199.0]], jnp.float32)

    c_plain, _, n_plain = ransac_warp(pairs, key, 64, 4.0)
    c_gated, _, n_gated = ransac_warp(pairs, key, 64, 4.0,
                                      corner_xy=corners,
                                      corner_span=4.0 * 283.0)
    np.testing.assert_array_equal(np.asarray(c_plain), np.asarray(c_gated))
    assert int(n_plain) == int(n_gated)

    # safety invariant under an adversarially tight span: the returned
    # model either keeps the corners inside the (span-expanded) dst bbox
    # or reports zero consensus — an exploding model can never surface
    # with a live count. (The warm-started refit may legitimately
    # resurrect a bbox-interior model even when every raw hypothesis was
    # gated, so count==0 alone is NOT guaranteed.)
    from computervisionimagestich2_tpu.ops.warp import warp_points

    span = 1e-6
    c_tight, _, n_tight = ransac_warp(pairs, key, 64, 4.0,
                                      corner_xy=corners, corner_span=span)
    cx, cy = warp_points(jnp.asarray(c_tight), corners[:, 0],
                         corners[:, 1], "bilinear")
    lo = dst.min(0) - span - 1e-3
    hi = dst.max(0) + span + 1e-3
    in_bounds = bool(np.all((np.asarray(cx) >= lo[0])
                            & (np.asarray(cx) <= hi[0])
                            & (np.asarray(cy) >= lo[1])
                            & (np.asarray(cy) <= hi[1])))
    assert in_bounds or int(n_tight) == 0, (in_bounds, int(n_tight))


def test_validate_plan_rejects_degenerate_canvas():
    from computervisionimagestich2_tpu.models.stitcher import Stitcher

    plan = np.zeros((2, 23), np.float32)
    plan[:, 20] = 900.0   # new_w
    plan[:, 21] = 700.0   # new_h
    Stitcher._validate_plan(plan, (480, 640), 2)      # sane: no raise

    plan[1, 20] = 4.3e6   # the round-5 dataset2-graph failure mode
    with pytest.raises(ValueError, match="degenerate registration"):
        Stitcher._validate_plan(plan, (480, 640), 2)

    plan[1, 20] = np.nan
    with pytest.raises(ValueError, match="degenerate registration"):
        Stitcher._validate_plan(plan, (480, 640), 2)


def test_refit_parity_needs_full_f32(rng, monkeypatch):
    """The least-squares refit holds the 0.05 px parity tolerance of the
    reference's f64 refit only with full-f32 products: rounding the
    normal-equation operands to TF32 (10 mantissa bits, what a GPU does
    to f32 matmuls at DEFAULT precision) breaks it. solve.py therefore
    pins HIGHEST."""
    from computervisionimagestich2_tpu.ops import solve, warp

    def tf32(a):
        bits = jax.lax.bitcast_convert_type(jnp.asarray(a, jnp.float32),
                                            jnp.uint32)
        return jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFE000),
                                            jnp.float32)

    n = 400
    src = rng.uniform(0, 1500, size=(n, 2))
    true_c = np.array([0.93, -0.027, 2.4e-4, 214.0,
                       3.2e-3, 1.0, -2.1e-6, 4.0])
    x, y = src[:, 0], src[:, 1]
    dst = np.stack([
        true_c[0] * x + true_c[1] * y + true_c[2] * x * y + true_c[3],
        true_c[4] * x + true_c[5] * y + true_c[6] * x * y + true_c[7],
    ], axis=-1) + rng.normal(scale=1.0, size=(n, 2))
    a_mat = np.stack([x, y, x * y, np.ones(n)], axis=-1)
    ex, *_ = np.linalg.lstsq(a_mat, dst[:, 0], rcond=None)
    ey, *_ = np.linalg.lstsq(a_mat, dst[:, 1], rcond=None)
    corners = np.array([[0, 0], [1500, 0], [0, 1500], [1500, 1500]],
                       np.float64)
    cx, cy = corners[:, 0], corners[:, 1]

    def corner_err(c):
        gx, gy = warp.warp_xy(np.asarray(c, np.float64), cx, cy)
        tx = ex[0] * cx + ex[1] * cy + ex[2] * cx * cy + ex[3]
        ty = ey[0] * cx + ey[1] * cy + ey[2] * cx * cy + ey[3]
        return float(np.hypot(np.asarray(gx) - tx,
                              np.asarray(gy) - ty).max())

    s32, d32 = src.astype(np.float32), dst.astype(np.float32)
    assert corner_err(solve.solve_warp(s32, d32)) < 0.05
    full = solve._mm
    monkeypatch.setattr(solve, "_mm", lambda p, q: full(tf32(p), tf32(q)))
    assert corner_err(solve.solve_warp(s32, d32)) > 0.05
