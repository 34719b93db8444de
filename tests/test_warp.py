"""Canvas warps (ops/warp.py): the point-gather warp_image and the banded
shift-select warp against a NumPy nearest-read oracle of
warpingImageByHomography (ImageProcess.cpp:596-606), and the host
planner's choice between them.

Coefficient draws cover real panorama-edge geometry, including warps the
banded kernel must refuse (x-scale far from 1 via the bilinear xy term,
pure downscale)."""
import numpy as np
import pytest

import jax.numpy as jnp

from computervisionimagestich2_tpu.ops.warp import (
    plan_edge_warp, warp_image, warp_image_banded)

CASES = [
    # (coeffs, offset_x, offset_y, src_hw, out_hw)
    # near-translation (banded-kernel territory)
    ([1.0, 0.02, 0.0, -120.0, 0.01, 1.0, 0.0, 12.0], -130.0, -20.0,
     (96, 160), (128, 256)),
    # dataset1-edge-like geometry: scale 0.93 + xy cross term
    ([0.93, -0.027, 2.4e-4, 214.0, 3.2e-3, 1.0, -2.1e-6, 4.0], -40.0, -16.0,
     (200, 240), (256, 512)),
    # strong xy term at canvas distance
    ([0.9, -0.05, 6.0e-4, 60.0, 0.01, 1.05, -8.0e-5, -10.0], -10.0, -64.0,
     (160, 200), (320, 384)),
    # pure downscale (every output row reads a sparse source row)
    ([1.7, 0.0, 0.0, -30.0, 0.0, 1.7, 0.0, -20.0], 0.0, 0.0,
     (128, 160), (120, 256)),
]


def oracle_warp(src, coeffs, ox, oy, out_hw):
    """Nearest read with C float->int truncation, zero canvas; also the
    mask of pixels whose warped coordinate lies within 1e-3 of an integer
    (f32 rounding may legitimately truncate those either way)."""
    c = np.asarray(coeffs, np.float64)
    h, w = out_hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x, y = xs + ox, ys + oy
    xw = c[0] * x + c[1] * y + c[2] * x * y + c[3]
    yw = c[4] * x + c[5] * y + c[6] * x * y + c[7]
    nx, ny = np.trunc(xw).astype(int), np.trunc(yw).astype(int)
    ok = (nx >= 0) & (nx < src.shape[1]) & (ny >= 0) & (ny < src.shape[0])
    out = np.zeros((h, w, src.shape[2]), np.float32)
    out[ok] = src[ny[ok], nx[ok]]

    def near_int(v):
        return np.abs(v - np.round(v)) < 1e-3

    return out, near_int(xw) | near_int(yw)


def _check(got, want, ambiguous):
    got = np.asarray(got)
    np.testing.assert_array_equal(got[~ambiguous], want[~ambiguous])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_warp_matches_oracle(case):
    """Gather warp == oracle for every case; where the planner admits the
    banded kernel, it must equal the oracle too."""
    coeffs, ox, oy, src_hw, out_hw = CASES[case]
    rng = np.random.default_rng(11 + case)
    src = rng.random((src_hw[0], src_hw[1], 3), dtype=np.float32) * 255.0
    want, amb = oracle_warp(src, coeffs, ox, oy, out_hw)
    cj = jnp.asarray(coeffs, jnp.float32)
    got = warp_image(jnp.asarray(src), cj, jnp.float32(ox), jnp.float32(oy),
                     out_shape=out_hw)
    _check(got, want, amb)
    plan = plan_edge_warp(np.asarray(coeffs), out_hw, ox, oy, src_hw)
    assert (plan is not None) == (case == 0), plan
    if plan is not None:
        banded = warp_image_banded(jnp.asarray(src), cj, jnp.float32(ox),
                                   jnp.float32(oy), out_hw, plan[1],
                                   plan[2])
        _check(banded, want, amb)


def test_plan_edge_warp_choice():
    """Banded when the per-tile deviation from a translation fits a band
    bucket (the band grows with the distortion), else None (gather)."""
    ident = np.asarray([1.0, 0, 0, 5.0, 0, 1.0, 0, -3.0])
    assert plan_edge_warp(ident, (256, 384), 0.0, 0.0,
                          (256, 384)) == ("banded", 2, 2)
    skew = np.asarray([1.0, 0.05, 0, 0, 0.05, 1.0, 0, 0])
    plan = plan_edge_warp(skew, (256, 384), 0.0, 0.0, (256, 384))
    assert plan[0] == "banded" and plan[1] > 2 and plan[2] > 2
    # 20x horizontal downscale: no band bucket covers it
    assert plan_edge_warp(np.asarray([20.0, 0, 0, 0, 0, 1.0, 0, 0]),
                          (64, 2560), 0.0, 0.0, (64, 4096)) is None
    # projective warp whose horizon crosses the canvas
    horizon = np.asarray([1.0, 0, 0, 0, 1.0, 0, -0.01, 0, 1.0])
    assert plan_edge_warp(horizon, (128, 256), 0.0, 0.0, (128, 256),
                          model="projective") is None


def test_banded_warp_offset_sweep(rng):
    """Banded == oracle across canvas offsets that move the source window
    off every edge of the canvas (partial and empty overlap)."""
    coeffs = [1.0, 0.01, 1e-5, -3.0, -0.005, 1.0, 2e-5, 2.0]
    src = rng.random((90, 140, 3), dtype=np.float32) * 255.0
    out_hw = (128, 200)
    for ox, oy in ((-60.0, -40.0), (0.0, 0.0), (70.5, 15.25),
                   (-150.0, 0.0), (500.0, 500.0)):
        plan = plan_edge_warp(np.asarray(coeffs), out_hw, ox, oy, (90, 140))
        assert plan is not None and plan[0] == "banded"
        want, amb = oracle_warp(src, coeffs, ox, oy, out_hw)
        got = warp_image_banded(jnp.asarray(src),
                                jnp.asarray(coeffs, jnp.float32),
                                jnp.float32(ox), jnp.float32(oy), out_hw,
                                plan[1], plan[2])
        _check(got, want, amb)
