"""Warp-model solvers.

The reference solves A h = b with rows [x, y, x*y, 1] twice (x' and y'
targets) — 4x4 LU for a minimal sample (getHomographyMat,
/root/reference/ImageProcess.cpp:439-462; CImg.h:25310-25356) and an
overdetermined least-squares refit on the inliers (getInlinerHomography,
ImageProcess.cpp:500-529).

Solves are batched/vmapped over RANSAC hypotheses. Because the design
matrix contains x*y terms (values up to ~1e6 at canvas scale), we normalize
coordinates (shift/scale) before solving and map the coefficients back
exactly — keeping f32 well-conditioned instead of falling back to f64. The
bilinear model family is closed under this reparameterization, so the result
is mathematically identical.

Every normal-equation product runs at HIGHEST precision: a GPU would
otherwise round f32 matmul operands to TF32 (10 mantissa bits), which the
refit's sub-0.05 px parity with the reference's f64 solve does not survive
(tests/test_match_ransac.py::test_refit_parity_needs_full_f32).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a @ b in full f32 (no TF32 rounding of the operands)."""
    return jnp.matmul(a, b, precision=_HIGHEST)


def _design_rows(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """[N, 4] rows [x, y, x*y, 1] (ImageProcess.cpp:446-449)."""
    return jnp.stack([x, y, x * y, jnp.ones_like(x)], axis=-1)


def _denormalize(coeffs_n: jnp.ndarray, cx, cy, s) -> jnp.ndarray:
    """Map coefficients fitted on normalized coords x̃=(x-cx)/s, ỹ=(y-cy)/s
    back to raw-coordinate coefficients, exactly.

    For one output channel with normalized coeffs (a, b, c, d):
      out = a*x̃ + b*ỹ + c*x̃ỹ + d
          = (a/s - c*cy/s²)x + (b/s - c*cx/s²)y + (c/s²)xy
            + (d - a*cx/s - b*cy/s + c*cx*cy/s²)
    coeffs_n: [..., 2, 4] (channels x', y'). Returns same shape.
    """
    a = coeffs_n[..., 0]
    b = coeffs_n[..., 1]
    c = coeffs_n[..., 2]
    d = coeffs_n[..., 3]
    s2 = s * s
    w_x = a / s - c * cy / s2
    w_y = b / s - c * cx / s2
    w_xy = c / s2
    w_1 = d - a * cx / s - b * cy / s + c * cx * cy / s2
    return jnp.stack([w_x, w_y, w_xy, w_1], axis=-1)


def _solve4_spd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Unrolled 4x4 Cholesky solve for the SPD normal-equation systems.

    A handful of scalar flops per system — vmaps over thousands of
    RANSAC hypotheses without falling back to a batched LU. a: [4, 4] SPD,
    b: [4, K]. Returns x with a @ x = b.
    """
    eps = 1e-30
    l11 = jnp.sqrt(jnp.maximum(a[0, 0], eps))
    l21 = a[1, 0] / l11
    l31 = a[2, 0] / l11
    l41 = a[3, 0] / l11
    l22 = jnp.sqrt(jnp.maximum(a[1, 1] - l21 * l21, eps))
    l32 = (a[2, 1] - l31 * l21) / l22
    l42 = (a[3, 1] - l41 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(a[2, 2] - l31 * l31 - l32 * l32, eps))
    l43 = (a[3, 2] - l41 * l31 - l42 * l32) / l33
    l44 = jnp.sqrt(jnp.maximum(
        a[3, 3] - l41 * l41 - l42 * l42 - l43 * l43, eps))
    # forward substitution L y = b
    y1 = b[0] / l11
    y2 = (b[1] - l21 * y1) / l22
    y3 = (b[2] - l31 * y1 - l32 * y2) / l33
    y4 = (b[3] - l41 * y1 - l42 * y2 - l43 * y3) / l44
    # back substitution L^T x = y
    x4 = y4 / l44
    x3 = (y3 - l43 * x4) / l33
    x2 = (y2 - l32 * x3 - l42 * x4) / l22
    x1 = (y1 - l21 * x2 - l31 * x3 - l41 * x4) / l11
    return jnp.stack([x1, x2, x3, x4])


def solve_warp(src_xy: jnp.ndarray, dst_xy: jnp.ndarray,
               weights: jnp.ndarray | None = None,
               init: jnp.ndarray | None = None) -> jnp.ndarray:
    """Fit the 8-coefficient bilinear warp mapping src -> dst.

    src_xy, dst_xy: [N, 2]. weights: optional [N] mask/weights for the
    least-squares refit (the RANSAC inlier set with static shape). With
    N == 4 and unit weights this reproduces the reference's exact minimal
    solve; with more points it is the least-squares refit.

    ``init``: optional (8,) warm-start coefficients (e.g. the best RANSAC
    hypothesis). The model is linear in its coefficients, so the least-
    squares solution decomposes exactly as
        argmin ||A h - d|| = init + argmin ||A dh - (d - A init)||
    and fitting the RESIDUAL keeps every f32 intermediate at O(threshold)
    pixels instead of O(image size). Without it, forming A^T d in f32 with
    dst values ~O(500) rounds away the px-level signal: measured 1.8-3.6 px
    of warped-corner drift vs the reference's f64 CImg refit ON THE SAME
    inlier set (scripts/parity_refit.py, round 3); with init + one
    refinement step the drift is < 0.02 px.

    Returns the flat (8,) coefficient vector
    [w11, w12, w13, w21, w22, w23, w31, w32] (see ops.warp.warp_xy).
    """
    x, y = src_xy[:, 0], src_xy[:, 1]
    if weights is None:
        weights = jnp.ones_like(x)
    wsum = jnp.maximum(jnp.sum(weights), 1.0)
    cx = jnp.sum(weights * x) / wsum
    cy = jnp.sum(weights * y) / wsum
    spread = jnp.sum(weights * (jnp.abs(x - cx) + jnp.abs(y - cy))) / wsum
    s = jnp.maximum(spread, 1e-3)

    if init is not None:
        ini = init.reshape(2, 4)
        pred = jnp.stack([
            ini[0, 0] * x + ini[0, 1] * y + ini[0, 2] * x * y + ini[0, 3],
            ini[1, 0] * x + ini[1, 1] * y + ini[1, 2] * x * y + ini[1, 3],
        ], axis=-1)
        dst_xy = dst_xy - pred
    # center the target channels: the fitted constant column absorbs the
    # centroid exactly, and A^T d then sums O(residual)-sized terms
    cu = jnp.sum(weights * dst_xy[:, 0]) / wsum
    cv = jnp.sum(weights * dst_xy[:, 1]) / wsum
    duv = jnp.stack([cu, cv])
    dst_c = dst_xy - duv

    xn = (x - cx) / s
    yn = (y - cy) / s
    a_mat = _design_rows(xn, yn)                      # [N, 4]
    aw = a_mat * weights[:, None]
    ata = _mm(aw.T, a_mat)                             # [4, 4]
    atb = _mm(aw.T, dst_c)                             # [4, 2]
    # Tikhonov epsilon keeps degenerate samples (duplicate points) finite;
    # RANSAC scoring discards them, mirroring the reference where CImg's
    # solver returns garbage for singular systems.
    ata = ata + 1e-6 * jnp.eye(4, dtype=ata.dtype)
    sol = _solve4_spd(ata, atb)                        # [4, 2]
    # one step of iterative refinement against the original residual
    # (normal equations square the condition number; one correction step
    # reaches f32 roundoff at these conditioning levels)
    r = dst_c - _mm(a_mat, sol)                        # [N, 2]
    sol = sol + _solve4_spd(ata, _mm(aw.T, r))
    sol = sol.at[3, :].add(duv)                        # un-center targets
    coeffs_n = sol.T                                   # [2, 4]
    coeffs = _denormalize(coeffs_n, cx, cy, s)         # [2, 4]
    flat = coeffs.reshape(8)
    return flat + init if init is not None else flat


solve_warp_batched = jax.vmap(solve_warp, in_axes=(0, 0, None))


def _solve_spd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Unrolled Cholesky solve for small SPD systems (any static n).

    Generated loop is fully unrolled at trace time — vmaps over RANSAC
    hypotheses as straight-line elementwise code instead of a batched LU.
    a: [n, n] SPD, b: [n, K].
    """
    n = a.shape[0]
    eps = 1e-30
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        s = a[i, i] - sum((l[i][k] * l[i][k] for k in range(i)), start=jnp.float32(0))
        l[i][i] = jnp.sqrt(jnp.maximum(s, eps))
        for j in range(i + 1, n):
            s = a[j, i] - sum((l[j][k] * l[i][k] for k in range(i)),
                              start=jnp.float32(0))
            l[j][i] = s / l[i][i]
    y = [None] * n
    for i in range(n):
        y[i] = (b[i] - sum((l[i][k] * y[k] for k in range(i)),
                           start=jnp.zeros_like(b[0]))) / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum((l[k][i] * x[k] for k in range(i + 1, n)),
                           start=jnp.zeros_like(b[0]))) / l[i][i]
    return jnp.stack(x)


def solve_projective(src_xy: jnp.ndarray, dst_xy: jnp.ndarray,
                     weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """Fit a projective homography (normalized DLT, inhomogeneous form).

    The reference's report describes DLT (16340028.md §DLT) but its code
    solves the bilinear model; this is the documented 'correct mode'
    alternative (SURVEY.md §7 'Reference bugs as behavior').

    Solves the 8-unknown system from x' = (h0 x + h1 y + h2) / (h6 x + h7 y + 1),
    y' = (h3 x + h4 y + h5) / (h6 x + h7 y + 1) by least squares on the
    linearized equations, with the same coordinate normalization as
    solve_warp. Returns (9,) row-major homography with h[8] = 1.
    """
    x, y = src_xy[:, 0], src_xy[:, 1]
    u, v = dst_xy[:, 0], dst_xy[:, 1]
    if weights is None:
        weights = jnp.ones_like(x)
    wsum = jnp.maximum(jnp.sum(weights), 1.0)
    cx = jnp.sum(weights * x) / wsum
    cy = jnp.sum(weights * y) / wsum
    cu = jnp.sum(weights * u) / wsum
    cv = jnp.sum(weights * v) / wsum
    s = jnp.maximum(jnp.sum(weights * (jnp.abs(x - cx) + jnp.abs(y - cy)))
                    / wsum, 1e-3)
    t = jnp.maximum(jnp.sum(weights * (jnp.abs(u - cu) + jnp.abs(v - cv)))
                    / wsum, 1e-3)
    xn, yn = (x - cx) / s, (y - cy) / s
    un, vn = (u - cu) / t, (v - cv) / t

    zero = jnp.zeros_like(xn)
    one = jnp.ones_like(xn)
    # rows: [x y 1 0 0 0 -u*x -u*y] h = u  and  [0 0 0 x y 1 -v*x -v*y] h = v
    a_u = jnp.stack([xn, yn, one, zero, zero, zero, -un * xn, -un * yn], -1)
    a_v = jnp.stack([zero, zero, zero, xn, yn, one, -vn * xn, -vn * yn], -1)
    a_mat = jnp.concatenate([a_u, a_v], axis=0)             # [2N, 8]
    rhs = jnp.concatenate([un, vn], axis=0)                 # [2N]
    w2 = jnp.concatenate([weights, weights], axis=0)
    aw = a_mat * w2[:, None]
    ata = _mm(aw.T, a_mat) + 1e-6 * jnp.eye(8, dtype=a_mat.dtype)
    atb = _mm(aw.T, rhs)
    hn_col = _solve_spd(ata, atb[:, None])                  # [8, 1]
    # iterative refinement vs the original residual (see solve_warp)
    for _ in range(2):
        r = rhs[:, None] - _mm(a_mat, hn_col)
        hn_col = hn_col + _solve_spd(ata, _mm(aw.T, r))
    hn = hn_col[:, 0]                                       # [8]

    # denormalize: H = T_dst^-1 @ Hn @ T_src, with
    # T_src: p -> (p - c_src)/s, T_dst^-1: q -> q*t + c_dst
    h_n = jnp.concatenate([hn, jnp.ones(1, hn.dtype)]).reshape(3, 3)
    t_src = jnp.array([[1 / s, 0, -cx / s], [0, 1 / s, -cy / s], [0, 0, 1]],
                      dtype=hn.dtype)
    t_dst_inv = jnp.array([[t, 0, cu], [0, t, cv], [0, 0, 1]], dtype=hn.dtype)
    h_full = _mm(_mm(t_dst_inv, h_n), t_src)
    h_full = h_full / h_full[2, 2]
    return h_full.reshape(9)
