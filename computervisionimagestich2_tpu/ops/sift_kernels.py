"""SIFT device kernels: DoG extrema, sub-pixel refinement, polar gradients,
orientation assignment, descriptor computation.

Vectorized re-design of VLFeat's per-keypoint scalar loops
(/root/reference/vl/sift.c):

- ``extrema_mask``       <- the 26-neighbor scan (vl_sift_detect, sift.c:539-603),
  as one vectorized strict-compare over the whole [S, H, W] DoG block.
- ``refine_keypoints``   <- the 5-iteration Newton refine (sift.c:612-757),
  vmapped over a dense candidate list with validity masks instead of the
  dynamic keys buffer (sift.c:580-590).
- ``polar_gradient``     <- update_gradient (sift.c:791-876): central
  differences inside, one-sided at borders; exact sqrt/atan2 instead of
  vl_fast_sqrt_f/vl_fast_atan2_f (parity is count/coord tolerance, SURVEY §7).
- ``orientation_histograms`` <- vl_sift_calc_keypoint_orientations
  (sift.c:904-1036): per-keypoint window gather + bilinear 36-bin histogram
  (VL_SIFT_BILINEAR_ORIENTATIONS is on, sift.c:12) as a one-hot matmul,
  6 rounds of circular [1,1,1]/3 smoothing, peak picking.
- ``descriptors``        <- vl_sift_calc_keypoint_descriptor (sift.c:1268-1438):
  the trilinear scatter into 4x4x8 bins is refactored into a separable
  tensor contraction (two matmuls per keypoint) — scatter-free.

On a GPU the orientation and descriptor stages run as Pallas kernels
instead (ops/sift_triton.py, models/sift.py::kernel_route); these XLA forms
are their reference and the route everywhere else.

All window sizes are static upper bounds derived from the scale-space
geometry; per-keypoint dynamic extents are enforced with masks.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from .compaction import compact_indices

TWO_PI = 2.0 * math.pi
EPSILON_F = 1.19209290e-07  # VL_EPSILON_F


# ----------------------------------------------------------------- detection
def dog_stack(octave: jnp.ndarray) -> jnp.ndarray:
    """DoG from a GSS octave [L, H, W]: dog[s] = oct[s+1] - oct[s]
    (sift.c:521-530)."""
    return octave[1:] - octave[:-1]


def extrema_mask(dog: jnp.ndarray, peak_thresh: float) -> jnp.ndarray:
    """Strict 26-neighbor extremum mask (sift.c:539-603).

    dog: [S, H, W] (S >= 3). Returns bool [S-2, H, W]: True at interior
    (x,y in [1, dim-2]) points that are strict maxima (with v >= 0.8*tp
    pre-gate) or strict minima (v <= -0.8*tp) of their 26-neighborhood.
    Slice s of the output corresponds to dog level s+1.
    """
    v = dog[1:-1]
    n_s, h, w = dog.shape
    gate = 0.8 * peak_thresh

    # separable min/max pooling: the 26-neighbor extremum reduces to ~20
    # two-input min/max passes instead of 52 compare+and passes. The
    # excluding-center in-plane reduction is max(row above, row below,
    # left, right) where rows use the 3-wide x-pool.
    def shifted(a, dy, dx):
        padded = jnp.pad(a, ((0, 0), (1, 1), (1, 1)))
        return jax.lax.slice(padded, (0, 1 + dy, 1 + dx),
                             (a.shape[0], 1 + dy + h, 1 + dx + w))

    def pools(f):
        p3x = f(f(shifted(dog, 0, -1), dog), shifted(dog, 0, 1))
        p3xy = f(f(shifted(p3x, -1, 0), p3x), shifted(p3x, 1, 0))
        p3x_c = p3x[1:-1]
        inplane = f(f(shifted(p3x_c, -1, 0), shifted(p3x_c, 1, 0)),
                    f(shifted(v, 0, -1), shifted(v, 0, 1)))
        return f(f(inplane, p3xy[:-2]), p3xy[2:])

    is_max = (v >= gate) & (v > pools(jnp.maximum))
    is_min = (v <= -gate) & (v < pools(jnp.minimum))
    mask = is_max | is_min
    # zero the 1-pixel border (the reference never scans it)
    h, w = mask.shape[1], mask.shape[2]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (ys >= 1) & (ys <= h - 2) & (xs >= 1) & (xs <= w - 2)
    return mask & interior[None]


def compact_mask(mask: jnp.ndarray, capacity: int):
    """Flatten a bool mask into index lists with a static capacity.

    Returns (indices [capacity, ndim] int32, valid [capacity] bool) in
    C-scan order (s, then y, then x — the reference's append order).
    """
    from .compaction import compact_indices

    idx, valid = compact_indices(mask, capacity)
    coords = jnp.stack(jnp.unravel_index(idx, mask.shape), axis=-1)
    return coords.astype(jnp.int32), valid


def _solve3_gauss(a_mat: jnp.ndarray, b_vec: jnp.ndarray):
    """3x3 solve via the closed-form adjugate (Cramer) with the reference's
    singular fallback b=0 (sift.c:668-727; there a max-pivot Gauss
    elimination bails when a pivot < 1e-10 — the determinant guard is the
    vectorized equivalent, and the |b|<1.5 acceptance gates filter the same
    borderline points). Closed form keeps the per-candidate solve a handful
    of elementwise flops instead of a batched LU."""
    a, b, c = a_mat[0, 0], a_mat[0, 1], a_mat[0, 2]
    d, e, f = a_mat[1, 0], a_mat[1, 1], a_mat[1, 2]
    g, h, i = a_mat[2, 0], a_mat[2, 1], a_mat[2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    safe = jnp.abs(det) > 1e-18
    inv_det = jnp.where(safe, 1.0 / jnp.where(safe, det, 1.0), 0.0)
    x0 = (co_a * b_vec[0] + (c * h - b * i) * b_vec[1]
          + (b * f - c * e) * b_vec[2]) * inv_det
    x1 = (co_b * b_vec[0] + (a * i - c * g) * b_vec[1]
          + (c * d - a * f) * b_vec[2]) * inv_det
    x2 = (co_c * b_vec[0] + (b * g - a * h) * b_vec[1]
          + (a * e - b * d) * b_vec[2]) * inv_det
    return jnp.stack([x0, x1, x2])


def _refine_fields(dog: jnp.ndarray, w: int, h: int, peak_thresh: float,
                   edge_thresh: float, s_min: int, s_max: int, xper: float,
                   sigma0: float, n_levels: int):
    """Dense refinement fields over the whole DoG volume.

    Dense re-design of the per-keypoint Newton solve (sift.c:612-757): the
    gradient/Hessian stencils, the 3x3 solve, the +-1 relocation decision,
    and all acceptance quantities are computed *densely* as stencil math
    (a few hundred flops/pixel — cheaper than per-candidate gathers of 27
    neighbors). The per-candidate loop then only chases positions through
    the precomputed step fields. Values on the 1-pixel border and the outer
    s slices are garbage but unreachable (candidates are interior and steps
    are bounds-clamped, mirroring sift.c:733-739).
    """
    # candidates only live on the interior s slices (extrema_mask slice s ->
    # dog level s+1), and the position chase never moves in s NOR onto the
    # 1-px spatial border (its steps are bounds-clamped to [1, dim-2]) —
    # so every field is computed on the INTERIOR domain
    # [s_out, H-2, W-2] with pure static slices of the dog stack: a
    # jnp.pad + slice per stencil shift would materialize ~12 full
    # [S, H, W] copies that break XLA's fusion of the stencil chain.
    # Slices of one common array fuse freely.
    d_lvl, hh, ww = dog.shape

    def sl(ds, dy, dx):
        return jax.lax.slice(
            dog, (1 + ds, 1 + dy, 1 + dx),
            (d_lvl - 1 + ds, hh - 1 + dy, ww - 1 + dx))

    c = sl(0, 0, 0)
    xp1, xm1 = sl(0, 0, 1), sl(0, 0, -1)
    yp1, ym1 = sl(0, 1, 0), sl(0, -1, 0)
    sp1, sm1 = sl(1, 0, 0), sl(-1, 0, 0)

    dx_ = 0.5 * (xp1 - xm1)
    dy_ = 0.5 * (yp1 - ym1)
    ds_ = 0.5 * (sp1 - sm1)
    dxx = xp1 + xm1 - 2 * c
    dyy = yp1 + ym1 - 2 * c
    dss = sp1 + sm1 - 2 * c
    dxy = 0.25 * (sl(0, 1, 1) + sl(0, -1, -1)
                  - sl(0, 1, -1) - sl(0, -1, 1))
    dxs = 0.25 * (sl(1, 0, 1) + sl(-1, 0, -1)
                  - sl(1, 0, -1) - sl(-1, 0, 1))
    dys = 0.25 * (sl(1, 1, 0) + sl(-1, -1, 0)
                  - sl(1, -1, 0) - sl(-1, 1, 0))

    # dense 3x3 adjugate solve: A b = -[dx, dy, ds]
    co_a = dyy * dss - dys * dys
    co_b = dys * dxs - dxy * dss
    co_c = dxy * dys - dyy * dxs
    det = dxx * co_a + dxy * co_b + dxs * co_c
    safe = jnp.abs(det) > 1e-18
    inv_det = jnp.where(safe, 1.0 / jnp.where(safe, det, 1.0), 0.0)
    r0, r1, r2 = -dx_, -dy_, -ds_
    b0 = (co_a * r0 + (dxs * dys - dxy * dss) * r1
          + (dxy * dys - dxs * dyy) * r2) * inv_det
    b1 = (co_b * r0 + (dxx * dss - dxs * dxs) * r1
          + (dxs * dxy - dxx * dys) * r2) * inv_det
    b2 = (co_c * r0 + (dxy * dxs - dxx * dys) * r1
          + (dxx * dyy - dxy * dxy) * r2) * inv_det

    n_s = c.shape[0]
    # interior-domain iotas: field position (i, j) is image (y, x) =
    # (i + 1, j + 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, c.shape, 1) + 1
    xs = jax.lax.broadcasted_iota(jnp.int32, c.shape, 2) + 1
    ss = jax.lax.broadcasted_iota(jnp.int32, c.shape, 0)
    step_x = (jnp.where((b0 > 0.6) & (xs < w - 2), 1, 0)
              + jnp.where((b0 < -0.6) & (xs > 1), -1, 0)).astype(jnp.int32)
    step_y = (jnp.where((b1 > 0.6) & (ys < h - 2), 1, 0)
              + jnp.where((b1 < -0.6) & (ys > 1), -1, 0)).astype(jnp.int32)
    # both +-1 steps packed in one field: the chase is gather-bound, and
    # one code gather per step replaces two
    step_code = (step_y + 1) * 3 + (step_x + 1)

    val = c + 0.5 * (dx_ * b0 + dy_ * b1 + ds_ * b2)
    den = dxx * dyy - dxy * dxy
    score = (dxx + dyy) ** 2 / jnp.where(den == 0, 1e-30, den)
    xn = xs.astype(jnp.float32) + b0
    yn = ys.astype(jnp.float32) + b1
    # sliced slice index ss maps to dog level ss+1
    sn = (ss + 1 + s_min).astype(jnp.float32) + b2
    te = edge_thresh
    ok = (jnp.abs(val) > peak_thresh) \
        & (score < (te + 1.0) * (te + 1.0) / te) & (score >= 0) \
        & (jnp.abs(b0) < 1.5) & (jnp.abs(b1) < 1.5) & (jnp.abs(b2) < 1.5) \
        & (xn >= 0) & (xn <= w - 1) & (yn >= 0) & (yn <= h - 1) \
        & (sn >= s_min) & (sn <= s_max)
    sigma = sigma0 * 2.0 ** (sn / n_levels) * xper
    return step_code, ok, xn * xper, yn * xper, sigma, jnp.abs(val)


@partial(jax.jit, static_argnames=("w", "h", "peak_thresh", "edge_thresh",
                                   "s_min", "s_max", "xper", "sigma0",
                                   "n_levels"))
def refine_keypoints(dog: jnp.ndarray, coords: jnp.ndarray, valid: jnp.ndarray,
                     w: int, h: int, peak_thresh: float, edge_thresh: float,
                     s_min: int, s_max: int, xper: float, sigma0: float,
                     n_levels: int):
    """Candidate refinement. coords: [N, 3] (mask-slice s, y, x) from
    compact_mask over extrema_mask output; mask slice s corresponds to dog
    level s+1. Returns (ok, x, y, sigma, is_level) arrays of length N,
    where x/y/sigma are in input-image units (xper-scaled).

    Dense fields + 5-step position chase; the chase reaches the same fixed
    point as the reference's early-break loop (re-solving at an unmoved
    position is idempotent).

    Also returns the DoG response |val| at the refined position — the
    strength used for response-ranked selection when a static capacity
    binds (VLFeat keeps every accepted keypoint, vl/sift.c:580-590; when
    our final cap must truncate, it keeps the strongest instead of the
    first in scan order — VERDICT r3 ask #2)."""
    step_code, okf, xf, yf, sigmaf, respf = _refine_fields(
        dog, w, h, peak_thresh, edge_thresh, s_min, s_max, xper, sigma0,
        n_levels)
    n_s, hh, ww = dog.shape
    # fields live on the interior domain [s_out, hh-2, ww-2]: image
    # (y, x) is field (y-1, x-1); candidates and the bounds-clamped chase
    # never leave [1, dim-2], so field indices stay in range
    hh2, ww2 = hh - 2, ww - 2
    sc_flat = step_code.reshape(-1)

    # the fields cover only the interior dog slices: mask slice s (= dog
    # level s+1) is field slice s
    s_dog = coords[:, 0] + 1
    y = coords[:, 1]
    x = coords[:, 2]
    base = coords[:, 0] * (hh2 * ww2)

    def chase(_, carry):
        x, y = carry
        flat = base + (y - 1) * ww2 + (x - 1)
        code = sc_flat[flat]           # (step_y+1)*3 + (step_x+1)
        return x + code % 3 - 1, y + code // 3 - 1

    x, y = jax.lax.fori_loop(0, 5, chase, (x, y))
    flat = base + (y - 1) * ww2 + (x - 1)
    # five per-field point gathers, NOT one packed [., 5] row gather: a
    # stack(axis=-1) of the five fields would materialize them (blocking
    # the stencil-chain fusion the interior-slice form above enables)
    ok = okf.reshape(-1)[flat] & valid
    lvl = (s_dog + s_min).astype(jnp.int32)
    return (ok, xf.reshape(-1)[flat], yf.reshape(-1)[flat],
            sigmaf.reshape(-1)[flat], lvl, respf.reshape(-1)[flat])


# ------------------------------------------------------------------ gradient
@jax.jit
def polar_gradient(levels: jnp.ndarray) -> jnp.ndarray:
    """Polar gradient field (update_gradient, sift.c:791-876).

    levels: [L, H, W]. Returns [L, H, W, 2] with (modulus, angle); angle in
    [0, 2pi) per vl_mod_2pi_f(atan2 + 2pi). Central differences inside,
    one-sided at the borders — exactly np.gradient's scheme.
    """
    src = levels
    l, h, w = src.shape
    # edge-replicated +-1 shifts; central diff inside, and the border
    # columns/rows get doubled (edge-pad makes 0.5*(x1-x0) = half the
    # one-sided difference).
    xp = jnp.pad(src[:, :, 1:], ((0, 0), (0, 0), (0, 1)), mode="edge")
    xm = jnp.pad(src[:, :, :-1], ((0, 0), (0, 0), (1, 0)), mode="edge")
    yp = jnp.pad(src[:, 1:, :], ((0, 0), (0, 1), (0, 0)), mode="edge")
    ym = jnp.pad(src[:, :-1, :], ((0, 0), (1, 0), (0, 0)), mode="edge")
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, 1, w), 2)
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, h, 1), 1)
    fx = jnp.where((cols == 0) | (cols == w - 1), 1.0, 0.5)
    fy = jnp.where((rows == 0) | (rows == h - 1), 1.0, 0.5)
    gx = fx * (xp - xm)
    gy = fy * (yp - ym)
    mod = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.mod(jnp.arctan2(gy, gx) + TWO_PI, TWO_PI)
    # plane-major layout [L, 2, H, W]: the GPU kernels read one contiguous
    # [H, W] plane each (ops/sift_triton.py)
    return jnp.stack([mod, ang], axis=1)


# --------------------------------------------------------------- orientation
def ori_patch_radius(sigma0: float, n_levels: int, s_max: int,
                     is_level: int | None = None) -> int:
    """Static upper bound for the orientation window radius W =
    floor(3 * 1.5 * sigma) (sift.c:934). A keypoint at integer level
    ``is`` has sn < is + 1.5 (|b_s| < 1.5 acceptance), so per-level batches
    get tighter windows; None = octave-wide worst case
    sn < min(s_max, (s_max-2)+1.5)."""
    top = (s_max - 2) if is_level is None else is_level
    sn_max = min(float(s_max), top + 1.5)
    sigma_max = sigma0 * 2.0 ** (sn_max / n_levels)
    return max(int(math.floor(3.0 * 1.5 * sigma_max)), 1)


def _gather_patch(grad_pad: jnp.ndarray, lvl: jnp.ndarray, yc: jnp.ndarray,
                  xc: jnp.ndarray, radius: int):
    """[P, P, 2] patch of the zero-padded grad field centered at (yc, xc)
    of level lvl. grad_pad: [L, H+2R, W+2R, 2] padded with R >= radius."""
    p = 2 * radius + 1
    return jax.lax.dynamic_slice(
        grad_pad, (lvl, yc, xc, 0),
        (1, p, p, 2))[0]


@partial(jax.jit, static_argnames=("radius", "n_bins", "max_angles", "winf"))
def orientation_histograms(grad_pad: jnp.ndarray, lvl_idx: jnp.ndarray,
                           x: jnp.ndarray, y: jnp.ndarray, sigma: jnp.ndarray,
                           valid: jnp.ndarray, w: int | jnp.ndarray,
                           h: int | jnp.ndarray,
                           radius: int, n_bins: int = 36,
                           max_angles: int = 4, winf: float = 1.5):
    """Keypoint orientations (sift.c:904-1036), vmapped.

    grad_pad: [L, H+2R, W+2R, 2] zero-padded polar gradient (R = radius).
    lvl_idx: [N] gradient-level index (is - s_min - 1); x, y, sigma: [N]
    octave-local coordinates (already divided by xper).
    Returns (angles [N, max_angles], angle_valid [N, max_angles]).
    """
    n = x.shape[0]
    p = 2 * radius + 1

    xi = jnp.floor(x + 0.5).astype(jnp.int32)   # (int)(x + 0.5) for x >= 0
    yi = jnp.floor(y + 0.5).astype(jnp.int32)

    in_bounds = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    ok = valid & in_bounds
    xi_c = jnp.clip(xi, 0, w - 1)
    yi_c = jnp.clip(yi, 0, h - 1)

    patches = jax.vmap(lambda l, yy, xx: _gather_patch(grad_pad, l, yy, xx, radius))(
        lvl_idx, yi_c, xi_c)                      # [N, P, P, 2]
    mod = patches[..., 0]
    ang = patches[..., 1]

    dyx = jnp.arange(p, dtype=jnp.float32) - radius    # ys/xs offsets
    xs = dyx[None, None, :]                             # [1, 1, P]
    ys = dyx[None, :, None]                             # [1, P, 1]
    dx = (xi_c.astype(jnp.float32)[:, None, None] + xs) - x[:, None, None]
    dy = (yi_c.astype(jnp.float32)[:, None, None] + ys) - y[:, None, None]
    r2 = dx * dx + dy * dy

    sigmaw = winf * sigma                               # [N]
    wr = jnp.maximum(jnp.floor(3.0 * sigmaw), 1.0)      # per-kp W
    # pixel participates if |xs|<=W, |ys|<=W, in-image, r2 < W^2 + 0.6
    img_x = xi_c[:, None, None] + xs.astype(jnp.int32)
    img_y = yi_c[:, None, None] + ys.astype(jnp.int32)
    sel = (jnp.abs(xs) <= wr[:, None, None]) & (jnp.abs(ys) <= wr[:, None, None]) \
        & (img_x >= 0) & (img_x <= w - 1) & (img_y >= 0) & (img_y <= h - 1) \
        & (r2 < wr[:, None, None] ** 2 + 0.6)

    wgt = jnp.exp(-r2 / (2.0 * sigmaw[:, None, None] ** 2))
    mw = jnp.where(sel, mod * wgt, 0.0).reshape(n, p * p)

    fbin = (n_bins * ang / TWO_PI).reshape(n, p * p)
    b0 = jnp.floor(fbin - 0.5)
    rbin = fbin - b0 - 0.5
    i1 = jnp.mod(b0.astype(jnp.int32) + n_bins, n_bins)
    i2 = jnp.mod(b0.astype(jnp.int32) + 1 + n_bins, n_bins)
    oh1 = jax.nn.one_hot(i1, n_bins, dtype=jnp.float32)
    oh2 = jax.nn.one_hot(i2, n_bins, dtype=jnp.float32)
    hist = jnp.einsum("np,npb->nb", mw * (1.0 - rbin), oh1,
                      precision=jax.lax.Precision.HIGHEST) \
        + jnp.einsum("np,npb->nb", mw * rbin, oh2,
                     precision=jax.lax.Precision.HIGHEST)

    return orientation_peaks(hist, ok, n_bins, max_angles)


_PEAK_OPS: dict = {}


def _peak_operators(n_bins: int):
    """Precomposed circulant operators for orientation_peaks: the 6
    rounds of circular [1,1,1]/3 smoothing are one linear map C6; the
    +-1 circular shifts of the smoothed histogram compose into C6 @ R.
    Applied as [N, n_bins] @ [n_bins, n_bins] matmuls at HIGHEST
    precision instead of 14 iterated jnp.roll passes over the 36-wide
    minor axis (the same linear operator evaluated in a different f32
    summation order)."""
    import numpy as np

    if n_bins in _PEAK_OPS:
        return _PEAK_OPS[n_bins]
    eye = np.eye(n_bins, dtype=np.float64)
    k3 = (np.roll(eye, 1, axis=0) + eye + np.roll(eye, -1, axis=0)) / 3.0
    c6 = np.linalg.matrix_power(k3, 6)
    rm = np.roll(eye, 1, axis=1)     # (h @ rm)[j] = h[(j-1) % n]
    rp = np.roll(eye, -1, axis=1)    # (h @ rp)[j] = h[(j+1) % n]
    tri = np.triu(np.ones((n_bins, n_bins)))   # inclusive prefix-sum
    # cache NUMPY constants (device conversion happens per trace — a
    # cached jnp array created under jit would leak its tracer)
    ops = tuple(m.astype(np.float32) for m in (c6, c6 @ rm, c6 @ rp, tri))
    _PEAK_OPS[n_bins] = ops
    return ops


def orientation_peaks(hist: jnp.ndarray, ok: jnp.ndarray, n_bins: int = 36,
                      max_angles: int = 4):
    """Histogram smoothing + peak extraction (sift.c:1000-1032), shared by
    the XLA and Pallas histogram builders. hist: [N, n_bins] raw histograms,
    ok: [N] keypoint acceptance. Returns (angles [N, max_angles], valid)."""
    n = hist.shape[0]
    c6, c6m, c6p, tri = _peak_operators(n_bins)
    mm = lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)
    # 6 rounds of circular [1,1,1]/3 smoothing (sift.c:1000-1011) and the
    # +-1 neighbors, as three precomposed-circulant matmuls
    raw = hist
    hist = mm(raw, c6)
    hm = mm(raw, c6m)
    hp = mm(raw, c6p)

    hmax = jnp.max(hist, axis=1, keepdims=True)
    is_peak = (hist > 0.8 * hmax) & (hist > hm) & (hist > hp)

    di = -0.5 * (hp - hm) / jnp.where(is_peak, hp + hm - 2 * hist, 1.0)
    bins = jnp.arange(n_bins, dtype=jnp.float32)[None, :]
    th = TWO_PI * (bins + di + 0.5) / n_bins

    # keep the first max_angles peaks in bin order (sift.c:1018-1032);
    # the inclusive prefix count is exact in f32 (0/1 sums <= n_bins)
    rank = mm(is_peak.astype(jnp.float32), tri).astype(jnp.int32)
    keep = is_peak & (rank <= max_angles) & ok[:, None]
    # compact each row's kept angles to the front
    order = jnp.where(keep, rank - 1, max_angles + 1)
    angles = jnp.zeros((n, max_angles), jnp.float32)
    avalid = jnp.zeros((n, max_angles), bool)
    for a in range(max_angles):
        sel_a = order == a
        angles = angles.at[:, a].set(jnp.sum(jnp.where(sel_a, th, 0.0), axis=1))
        avalid = avalid.at[:, a].set(jnp.any(sel_a, axis=1))
    return angles, avalid


# ---------------------------------------------------------------- descriptor
def desc_patch_radius(sigma0: float, n_levels: int, s_max: int,
                      magnif: float = 3.0, nbp: int = 4,
                      is_level: int | None = None) -> int:
    """Static bound for the descriptor window radius
    W = floor(sqrt(2) * SBP * (NBP+1)/2 + 0.5) (sift.c:1310-1311); see
    ori_patch_radius for the per-level tightening."""
    top = (s_max - 2) if is_level is None else is_level
    sn_max = min(float(s_max), top + 1.5)
    sigma_max = sigma0 * 2.0 ** (sn_max / n_levels)
    sbp = magnif * sigma_max
    return int(math.floor(math.sqrt(2.0) * sbp * (nbp + 1) / 2.0 + 0.5))


def _descriptor_one(grad_pad: jnp.ndarray, lvl: jnp.ndarray, x: jnp.ndarray,
                    y: jnp.ndarray, sigma: jnp.ndarray, angle0: jnp.ndarray,
                    w, h, radius: int, magnif: float, window_size: float,
                    nbp: int, nbo: int):
    """One descriptor (sift.c:1268-1438) as a separable contraction."""
    p = 2 * radius + 1
    xi = jnp.floor(x + 0.5).astype(jnp.int32)
    yi = jnp.floor(y + 0.5).astype(jnp.int32)
    xi_c = jnp.clip(xi, 0, w - 1)
    yi_c = jnp.clip(yi, 0, h - 1)

    patch = jax.lax.dynamic_slice(
        grad_pad, (lvl, yi_c, xi_c, 0), (1, p, p, 2))[0]  # [P, P, 2]
    mod = patch[..., 0]
    ang = patch[..., 1]

    st0 = jnp.sin(angle0)
    ct0 = jnp.cos(angle0)
    sbp = magnif * sigma + 2.220446049250313e-16          # VL_EPSILON_D
    wr = jnp.floor(math.sqrt(2.0) * sbp * (nbp + 1) / 2.0 + 0.5)

    offs = jnp.arange(p, dtype=jnp.float32) - radius
    dxi = offs[None, :]                                    # [1, P]
    dyi = offs[:, None]                                    # [P, 1]
    # pixel loop bounds (sift.c:1352-1357): dyi in [max(-W,1-yi), min(W,h-yi-2)]
    sel = (dxi >= jnp.maximum(-wr, 1.0 - xi_c)) & (dxi <= jnp.minimum(wr, w - xi_c - 2.0)) \
        & (dyi >= jnp.maximum(-wr, 1.0 - yi_c)) & (dyi <= jnp.minimum(wr, h - yi_c - 2.0))

    theta = jnp.mod(ang - angle0, TWO_PI)
    dx = xi_c.astype(jnp.float32) + dxi - x
    dy = yi_c.astype(jnp.float32) + dyi - y
    nx = (ct0 * dx + st0 * dy) / sbp
    ny = (-st0 * dx + ct0 * dy) / sbp
    nt = nbo * theta / TWO_PI

    wsigma = window_size
    win = jnp.exp(-(nx * nx + ny * ny) / (2.0 * wsigma * wsigma))
    base = jnp.where(sel, win * mod, 0.0).reshape(p * p)

    half = nbp // 2
    bin_centers = jnp.arange(nbp, dtype=jnp.float32) - half + 0.5  # -1.5..1.5
    # spatial hat: weight of bin b = max(0, 1 - |n - center_b|)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(nx.reshape(p * p)[:, None]
                                        - bin_centers[None, :]))
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(ny.reshape(p * p)[:, None]
                                        - bin_centers[None, :]))
    # circular orientation hat over nbo bins
    tb = jnp.arange(nbo, dtype=jnp.float32)[None, :]
    dt = jnp.abs(nt.reshape(p * p)[:, None] - tb)
    dt = jnp.minimum(dt, nbo - dt)
    wt = jnp.maximum(0.0, 1.0 - dt)

    z = (base[:, None] * wy)[:, :, None] * wx[:, None, :]   # [P2, nbp(y), nbp(x)]
    desc = jnp.einsum("pq,pt->qt", z.reshape(p * p, nbp * nbp), wt,
                      precision=jax.lax.Precision.HIGHEST)  # [16, 8]
    desc = desc.reshape(nbp * nbp * nbo)                    # by*32 + bx*8 + bt

    # guard (sift.c:1321-1329): note descriptor requires yi < h-1
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h - 1)

    # normalize -> clip 0.2 -> renormalize (sift.c:1415-1436)
    norm1 = jnp.sqrt(jnp.sum(desc * desc)) + EPSILON_F
    desc = desc / norm1
    desc = jnp.minimum(desc, 0.2)
    norm2 = jnp.sqrt(jnp.sum(desc * desc)) + EPSILON_F
    desc = desc / norm2
    return jnp.where(ok, desc, 0.0), ok


@partial(jax.jit, static_argnames=("radius", "magnif", "window_size", "nbp",
                                   "nbo", "chunk"))
def descriptors(grad_pad: jnp.ndarray, lvl_idx: jnp.ndarray, x: jnp.ndarray,
                y: jnp.ndarray, sigma: jnp.ndarray, angle: jnp.ndarray,
                valid: jnp.ndarray, w, h, radius: int,
                magnif: float = 3.0, window_size: float = 2.0,
                nbp: int = 4, nbo: int = 8, chunk: int | None = None):
    """Batched descriptors. Inputs are flat keypoint-angle lists (octave-local
    x, y, sigma). Processes in chunks to bound the [chunk, P^2, 16]
    intermediate in HBM (few, large chunks — sequential lax.map steps cost
    latency). Returns (desc [N, 128], ok [N])."""
    n = x.shape[0]
    p = 2 * radius + 1
    if chunk is None:
        # target ~256 MB of [chunk, P^2, 16] f32 intermediate
        chunk = max(128, min(2048, int(2.7e8 / (p * p * 16 * 4))))
    chunk = min(chunk, max(n, 1))
    n_pad = ((n + chunk - 1) // chunk) * chunk

    def pad(a):
        return jnp.pad(a, [(0, n_pad - n)] + [(0, 0)] * (a.ndim - 1))

    lvl_p, x_p, y_p, s_p, a_p = map(pad, (lvl_idx, x, y, sigma, angle))

    fn = jax.vmap(lambda l, xx, yy, ss, aa: _descriptor_one(
        grad_pad, l, xx, yy, ss, aa, w, h, radius, magnif, window_size,
        nbp, nbo))

    def run_chunk(args):
        return fn(*args)

    args = tuple(a.reshape((n_pad // chunk, chunk) + a.shape[1:])
                 for a in (lvl_p, x_p, y_p, s_p, a_p))
    desc, ok = jax.lax.map(run_chunk, args)
    desc = desc.reshape(n_pad, nbp * nbp * nbo)[:n]
    ok = ok.reshape(n_pad)[:n]
    return jnp.where(valid[:, None], desc, 0.0), ok & valid
