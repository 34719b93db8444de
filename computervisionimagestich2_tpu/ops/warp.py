"""Warp / sampling kernels.

Replacements for the reference's per-pixel scalar loops:

- ``bilinear_sample``    <- Projection::bilinearInterpolation
                           (/root/reference/Projection.cpp:3-18)
- ``cylindrical_project``<- Projection::imageProjection
                           (/root/reference/Projection.cpp:20-73)
- ``warp_xy``            <- getX/YAfterWarping (ImageProcess.cpp:465-471)
- ``warp_image``         <- warpingImageByHomography (ImageProcess.cpp:596-606)
- ``shift_image``        <- movingImageByOffset (ImageProcess.cpp:608-620)

All functions are pure, jittable, and operate on dense [H, W, C] float32 arrays
(pixel values 0..255). Instead of the reference's dst-pixel scalar loops
(cimg_forXY), every kernel is a fused elementwise-compute + gather; there
is no data-dependent control flow.

The warp model is the reference's 8-coefficient *bilinear* warp, not a
projective homography (see ImageProcess.h:58-73 — coefficients packed into a
3x3 with H[2][2]=1, applied as x' = w11*x + w12*y + w13*x*y + w21,
y' = w22*x + w23*y + w31*x*y + w32). Coefficients here are a flat (8,) vector
[w11, w12, w13, w21, w22, w23, w31, w32].
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp


def gather_pixels(img: jnp.ndarray, xi: jnp.ndarray, yi: jnp.ndarray) -> jnp.ndarray:
    """Gather img[yi, xi] for integer index arrays. img: [H, W, C] or [H, W]."""
    return img[yi, xi]


def bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample with the reference's exact corner/clamp semantics.

    Matches Projection::bilinearInterpolation (Projection.cpp:3-18):
    x_floor = floor(x); x_ceil = min(ceil(x), W-1) (same for y); the four
    corners are mixed with weights from the fractional parts. Out-of-range
    coordinates are the caller's responsibility (as in the reference). The
    float result is returned un-truncated; callers that need the reference's
    u8 truncation apply :func:`trunc_u8`.

    img: [H, W, C] float32. x, y: broadcastable index arrays (float).
    Returns [..., C].
    """
    h, w = img.shape[0], img.shape[1]
    xf = jnp.floor(x)
    yf = jnp.floor(y)
    xc = jnp.minimum(jnp.ceil(x), w - 1)
    yc = jnp.minimum(jnp.ceil(y), h - 1)
    a = (x - xf)[..., None]
    b = (y - yf)[..., None]

    xf_i = jnp.clip(xf.astype(jnp.int32), 0, w - 1)
    yf_i = jnp.clip(yf.astype(jnp.int32), 0, h - 1)
    xc_i = jnp.clip(xc.astype(jnp.int32), 0, w - 1)
    yc_i = jnp.clip(yc.astype(jnp.int32), 0, h - 1)

    p00 = img[yf_i, xf_i]  # leftdown  (x_floor, y_floor)
    p10 = img[yf_i, xc_i]  # rightdown (x_ceil,  y_floor)
    p11 = img[yc_i, xc_i]  # righttop  (x_ceil,  y_ceil)
    p01 = img[yc_i, xf_i]  # lefttop   (x_floor, y_ceil)

    return ((1 - a) * (1 - b) * p00 + a * (1 - b) * p10
            + a * b * p11 + (1 - a) * b * p01)


def trunc_u8(x: jnp.ndarray) -> jnp.ndarray:
    """C-style float -> unsigned char: truncation toward zero (values are
    in range in the reference; we clamp defensively)."""
    return jnp.clip(jnp.trunc(x), 0.0, 255.0)


def _cyl_portrait_banded(img: jnp.ndarray, angle_deg: float) -> jnp.ndarray:
    """Portrait-orientation cylindrical projection without point gathers.

    The backward map is separable: the source column depends only on the
    output column (x tables are trace-time constants), and the source row is
    linear in the output row with a per-column slope. This formulation
    replaces the point gathers with
    (a) a 0/1-weighted column-selection matmul (exact at HIGHEST
    precision — unit weights select one f32 value), and
    (b) a statically-banded row lerp: per 128-row chunk, the integer row
    offsets span a small range known at trace time, so each candidate is a
    static slice + masked FMA. Whether it beats the plain gather
    (_cylindrical_project_gather) on the GPU is not measured yet.
    """
    h, w = img.shape[0], img.shape[1]
    half_w = w // 2
    half_h = h // 2
    tan_val = math.tan(angle_deg * math.pi / 180.0)
    r = (w / 2.0) / tan_val

    import numpy as np

    jcol = np.arange(w, dtype=np.float64)
    dst_x = jcol - half_w
    k_np = r / np.sqrt(r * r + dst_x * dst_x)
    sx_np = (dst_x / k_np + half_w).astype(np.float32)
    x0_np = np.clip(np.floor(sx_np), 0, w - 1).astype(np.int32)
    x1_np = np.clip(np.minimum(np.ceil(sx_np), w - 1), 0, w - 1).astype(np.int32)

    # device-side row field (f32, identical formula to the reference)
    kj = jnp.asarray(k_np.astype(np.float32))[None, :]
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    dst_y = (rows - half_h).astype(jnp.float32)
    sy = dst_y / kj + half_h
    sxj = jnp.asarray(sx_np)[None, :]
    valid = (sxj >= 0) & (sxj < w) & (sy >= 0) & (sy < h)

    y0 = jnp.floor(sy)
    ay = (sy - y0)[..., None]
    y0c = jnp.clip(y0, 0, h - 1).astype(jnp.int32)
    y1c = jnp.minimum(jnp.ceil(sy), h - 1).astype(jnp.int32)
    y1c = jnp.maximum(y1c, 0)

    # column selection: G[:, v] = img[:, x0[v]] via [W, W] unit matmuls
    cols_u = jax.lax.broadcasted_iota(jnp.int32, (w, w), 0)
    s0 = (cols_u == jnp.asarray(x0_np)[None, :]).astype(jnp.float32)
    s1 = (cols_u == jnp.asarray(x1_np)[None, :]).astype(jnp.float32)
    img_fold = jnp.moveaxis(img, -1, 0).reshape(-1, w)      # [C*H, W]
    g0 = jnp.dot(img_fold, s0, precision=jax.lax.Precision.HIGHEST)
    g1 = jnp.dot(img_fold, s1, precision=jax.lax.Precision.HIGHEST)
    c = img.shape[2]
    g0 = jnp.moveaxis(g0.reshape(c, h, w), 0, -1)           # [H, W, C]
    g1 = jnp.moveaxis(g1.reshape(c, h, w), 0, -1)

    # static band of integer row offsets per row chunk
    f = 1.0 / k_np                                           # [W] >= 1
    fmax = float(f.max())
    chunk = 128
    i_all = np.arange(h, dtype=np.float64)
    dev = (fmax - 1.0) * (i_all - half_h)                    # max |sy - i|
    lo_all = np.floor(np.minimum(dev, 0.0)).astype(int)
    hi_all = np.ceil(np.maximum(dev, 0.0)).astype(int)
    pad_t = int(-lo_all.min()) + 1
    pad_b = int(hi_all.max()) + 2
    g0p = jnp.pad(g0, ((pad_t, pad_b), (0, 0), (0, 0)))
    g1p = jnp.pad(g1, ((pad_t, pad_b), (0, 0), (0, 0)))

    out_chunks = []
    for i0 in range(0, h, chunk):
        i1 = min(i0 + chunk, h)
        dlo = int(lo_all[i0:i1].min())
        dhi = int(hi_all[i0:i1].max()) + 1   # +1: the y1 = y0+1 candidate
        rows_c = rows[i0:i1]
        y0_c, y1_c, ay_c = y0c[i0:i1], y1c[i0:i1], ay[i0:i1]
        acc0 = jnp.zeros((i1 - i0, w, c), jnp.float32)
        acc1 = jnp.zeros((i1 - i0, w, c), jnp.float32)
        for d in range(dlo, dhi + 1):
            wgt = (jnp.where(y0_c - rows_c == d, 1.0, 0.0) * (1.0 - ay_c[..., 0])
                   + jnp.where(y1_c - rows_c == d, 1.0, 0.0) * ay_c[..., 0])
            wgt = wgt[..., None]
            sl0 = jax.lax.slice_in_dim(g0p, i0 + d + pad_t,
                                       i1 + d + pad_t, axis=0)
            sl1 = jax.lax.slice_in_dim(g1p, i0 + d + pad_t,
                                       i1 + d + pad_t, axis=0)
            acc0 = acc0 + wgt * sl0
            acc1 = acc1 + wgt * sl1
        out_chunks.append((acc0, acc1))
    v0 = jnp.concatenate([a for a, _ in out_chunks], axis=0)
    v1 = jnp.concatenate([b for _, b in out_chunks], axis=0)

    ax = (sxj - jnp.floor(sxj))[..., None]
    out = trunc_u8(v0 * (1.0 - ax) + v1 * ax)
    return jnp.where(valid[..., None], out, 0.0)


@partial(jax.jit, static_argnames=("angle_deg",))
def cylindrical_project(img: jnp.ndarray, angle_deg: float = 15.0) -> jnp.ndarray:
    """Cylindrical projection, backward map (Projection.cpp:20-73).

    Exactly reproduces the reference, including its integer-division centers
    (``width / 2`` on ints) and the landscape axis swap. img: [H, W, C]
    float32 in 0..255; returns same shape, out-of-bounds pixels = 0, values
    truncated to u8 grid (the reference stores u8).
    """
    src_h, src_w = img.shape[0], img.shape[1]
    flag = src_w > src_h  # landscape -> swapped axes (Projection.cpp:24)
    width = src_h if flag else src_w
    height = src_w if flag else src_h
    half_w = width // 2    # int division, Projection.cpp:34/54
    half_h = height // 2
    tan_val = math.tan(angle_deg * math.pi / 180.0)
    r = (width / 2.0) / tan_val

    ys = jax.lax.broadcasted_iota(jnp.int32, (src_h, src_w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (src_h, src_w), 1)

    if flag:
        dst_x = (ys - half_w).astype(jnp.float32)
        dst_y = (xs - half_h).astype(jnp.float32)
    else:
        dst_x = (xs - half_w).astype(jnp.float32)
        dst_y = (ys - half_h).astype(jnp.float32)

    k = r / jnp.sqrt(r * r + dst_x * dst_x)
    sx = dst_x / k + half_w
    sy = dst_y / k + half_h

    if flag:
        # landscape = the reference's swapped-axes branch
        # (Projection.cpp:24,41-45): identical to running the portrait map
        # on the transposed image and transposing back
        return jnp.transpose(
            _cyl_portrait_banded(jnp.transpose(img, (1, 0, 2)), angle_deg),
            (1, 0, 2))
    return _cyl_portrait_banded(img, angle_deg)


def _cylindrical_project_gather(img: jnp.ndarray,
                                angle_deg: float = 15.0) -> jnp.ndarray:
    """Direct gather-based form (the reference's per-pixel loop, verbatim);
    kept as the oracle for the banded fast path."""
    src_h, src_w = img.shape[0], img.shape[1]
    flag = src_w > src_h
    width = src_h if flag else src_w
    height = src_w if flag else src_h
    half_w = width // 2
    half_h = height // 2
    tan_val = math.tan(angle_deg * math.pi / 180.0)
    r = (width / 2.0) / tan_val

    ys = jax.lax.broadcasted_iota(jnp.int32, (src_h, src_w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (src_h, src_w), 1)

    if flag:
        dst_x = (ys - half_w).astype(jnp.float32)
        dst_y = (xs - half_h).astype(jnp.float32)
    else:
        dst_x = (xs - half_w).astype(jnp.float32)
        dst_y = (ys - half_h).astype(jnp.float32)

    k = r / jnp.sqrt(r * r + dst_x * dst_x)
    sx = dst_x / k + half_w
    sy = dst_y / k + half_h

    if flag:
        valid = (sx >= 0) & (sx < src_h) & (sy >= 0) & (sy < src_w)
        sample_x, sample_y = sy, sx
    else:
        valid = (sx >= 0) & (sx < src_w) & (sy >= 0) & (sy < src_h)
        sample_x, sample_y = sx, sy

    out = trunc_u8(bilinear_sample(img, sample_x, sample_y))
    return jnp.where(valid[..., None], out, 0.0)


def warp_xy(coeffs: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Apply the 8-coefficient bilinear warp (ImageProcess.cpp:465-471).

    coeffs: (8,) [w11,w12,w13,w21,w22,w23,w31,w32].
    Returns (x', y').
    """
    c = coeffs
    xw = c[0] * x + c[1] * y + c[2] * x * y + c[3]
    yw = c[4] * x + c[5] * y + c[6] * x * y + c[7]
    return xw, yw


def projective_xy(coeffs: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Apply a row-major 3x3 homography stored as a flat (9,) vector — the
    'correct mode' alternative to the reference's bilinear warp (the report
    describes DLT, 16340028.md §DLT; the code ships the bilinear model)."""
    c = coeffs
    den = c[6] * x + c[7] * y + c[8]
    den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    return ((c[0] * x + c[1] * y + c[2]) / den,
            (c[3] * x + c[4] * y + c[5]) / den)


def warp_points(coeffs: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                model: str = "bilinear"):
    """Model-dispatching point warp: 'bilinear' (8 coeffs, reference
    behavior) or 'projective' (9 coeffs)."""
    if model == "bilinear":
        return warp_xy(coeffs, x, y)
    if model == "projective":
        return projective_xy(coeffs, x, y)
    raise ValueError(model)


@partial(jax.jit, static_argnames=("out_shape", "model"))
def warp_image(src: jnp.ndarray, coeffs: jnp.ndarray,
               offset_x: jnp.ndarray, offset_y: jnp.ndarray,
               out_shape: tuple[int, int] | None = None,
               out: jnp.ndarray | None = None,
               model: str = "bilinear") -> jnp.ndarray:
    """Inverse-warp src onto a canvas (warpingImageByHomography,
    ImageProcess.cpp:596-606).

    For each canvas pixel (x, y): (nx, ny) = warp(x+ox, y+oy), truncated
    toward zero to ints (the reference assigns the warped floats to ``int``).
    In-bounds pixels copy src[ny, nx] (the reference calls bilinear
    interpolation with integer coords, which reduces to a direct read);
    out-of-bounds pixels take the existing canvas value (0 on a fresh canvas).

    Provide either ``out`` (a canvas to fill) or ``out_shape`` (H, W).
    """
    if out is None:
        assert out_shape is not None
        out = jnp.zeros(out_shape + (src.shape[2],), dtype=src.dtype)
    h, w = out.shape[0], out.shape[1]
    src_h, src_w = src.shape[0], src.shape[1]

    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0).astype(jnp.float32)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1).astype(jnp.float32)
    xw, yw = warp_points(coeffs, xs + offset_x, ys + offset_y, model)
    nx = jnp.trunc(xw).astype(jnp.int32)   # C float->int truncation
    ny = jnp.trunc(yw).astype(jnp.int32)
    valid = (nx >= 0) & (nx < src_w) & (ny >= 0) & (ny < src_h)
    nx_c = jnp.clip(nx, 0, src_w - 1)
    ny_c = jnp.clip(ny, 0, src_h - 1)
    vals = src[ny_c, nx_c]
    return jnp.where(valid[..., None], vals, out)


@partial(jax.jit, static_argnames=("out_shape",))
def shift_image(src: jnp.ndarray, offset_x: jnp.ndarray, offset_y: jnp.ndarray,
                out: jnp.ndarray | None = None,
                out_shape: tuple[int, int] | None = None) -> jnp.ndarray:
    """Offset copy without interpolation (movingImageByOffset,
    ImageProcess.cpp:608-620). offset_* are ints (the reference truncates the
    float canvas offsets at the call site, ImageProcess.cpp:224).

    Pass ``out_shape`` to build the zero canvas on device (a host-built
    canvas would ride the host->device link every stitch edge)."""
    if out is None:
        assert out_shape is not None
        out = jnp.zeros(out_shape + (src.shape[2],), dtype=src.dtype)
    h, w = out.shape[0], out.shape[1]
    src_h, src_w = src.shape[0], src.shape[1]
    # A translation is a pad + ONE dynamic_slice instead of the obvious 2D
    # point gather (src[ys + oy, xs + ox]). Padding by h/w on BOTH sides
    # keeps the slice start in-range for every offset with any overlap
    # (offset in [-h, src_h] x [-w, src_w]); outside that range
    # dynamic_slice clamps, but then EVERY output pixel fails the validity
    # test below, so the clamped (wrong-position) copy is masked away.
    oy = jnp.asarray(offset_y, jnp.int32)
    ox = jnp.asarray(offset_x, jnp.int32)
    padded = jnp.pad(src, ((h, h), (w, w), (0, 0)))
    vals = jax.lax.dynamic_slice(
        padded, (oy + h, ox + w, jnp.int32(0)), (h, w, src.shape[2]))
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    valid = ((xs + ox >= 0) & (xs + ox < src_w)
             & (ys + oy >= 0) & (ys + oy < src_h))
    return jnp.where(valid[..., None], vals, out)


# --------------------------------------------------------- banded warp path
def banded_warp_params(coeffs, out_shape, offset_x: float, offset_y: float,
                       src_shape, model: str = "bilinear", tile: int = 128,
                       buckets=(2, 4, 8, 16)):
    """Host-side planner for :func:`warp_image_banded`.

    Checks, per output tile, that the warp's deviation from a pure
    row/column translation stays within a small static band (the bilinear
    warp is bilinear in (x, y), so per-tile extrema sit on tile corners).
    Returns (dy, dx) bucketed band sizes, or None when the warp is too
    distorted for the banded kernel (caller falls back to the gather form).
    """
    import numpy as np

    c = np.asarray(coeffs, np.float64)
    h_out, w_out = out_shape
    nti = -(-h_out // tile)
    ntj = -(-w_out // tile)
    i0 = np.arange(nti) * tile
    j0 = np.arange(ntj) * tile
    if model == "bilinear":
        # bilinear in (x, y): per-tile extrema of the continuous deviation
        # field provably sit on the 4 tile corners
        off_i = np.array([0, 0, tile - 1, tile - 1])
        off_j = np.array([0, tile - 1, 0, tile - 1])
        ys = (i0[:, None, None] + off_i[None, None, :] + offset_y)
        xs = (j0[None, :, None] + off_j[None, None, :] + offset_x)
        ys = np.broadcast_to(ys, (nti, ntj, len(off_i)))
        xs = np.broadcast_to(xs, (nti, ntj, len(off_j)))
        xw = c[0] * xs + c[1] * ys + c[2] * xs * ys + c[3]
        yw = c[4] * xs + c[5] * ys + c[6] * xs * ys + c[7]
        # deviation from the per-tile translation predictor
        ri = ys - ys[..., :1]
        rj = xs - xs[..., :1]
        dev_y = (yw - ri) - (yw - ri).min(-1, keepdims=True)
        dev_x = (xw - rj) - (xw - rj).min(-1, keepdims=True)
        need_y = float(dev_y.max()) + 2.0   # trunc + corner-margin slack
        need_x = float(dev_x.max()) + 2.0
    elif model == "projective":
        # rational map: extrema need not sit on corners or any sampled
        # grid, so evaluate EVERY pixel the kernel will see (chunked per
        # tile-row) — the exact per-tile spread of trunc(warp) - index.
        # A sampled bound can silently undershoot and zero output pixels.
        jfull = j0[0] + np.arange(ntj * tile, dtype=np.float64)
        ii_rel = np.arange(tile, dtype=np.float64)[:, None]
        jj_rel = np.tile(np.arange(tile, dtype=np.float64), ntj)[None, :]
        need_y = need_x = 0.0
        for ti in range(nti):
            ys = (i0[ti] + ii_rel) + offset_y              # [tile, 1]
            xs = jfull[None, :] + offset_x                  # [1, W_pad]
            den = c[6] * xs + c[7] * ys + c[8]
            if (np.any(np.abs(den) < 1e-8)
                    or (den.max() > 0 and den.min() < 0)):
                return None  # horizon crosses the canvas: gather fallback
            xw = (c[0] * xs + c[1] * ys + c[2]) / den
            yw = (c[3] * xs + c[4] * ys + c[5]) / den
            ny_rel = (np.trunc(yw) - ii_rel).reshape(tile, ntj, tile)
            nx_rel = (np.trunc(xw) - jj_rel).reshape(tile, ntj, tile)
            need_y = max(need_y, float(
                (ny_rel.max((0, 2)) - ny_rel.min((0, 2))).max()))
            need_x = max(need_x, float(
                (nx_rel.max((0, 2)) - nx_rel.min((0, 2))).max()))
        # the kernel computes in f32; a trunc boundary can flip by 1
        need_y += 1.0
        need_x += 1.0
    else:
        return None
    for by in buckets:
        if need_y <= by:
            break
    else:
        return None
    for bx in buckets:
        if need_x <= bx:
            break
    else:
        return None
    return int(by), int(bx)


def plan_edge_warp(coeffs, out_shape, offset_x: float, offset_y: float,
                   src_shape, model: str = "bilinear", tile: int = 128):
    """Host planner choosing the warp for one edge: ("banded", dy, dx)
    when the shift-select kernel's band fits (banded_warp_params), else
    None -> the point-gather warp_image."""
    bands = banded_warp_params(coeffs, out_shape, offset_x, offset_y,
                               src_shape, model, tile)
    if bands is None:
        return None
    return ("banded", bands[0], bands[1])


@partial(jax.jit, static_argnames=("out_shape", "dy", "dx", "tile",
                                   "model"))
def warp_image_banded(src: jnp.ndarray, coeffs: jnp.ndarray,
                      offset_x: jnp.ndarray, offset_y: jnp.ndarray,
                      out_shape: tuple[int, int], dy: int, dx: int,
                      tile: int = 128, model: str = "bilinear") -> jnp.ndarray:
    """Gather-free :func:`warp_image` for near-translation bilinear warps.

    For panorama edges the warp deviates from a translation by only a few
    pixels per 128x128 tile, so each output tile reads one
    dynamically-offset [T+dy, T+dx] source window and reduces over
    (dy+1)*(dx+1) statically-shifted masked copies — elementwise selects
    instead of point gathers. Host must validate the band via
    :func:`banded_warp_params`. Semantics are identical to warp_image
    (trunc-to-int nearest read, zero canvas).
    """
    h_out, w_out = out_shape
    src_h, src_w, nch = src.shape
    t = tile
    pad = t + max(dy, dx)
    # channels-first: [C, H, W] keeps the tile's two image axes minor
    src_cf = jnp.moveaxis(src, -1, 0)
    src_pad = jnp.pad(src_cf, ((0, 0), (pad, pad), (pad, pad)))
    nti = -(-h_out // t)
    ntj = -(-w_out // t)

    ii = jax.lax.broadcasted_iota(jnp.int32, (t, t), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (t, t), 1)

    def one_tile(_, idx):
        i0 = idx[0] * t
        j0 = idx[1] * t
        ys = (ii + i0).astype(jnp.float32) + offset_y
        xs = (jj + j0).astype(jnp.float32) + offset_x
        xw, yw = warp_points(coeffs, xs, ys, model)
        nx = jnp.trunc(xw).astype(jnp.int32)
        ny = jnp.trunc(yw).astype(jnp.int32)
        valid = (nx >= 0) & (nx < src_w) & (ny >= 0) & (ny < src_h)

        # anchor of the per-tile translation predictor ny ~ ii + const:
        # minimizing (ny - ii) keeps del_y in [0, dy] for any local scale
        ny_min = jnp.min(ny - ii)
        nx_min = jnp.min(nx - jj)
        base_y = jnp.clip(ny_min + pad, 0, src_pad.shape[1] - (t + dy))
        base_x = jnp.clip(nx_min + pad, 0, src_pad.shape[2] - (t + dx))
        s = jax.lax.dynamic_slice(
            src_pad, (0, base_y, base_x), (nch, t + dy, t + dx))

        del_y = ny + pad - base_y - ii
        del_x = nx + pad - base_x - jj
        out_t = jnp.zeros((nch, t, t), jnp.float32)
        for d in range(dy + 1):
            rm = valid & (del_y == d)
            srow = jax.lax.slice_in_dim(s, d, d + t, axis=1)
            for e in range(dx + 1):
                m = rm & (del_x == e)
                se = jax.lax.slice_in_dim(srow, e, e + t, axis=2)
                out_t = out_t + jnp.where(m[None], se, 0.0)
        return _, out_t

    idxs = jnp.stack(jnp.meshgrid(jnp.arange(nti), jnp.arange(ntj),
                                  indexing="ij"), axis=-1).reshape(-1, 2)
    _, tiles = jax.lax.scan(one_tile, 0, idxs)
    out = tiles.reshape(nti, ntj, nch, t, t)
    out = jnp.moveaxis(out, 2, 4)                 # [nti, ntj, t, t, C]
    out = out.transpose(0, 2, 1, 3, 4).reshape(nti * t, ntj * t, nch)
    return out[:h_out, :w_out]
