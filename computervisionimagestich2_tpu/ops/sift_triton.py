"""Per-keypoint SIFT orientation and descriptor kernels for the GPU
(Pallas, Triton route).

The XLA formulation (ops/sift_kernels.py) gathers every keypoint slot's
worst-case window for its level and materializes [cap, P^2, bins]
one-hot and hat tensors in device memory; dead slots cost as much as live
ones. Here one program handles one keypoint:

- it reads its own (x, y, sigma, angle, valid) row;
- it walks its window row by row, reading the level's modulus and angle
  planes straight from device memory (two 1440x1080 f32 planes, about
  12 MB, stay resident in the card's L2 cache), with the loop bounds set
  by the keypoint's own window radius, so its cost follows its scale and
  a dead slot costs one parameter load;
- the 36 orientation bins and the 4x4x8 descriptor bins accumulate in
  registers.

The descriptor's trilinear scatter is the separable contraction of
ops/sift_kernels.py::_descriptor_one, one patch row at a time:
[16, row] x [row, 8] (padded to 16 columns) per row, in f32 (the dot runs
at HIGHEST precision, FMA rather than TF32, so descriptors agree with the
XLA path to f32 summation order). The normalize-clip-renormalize tail and
the orientation peak picking stay in XLA over the whole batch.

Math follows vl_sift_calc_keypoint_orientations and
vl_sift_calc_keypoint_descriptor (vl/sift.c:904-1036, 1268-1438) exactly
as ops/sift_kernels.py re-derives them; ``interpret=True`` runs the same
kernels on the CPU for the tests.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

TWO_PI = 2.0 * math.pi
EPSILON_F = 1.19209290e-07   # VL_EPSILON_F
EPSILON_D = 2.220446049250313e-16
_HIGHEST = jax.lax.Precision.HIGHEST


def _row_width(radius: int) -> int:
    """Columns loaded per patch row: a power of two (Triton block sizes
    are), wide enough that a row starting width // 2 left of the keypoint
    covers [-radius, radius]."""
    return max(16, pl.next_power_of_2(2 * radius + 2))


def _row_cols(xi_c, width: int):
    """First loaded column and the [width] column indices of a patch row.
    The start is clamped to 0 (never negative), and columns past the
    image edge are masked at load time."""
    x0 = jnp.maximum(xi_c - width // 2, 0)
    return x0, x0 + jax.lax.broadcasted_iota(jnp.int32, (width,), 0)


def _load_row(ref, row, x0, cols, w: int, width: int):
    return plt.load(ref.at[row, pl.ds(x0, width)], mask=cols < w,
                    other=0.0)


# ------------------------------------------------------------ orientations
def _ori_kernel(par_ref, mod_ref, ang_ref, out_ref, *, h: int, w: int,
                radius: int, n_bins: int, winf: float, width: int,
                nb_pad: int):
    x = par_ref[0, 0]
    y = par_ref[0, 1]
    sigma = par_ref[0, 2]
    live = par_ref[0, 3] > 0.0
    xi = jnp.floor(x + 0.5).astype(jnp.int32)
    yi = jnp.floor(y + 0.5).astype(jnp.int32)
    xi_c = jnp.clip(xi, 0, w - 1)
    yi_c = jnp.clip(yi, 0, h - 1)
    sigmaw = winf * sigma
    wr = jnp.minimum(jnp.maximum(jnp.floor(3.0 * sigmaw), 1.0),
                     float(radius))
    wri = wr.astype(jnp.int32)
    lo = jnp.maximum(-wri, -yi_c)
    hi = jnp.where(live, jnp.minimum(wri, h - 1 - yi_c), lo - 1)

    x0, cols = _row_cols(xi_c, width)
    dxi = (cols - xi_c).astype(jnp.float32)
    colsel = (jnp.abs(dxi) <= wr) & (cols < w)
    dx = cols.astype(jnp.float32) - x
    bins = jax.lax.broadcasted_iota(jnp.int32, (1, nb_pad), 1)
    binf = bins.astype(jnp.float32)
    two_s2 = 2.0 * sigmaw * sigmaw
    wr2 = wr * wr + 0.6

    def body(dyi, hist):
        row = yi_c + dyi
        m = _load_row(mod_ref, row, x0, cols, w, width)
        a = _load_row(ang_ref, row, x0, cols, w, width)
        dy = row.astype(jnp.float32) - y
        r2 = dx * dx + dy * dy
        sel = colsel & (r2 < wr2)
        mw = jnp.where(sel, m * jnp.exp(-r2 / two_s2), 0.0)
        # bilinear bin split (vl/sift.c:968-985) as a circular hat:
        # fbin - 0.5 sits between its two bins
        f = n_bins * a / TWO_PI - 0.5
        d = jnp.abs(f[:, None] - binf)
        d = jnp.minimum(d, n_bins - d)
        wt = jnp.where(bins < n_bins, jnp.maximum(0.0, 1.0 - d), 0.0)
        return hist + jnp.sum(mw[:, None] * wt, axis=0)

    hist = jax.lax.fori_loop(lo, hi + 1, body,
                             jnp.zeros((nb_pad,), jnp.float32))
    out_ref[0, :] = hist


@partial(jax.jit, static_argnames=("w", "h", "radius", "n_bins", "winf",
                                   "interpret"))
def orientation_hist(mod: jnp.ndarray, ang: jnp.ndarray, x: jnp.ndarray,
                     y: jnp.ndarray, sigma: jnp.ndarray, valid: jnp.ndarray,
                     w: int, h: int, radius: int, n_bins: int = 36,
                     winf: float = 1.5, interpret: bool = False):
    """Raw [N, n_bins] orientation histograms (before smoothing).

    mod/ang: one level's [H, W] gradient modulus and angle planes;
    x, y, sigma: [N] octave-local keypoint coordinates; valid: [N] bool.
    ``radius`` is the level's static window bound (sift_kernels
    .ori_patch_radius). Returns (hist [N, n_bins], ok [N]) — ok as in
    sift_kernels.orientation_histograms (valid and inside the image)."""
    n = x.shape[0]
    width = _row_width(radius)
    nb_pad = pl.next_power_of_2(n_bins)
    xi = jnp.floor(x + 0.5).astype(jnp.int32)
    yi = jnp.floor(y + 0.5).astype(jnp.int32)
    ok = valid & (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    par = jnp.stack([x, y, sigma, ok.astype(jnp.float32)], axis=-1)
    kernel = partial(_ori_kernel, h=h, w=w, radius=radius, n_bins=n_bins,
                     winf=winf, width=width, nb_pad=nb_pad)
    hist = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n, nb_pad), jnp.float32),
        grid=(n,),
        in_specs=[pl.BlockSpec((1, 4), lambda i: (i, 0)),
                  pl.no_block_spec, pl.no_block_spec],
        out_specs=pl.BlockSpec((1, nb_pad), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=2, num_stages=1),
        interpret=interpret,
        name="sift_orientation_hist",
    )(par, mod, ang)
    return hist[:, :n_bins], ok


# ------------------------------------------------------------- descriptors
def _desc_kernel(par_ref, mod_ref, ang_ref, out_ref, *, h: int, w: int,
                 radius: int, magnif: float, window_size: float, nbp: int,
                 nbo: int, width: int):
    x = par_ref[0, 0]
    y = par_ref[0, 1]
    sigma = par_ref[0, 2]
    angle0 = par_ref[0, 3]
    live = par_ref[0, 4] > 0.0
    xi = jnp.floor(x + 0.5).astype(jnp.int32)
    yi = jnp.floor(y + 0.5).astype(jnp.int32)
    xi_c = jnp.clip(xi, 0, w - 1)
    yi_c = jnp.clip(yi, 0, h - 1)
    st0 = jnp.sin(angle0)
    ct0 = jnp.cos(angle0)
    sbp = magnif * sigma + EPSILON_D
    wr = jnp.minimum(
        jnp.floor(math.sqrt(2.0) * sbp * (nbp + 1) / 2.0 + 0.5),
        float(radius))
    wri = wr.astype(jnp.int32)
    # pixel loop bounds (vl/sift.c:1352-1357)
    lo = jnp.maximum(-wri, 1 - yi_c)
    hi = jnp.where(live, jnp.minimum(wri, h - yi_c - 2), lo - 1)

    x0, cols = _row_cols(xi_c, width)
    dxi = (cols - xi_c).astype(jnp.float32)
    colsel = ((dxi >= jnp.maximum(-wr, 1.0 - xi_c.astype(jnp.float32)))
              & (dxi <= jnp.minimum(wr, w - xi_c.astype(jnp.float32) - 2.0))
              & (cols < w))
    dx = cols.astype(jnp.float32) - x
    nc = nbp * nbp
    cell = jax.lax.broadcasted_iota(jnp.int32, (1, nc), 1)
    half = nbp // 2
    cy = (cell // nbp - half).astype(jnp.float32) + 0.5     # bin centres
    cx = (cell % nbp - half).astype(jnp.float32) + 0.5
    tb = jax.lax.broadcasted_iota(jnp.int32, (1, nc), 1)    # 16 >= nbo
    tbf = tb.astype(jnp.float32)
    two_ws2 = 2.0 * window_size * window_size

    def body(dyi, acc):
        row = yi_c + dyi
        m = _load_row(mod_ref, row, x0, cols, w, width)
        a = _load_row(ang_ref, row, x0, cols, w, width)
        dy = row.astype(jnp.float32) - y
        nx = (ct0 * dx + st0 * dy) / sbp
        ny = (-st0 * dx + ct0 * dy) / sbp
        nt = nbo * jnp.mod(a - angle0, TWO_PI) / TWO_PI
        win = jnp.exp(-(nx * nx + ny * ny) / two_ws2)
        base = jnp.where(colsel, win * m, 0.0)
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(ny[:, None] - cy))
        wx = jnp.maximum(0.0, 1.0 - jnp.abs(nx[:, None] - cx))
        z = base[:, None] * wy * wx                          # [width, 16]
        dt = jnp.abs(nt[:, None] - tbf)
        dt = jnp.minimum(dt, nbo - dt)
        wt = jnp.where(tb < nbo, jnp.maximum(0.0, 1.0 - dt), 0.0)
        return acc + pl.dot(z, wt, trans_a=True, precision=_HIGHEST)

    acc = jax.lax.fori_loop(lo, hi + 1, body,
                            jnp.zeros((nc, nc), jnp.float32))
    out_ref[0, :, :] = acc


@partial(jax.jit, static_argnames=("w", "h", "radius", "magnif",
                                   "window_size", "nbp", "nbo", "interpret"))
def descriptors(mod: jnp.ndarray, ang: jnp.ndarray, x: jnp.ndarray,
                y: jnp.ndarray, sigma: jnp.ndarray, angle: jnp.ndarray,
                valid: jnp.ndarray, w: int, h: int, radius: int,
                magnif: float = 3.0, window_size: float = 2.0, nbp: int = 4,
                nbo: int = 8, interpret: bool = False):
    """Descriptor batch, same contract as sift_kernels.descriptors but on
    unpadded [H, W] modulus/angle planes. Returns (desc [N, 128], ok [N])."""
    if nbp * nbp != 16 or nbo > 16:
        raise ValueError("the kernel is laid out for 4x4 spatial bins "
                         "and at most 16 orientation bins")
    n = x.shape[0]
    width = _row_width(radius)
    xi = jnp.floor(x + 0.5).astype(jnp.int32)
    yi = jnp.floor(y + 0.5).astype(jnp.int32)
    # guard (vl/sift.c:1321-1329): the descriptor requires yi < h-1
    ok = valid & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h - 1)
    par = jnp.stack([x, y, sigma, angle, ok.astype(jnp.float32),
                     jnp.zeros_like(x), jnp.zeros_like(x),
                     jnp.zeros_like(x)], axis=-1)
    kernel = partial(_desc_kernel, h=h, w=w, radius=radius, magnif=magnif,
                     window_size=window_size, nbp=nbp, nbo=nbo, width=width)
    raw = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n, 16, 16), jnp.float32),
        grid=(n,),
        in_specs=[pl.BlockSpec((1, 8), lambda i: (i, 0)),
                  pl.no_block_spec, pl.no_block_spec],
        out_specs=pl.BlockSpec((1, 16, 16), lambda i: (i, 0, 0)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="sift_descriptors",
    )(par, mod, ang)
    desc = raw[:, :, :nbo].reshape(n, 16 * nbo)    # by*32 + bx*8 + bt
    # normalize -> clip 0.2 -> renormalize (vl/sift.c:1415-1436)
    norm1 = jnp.sqrt(jnp.sum(desc * desc, axis=1, keepdims=True)) + EPSILON_F
    d = jnp.minimum(desc / norm1, 0.2)
    norm2 = jnp.sqrt(jnp.sum(d * d, axis=1, keepdims=True)) + EPSILON_F
    return jnp.where(ok[:, None], d / norm2, 0.0), ok
