"""Resize kernels with CImg-exact semantics, expressed as matmuls.

The reference's blend pyramid calls CImg get_resize(..., interpolation=3)
(/root/reference/ImageProcess.cpp:709-715,731,764). CImg's "linear" mode
actually dispatches per-dimension:

- shrinking  -> mode 2, an overlap-weighted moving average
  (CImg.h:29539-29556): output pixel t averages source pixels with weights
  proportional to interval overlap on the common w_src*w_dst grid.
- enlarging  -> true linear interpolation with origin-aligned mapping
  (CImg.h:29618-29654): pos(x) = min(x * w_src / w_dst, w_src - 1),
  out[x] = lerp(src[floor(pos)], src[floor(pos)+1], frac(pos)).

Both are linear maps, so we precompute (host-side, per static shape pair) a
sparse row-stochastic weight matrix and apply it as a dense matmul — the
vectorized form of CImg's per-pixel pointer walk. The matrices are tiny
(pyramid dims), and XLA folds the pair of matmuls with neighbors.

VLFeat's scale-space decimation (copy_and_downsample, vl/sift.c:178-194) is
plain stride-2 point sampling and is implemented directly.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def _resize_weights(n_src: int, n_dst: int) -> np.ndarray:
    """CImg per-dimension resize weights: [n_dst, n_src], rows sum to 1."""
    w = np.zeros((n_dst, n_src), dtype=np.float32)
    if n_dst == n_src:
        np.fill_diagonal(w, 1.0)
    elif n_dst < n_src:
        # mode 2: overlap-weighted moving average on the n_src*n_dst grid.
        # Source pixel s covers [s*n_dst, (s+1)*n_dst); dst t covers
        # [t*n_src, (t+1)*n_src); weight = overlap / n_src.
        for t in range(n_dst):
            lo, hi = t * n_src, (t + 1) * n_src
            s0, s1 = lo // n_dst, (hi - 1) // n_dst
            for s in range(s0, s1 + 1):
                ov = min(hi, (s + 1) * n_dst) - max(lo, s * n_dst)
                w[t, s] = ov / n_src
    else:
        # mode 3 enlarge: origin-aligned linear interpolation.
        fx = n_src / n_dst
        for t in range(n_dst):
            pos = min(t * fx, n_src - 1.0)
            i = int(pos)
            a = pos - i
            w[t, i] += 1.0 - a
            w[t, min(i + 1, n_src - 1)] += a
    return w


@lru_cache(maxsize=None)
def _banded_weights(n_src: int, n_dst: int):
    """The resize map in banded form: (idx0 [n_dst], w [n_dst, B]) with
    out[t] = sum_b w[t, b] * src[idx0[t] + b]. O(n) constants instead of the
    O(n^2) dense matrix (which, embedded as an XLA constant, made blend
    programs for wide canvases exceed compile-payload limits)."""
    dense = _resize_weights(n_src, n_dst)
    band = max(int((dense != 0).sum(axis=1).max()), 1)
    idx0 = np.zeros(n_dst, np.int32)
    w = np.zeros((n_dst, band), np.float32)
    for t in range(n_dst):
        nz = np.nonzero(dense[t])[0]
        first = int(nz[0]) if len(nz) else 0
        first = min(first, n_src - band)
        idx0[t] = first
        w[t] = dense[t, first:first + band]
    return idx0, w


def _shrink_half_axis1(img: jnp.ndarray, n_dst: int) -> jnp.ndarray:
    """n_dst == n_src // 2: idx0[t] == 2t exactly (ratio < 2 + 1/n_dst), so
    the banded sum becomes strided slices — no gathers, no O(n^2) matmul."""
    n_src = img.shape[1]
    idx0, w = _banded_weights(n_src, n_dst)
    assert (idx0 == 2 * np.arange(n_dst, dtype=np.int32)).all()
    band = w.shape[1]
    pad_cfg = [(0, 0)] * img.ndim
    pad_cfg[1] = (0, band)
    padded = jnp.pad(img, pad_cfg)
    out = None
    for b in range(band):
        wk = jnp.asarray(w[:, b], img.dtype).reshape(
            (1, n_dst) + (1,) * (img.ndim - 2))
        term = padded[:, b: b + 2 * n_dst: 2] * wk
        out = term if out is None else out + term
    return out


def _enlarge2_axis1(img: jnp.ndarray, n_dst: int) -> jnp.ndarray:
    """n_src == n_dst // 2 (the Laplacian expand): split even/odd output
    columns; each parity reads src[t-1+b] for b in 0..2 — shifted slices."""
    n_src = img.shape[1]
    dense = _resize_weights(n_src, n_dst)
    pad_cfg = [(0, 0)] * img.ndim
    pad_cfg[1] = (1, 2)
    padded = jnp.pad(img, pad_cfg)          # src index i -> padded i+1
    halves = []
    n_half = (n_dst + 1) // 2
    for p in (0, 1):
        rows = dense[p::2]                   # [n_p, n_src]
        n_p = rows.shape[0]
        w = np.zeros((n_half, 3), np.float32)
        for t in range(n_p):
            for b in range(3):
                j = t - 1 + b
                if 0 <= j < n_src:
                    w[t, b] = rows[t, j]
        out_p = None
        for b in range(3):
            wk = jnp.asarray(w[:, b], img.dtype).reshape(
                (1, n_half) + (1,) * (img.ndim - 2))
            term = padded[:, b: b + n_half] * wk
            out_p = term if out_p is None else out_p + term
        halves.append(out_p)
    inter = jnp.stack(halves, axis=2)        # [H, n_half, 2, ...]
    inter = inter.reshape((img.shape[0], 2 * n_half) + img.shape[2:])
    return inter[:, :n_dst]


@lru_cache(maxsize=None)
def _blur_shrink_coefs(n_src: int, n_dst: int, sigma: float):
    """Composite coefficients for (Gaussian FIR blur -> CImg half shrink)
    along one axis, folded into ONE strided stencil:

        out[t] = sum_d C[t, d] * xpad[2*t + d],   xpad = edge-pad(x, r)

    where blur[s] = sum_k g[k] * xpad[s + k] (g = gauss_taps, r = (K-1)/2)
    and out[t] = sum_e bw[t, e] * blur[idx0[t] + e] (the overlap-weighted
    moving average, CImg.h:29539-29556). Mathematically identical to
    blur-then-shrink (float reassociation only), at ~half the multiply-adds
    and with no blurred intermediate materialized.

    Returns (r, C [n_dst, D]) with slice offsets d in [0, D)."""
    from .gaussian import gauss_taps

    g = gauss_taps(sigma)
    k = len(g)
    r = (k - 1) // 2
    idx0, bw = _banded_weights(n_src, n_dst)
    b = bw.shape[1]
    t = np.arange(n_dst)
    dmin = int((idx0 - 2 * t).min())
    assert dmin >= 0, (n_src, n_dst, dmin)
    dmax = int((idx0 + b - 1 - 2 * t).max()) + k - 1
    assert 2 * (n_dst - 1) + dmax <= n_src + 2 * r - 1, (n_src, n_dst)
    c = np.zeros((n_dst, dmax + 1), np.float32)
    for ti in range(n_dst):
        for e in range(b):
            d0 = int(idx0[ti]) + e - 2 * ti
            c[ti, d0:d0 + k] += bw[ti, e] * g
    return r, c


def _blur_shrink_axis(x: jnp.ndarray, n_dst: int, sigma: float,
                      axis: int) -> jnp.ndarray:
    """Apply the composite blur+half-shrink stencil along ``axis``.

    Fast path requires the stencil to be position-INDEPENDENT (n_src even:
    the moving-average weights are a uniform [.5, .5], so every composite
    row is identical) — then each term is a SCALAR-weighted strided slice,
    which XLA fuses into one pass exactly like the blur's shift-and-add.
    The per-position column form (odd n_src) defeats that fusion, so odd
    axes fall back to blur-then-shrink along
    this axis (axis-independent linear maps — mixing fused/unfused per
    axis still computes the same values)."""
    from .gaussian import _conv1d_axis, gauss_taps

    axis = axis % x.ndim
    n_src = x.shape[axis]
    if n_src != 2 * n_dst:
        blurred = _conv1d_axis(x, jnp.asarray(gauss_taps(sigma),
                                              x.dtype), axis)
        if axis == 1:
            return _resize_axis1(blurred, n_dst)
        return jnp.swapaxes(
            _resize_axis1(jnp.swapaxes(blurred, 0, 1), n_dst), 0, 1)
    r, c = _blur_shrink_coefs(n_src, n_dst, float(sigma))
    assert np.allclose(c, c[:1]), "even-dim stencil must be uniform"
    taps = c[0]
    d_len = len(taps)
    # PHASE DECOMPOSITION: out[t] = sum_d taps[d] * xp[2t + d] as one
    # strided slice PER TAP costs one strided pass per tap. Splitting xp into
    # even/odd phases ONCE (two strided slices) turns every tap term into
    # a CONTIGUOUS slice of a phase array — the same shift-and-add
    # structure XLA fuses for the blur — at half the blur's output size:
    #   out[t] = sum_j taps[2j]*even[t+j] + taps[2j+1]*odd[t+j]
    n_half = (d_len + 1) // 2
    length = n_dst + n_half          # max contiguous-slice extent needed
    pad_cfg = [(0, 0)] * x.ndim
    # right pad: the odd phase slices up to xp[2*length - 1]; xp has
    # n_src + 2r elements without the extra pad (padded values land only
    # in the unused tail of the phase arrays)
    extra = max(0, 2 * length - (n_src + 2 * r))
    pad_cfg[axis] = (r, r + extra)
    xp = jnp.pad(x, pad_cfg, mode="edge")
    even = jax.lax.slice_in_dim(xp, 0, 2 * length - 1, stride=2, axis=axis)
    odd = jax.lax.slice_in_dim(xp, 1, 2 * length, stride=2, axis=axis)
    out = None
    for d in range(d_len):
        phase, j = (even, odd)[d % 2], d // 2
        term = jnp.asarray(taps[d], x.dtype) * jax.lax.slice_in_dim(
            phase, j, j + n_dst, axis=axis)
        out = term if out is None else out + term
    return out


def blur_shrink_hwc(img: jnp.ndarray, out_h: int, out_w: int,
                    sigma: float) -> jnp.ndarray:
    """cimg_resize(blur(img, sigma), out_h, out_w) fused, for the blend
    pyramid downsweep: [H, W, C] (or [H, W]), out dims == in dims // 2.
    Axis order matches the unfused pair (blur W-then-H, resize x-then-y;
    all four are linear maps along independent axes, so the composite
    order W-pass-then-H-pass computes the same values)."""
    out = _blur_shrink_axis(img, out_w, sigma, 1)
    return _blur_shrink_axis(out, out_h, sigma, 0)


def _resize_axis1(img: jnp.ndarray, n_dst: int) -> jnp.ndarray:
    """Resize axis 1 of [H, W, ...] with CImg semantics."""
    n_src = img.shape[1]
    if n_src == n_dst:
        return img
    if n_dst == n_src // 2:
        return _shrink_half_axis1(img, n_dst)
    if n_src == n_dst // 2:
        return _enlarge2_axis1(img, n_dst)
    # generic ratio fallback (rare: not used by the blend pyramid)
    idx0, w = _banded_weights(n_src, n_dst)
    idx0 = jnp.asarray(idx0)
    w = jnp.asarray(w, img.dtype)
    out = None
    for b in range(w.shape[1]):
        wk = w[:, b].reshape((1, n_dst) + (1,) * (img.ndim - 2))
        term = jnp.take(img, idx0 + b, axis=1) * wk
        out = term if out is None else out + term
    return out


@partial(jax.jit, static_argnames=("out_h", "out_w"))
def cimg_resize(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """CImg get_resize(out_w, out_h, 1, C, 3) on an [H, W] or [H, W, C] array."""
    # x first, then y (CImg order; result identical for linear maps).
    out = _resize_axis1(img, out_w)
    out = jnp.swapaxes(_resize_axis1(jnp.swapaxes(out, 0, 1), out_h), 0, 1)
    return out


def vlfeat_downsample(img: jnp.ndarray, d: int = 1) -> jnp.ndarray:
    """Stride-2^d point decimation (copy_and_downsample, vl/sift.c:178-194).

    img: [..., H, W]. Output dims: ceil over the reference's loop bounds —
    rows step ``y += d`` over [0, H), cols over [0, W-(d-1)).

    Rows decimate by a strided slice; columns decimate by reshaping the
    minor axis into [n_out, step] blocks and taking element 0 —
    bit-identical to a strided slice of the minor axis."""
    step = 1 << d
    rows = img[..., ::step, :]
    w = img.shape[-1]
    n_out = (w - step) // step + 1
    blocks = rows[..., : step * n_out].reshape(rows.shape[:-1] + (n_out, step))
    return blocks[..., 0]


def vlfeat_upsample_rows(img: jnp.ndarray) -> jnp.ndarray:
    """One application of copy_and_upsample_rows (vl/sift.c:81-101): doubles
    the row length with midpoint interpolation and transposes. Two calls
    double an image (used only when o_min < 0)."""
    # img: [..., H, W] -> [..., W*2, H] after transpose, matching the C code.
    nxt = jnp.concatenate([img[..., :, 1:], img[..., :, -1:]], axis=-1)
    interleaved = jnp.stack([img, 0.5 * (img + nxt)], axis=-1)
    up = interleaved.reshape(img.shape[:-1] + (img.shape[-1] * 2,))
    return jnp.swapaxes(up, -1, -2)
