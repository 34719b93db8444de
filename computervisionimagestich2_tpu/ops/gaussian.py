"""Separable Gaussian smoothing.

Replacement for VLFeat's column convolution pair
(_vl_sift_smooth -> vl_imconvcol_vf x2, /root/reference/vl/sift.c:115-159,
/root/reference/vl/imopv.c) and for CImg's recursive blur used by the blend
pyramid (CImg.h get_blur -> vanvliet; approximated here by an equivalent FIR
Gaussian — parity is within blend tolerance).

The filter taps follow VLFeat exactly (vl/sift.c:124-141):
    W = max(ceil(4*sigma), 1); taps[j] = exp(-0.5 * ((j-W)/sigma)^2), normalized.
Padding is by continuity (edge replication), matching VL_PAD_BY_CONTINUITY.

Implementation: the 1-D convolutions are static shift-and-add passes over
the rows/columns that XLA fuses with the surrounding elementwise work.
Inputs are [H, W] or [N, H, W] float32 (a batch of scale-space levels is one
array).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


def gauss_taps(sigma: float) -> np.ndarray:
    """VLFeat's normalized Gaussian taps (vl/sift.c:124-141)."""
    w = max(math.ceil(4.0 * sigma), 1)
    j = np.arange(2 * w + 1, dtype=np.float32)
    d = (j - w) / np.float32(sigma)
    taps = np.exp(-0.5 * d * d).astype(np.float32)
    return taps / taps.sum()


def _conv1d_lastdim(x: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Correlate along the last dim with edge-replicate padding.

    x: [..., L]. taps: [K] (symmetric). Returns same shape.

    Implemented as a static shift-and-add over the taps (K fused
    multiply-adds on full-width slices); K is small (9..39). Whether a
    lax.conv with C_in=1 is faster on the GPU is not measured.
    """
    return _conv1d_axis(x, taps, -1)


def _conv1d_axis(x: jnp.ndarray, taps: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Correlate along ``axis`` with edge-replicate padding — the same
    shift-and-add, sliced along the requested axis. The H pass runs as
    row-shifted slices directly instead of a swapaxes(-1, -2) round trip,
    which would copy the canvas twice per blur."""
    taps = taps.astype(x.dtype)  # keep reduced-precision inputs reduced
    k = taps.shape[0]
    r = (k - 1) // 2
    axis = axis % x.ndim
    length = x.shape[axis]
    pad_cfg = [(0, 0)] * x.ndim
    pad_cfg[axis] = (r, r)
    xp = jnp.pad(x, pad_cfg, mode="edge")
    out = None
    for j in range(k):
        term = taps[j] * jax.lax.slice_in_dim(xp, j, j + length, axis=axis)
        out = term if out is None else out + term
    return out


@partial(jax.jit, static_argnames=("sigma",))
def gaussian_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur with VLFeat tap/padding semantics.

    img: [..., H, W] float32 (leading dims are batched). sigma is static, so
    each distinct sigma compiles one fused kernel (the scale-space sigmas are
    all known at trace time, unlike the reference's runtime filter cache at
    vl/sift.c:125).
    """
    taps = jnp.asarray(gauss_taps(sigma))
    out = _conv1d_axis(img, taps, -1)                # along W (x), lane shifts
    return _conv1d_axis(out, taps, -2)               # along H (y), row shifts


# ------------------------------------------------------- Van Vliet (CImg)
def _vanvliet_coefs(sigma: float):
    """CImg's Van Vliet coefficients (CImg.h:35053-35065, doubles)."""
    import numpy as np

    nsigma = max(float(sigma), 0.5)
    m0, m1, m2 = 1.16680, 1.10783, 1.40586
    m1sq, m2sq = m1 * m1, m2 * m2
    q = (-0.2568 + 0.5784 * nsigma + 0.0561 * nsigma * nsigma
         if nsigma < 3.556 else 2.5091 + 0.9804 * (nsigma - 3.556))
    qsq = q * q
    scale = (m0 + q) * (m1sq + m2sq + 2 * m1 * q + qsq)
    b1 = -q * (2 * m0 * m1 + m1sq + m2sq + (2 * m0 + 4 * m1) * q
               + 3 * qsq) / scale
    b2 = qsq * (m0 + 2 * m1 + 3 * q) / scale
    b3 = -qsq * q / scale
    big_b = (m0 * (m1sq + m2sq)) / scale
    return np.float64(big_b), np.float64(-b1), np.float64(-b2), np.float64(-b3)


def _triggs_matrix(f1, f2, f3):
    """B. Triggs' boundary matrix (CImg.h:34893-34902)."""
    import numpy as np

    a1, a2, a3 = f1, f2, f3
    scale_m = 1.0 / ((1.0 + a1 - a2 + a3) * (1.0 - a1 - a2 - a3)
                     * (1.0 + a2 + (a1 - a3) * a3))
    m = np.empty(9)
    m[0] = scale_m * (-a3 * a1 + 1.0 - a3 * a3 - a2)
    m[1] = scale_m * (a3 + a1) * (a2 + a3 * a1)
    m[2] = scale_m * a3 * (a1 + a3 * a2)
    m[3] = scale_m * (a1 + a3 * a2)
    m[4] = -scale_m * (a2 - 1.0) * (a2 + a3 * a1)
    m[5] = -scale_m * a3 * (a3 * a1 + a3 * a3 + a2 - 1.0)
    m[6] = scale_m * (a3 * a1 + a2 + a1 * a1 - a2 * a2)
    m[7] = scale_m * (a1 * a2 + a3 * a2 * a2 - a1 * a3 * a3
                      - a3 * a3 * a3 - a3 * a2 + a3)
    m[8] = scale_m * a3 * (a1 + a3 * a2)
    return m


def vanvliet_blur_axis(x: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """CImg vanvliet(sigma, order=0, boundary=Neumann) along the LAST axis
    (CImg.h:34887-34933, 35045-35093) — forward IIR, Triggs right-boundary
    correction, backward IIR. Matches the C double-precision loop to f32
    tolerance."""
    import numpy as np

    if float(sigma) < 0.5:
        return x
    big_b, f1, f2, f3 = _vanvliet_coefs(sigma)
    m = _triggs_matrix(f1, f2, f3)
    sum_sq = big_b * big_b
    a_np = np.array([[f1, f2, f3], [1, 0, 0], [0, 1, 0]], np.float32)
    a_mat = jnp.asarray(a_np)
    n = x.shape[-1]

    # forward: v[n] = x[n] + f1 v[n-1] + ... ; v[<0] = x[0]/B
    v_init = jnp.repeat(x[..., :1] / np.float32(big_b), 3, axis=-1)
    v = _affine_scan_batched(x, a_mat, v_init)

    # Triggs boundary at the right edge (CImg.h:34913-34921). The val[k]
    # states after the forward pass are v[n-k] for k <= n; for shorter axes
    # (n < 3) the missing states are the Neumann init x[0]/B itself
    # (CImg.h:34910 "val[k] = *data/sumsq").
    denom = np.float32(1.0 - f1 - f2 - f3)
    uplus = x[..., -1] / denom
    vplus = uplus / denom
    states = [v[..., n - k] if k <= n else v_init[..., 0]
              for k in (1, 2, 3)]
    unp = states[0] - uplus
    unp1 = states[1] - uplus
    unp2 = states[2] - uplus
    y_last = ((m[0] * unp + m[1] * unp1 + m[2] * unp2 + vplus)
              * np.float32(sum_sq))
    y_n = ((m[3] * unp + m[4] * unp1 + m[5] * unp2 + vplus)
           * np.float32(sum_sq))
    y_n1 = ((m[6] * unp + m[7] * unp1 + m[8] * unp2 + vplus)
            * np.float32(sum_sq))

    # backward: y[m] = B^2 v[m] + f1 y[m+1] + f2 y[m+2] + f3 y[m+3]
    if n == 1:
        # the backward loop runs n-1 = 0 iterations (CImg.h:34922-34931)
        return y_last[..., None]
    rev = jnp.flip(v[..., :-1] * np.float32(sum_sq), axis=-1)
    y_init = jnp.stack([y_last, y_n, y_n1], axis=-1)
    y_rev = _affine_scan_batched(rev, a_mat, y_init)
    return jnp.concatenate(
        [jnp.flip(y_rev, axis=-1), y_last[..., None]], axis=-1)


def _affine_scan_batched(x_terms: jnp.ndarray, a_mat: jnp.ndarray,
                         s_init: jnp.ndarray) -> jnp.ndarray:
    """s[n] = A s[n-1] + e0 * x[n] for x [..., N], init [..., 3]."""
    n = x_terms.shape[-1]
    zeros = jnp.zeros_like(x_terms)
    bs = jnp.stack([x_terms, zeros, zeros], axis=-1)          # [..., N, 3]
    # the scan composes 3x3 affine maps; HIGHEST keeps them f32 on the
    # GPU (TF32 would break the Van Vliet filter's parity with CImg)
    b0 = bs[..., 0, :] + jnp.einsum("ij,...j->...i", a_mat, s_init,
                                    precision=_HIGHEST)
    bs = bs.at[..., 0, :].set(b0)
    a_all = jnp.broadcast_to(a_mat, x_terms.shape[:-1] + (n, 3, 3))

    def combine(l, r):
        a1, b1 = l
        a2, b2 = r
        return (jnp.matmul(a2, a1, precision=_HIGHEST),
                jnp.einsum("...ij,...j->...i", a2, b1,
                           precision=_HIGHEST) + b2)

    _, ss = jax.lax.associative_scan(combine, (a_all, bs), axis=-3)
    return ss[..., 0]


def vanvliet_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """CImg get_blur(sigma, true, true): vanvliet along x then y, skipping
    size-1 axes exactly like blur()'s _width>1/_height>1 guards
    (CImg.h:35113-35116). img: [..., H, W]."""
    out = img
    if img.shape[-1] > 1:
        out = vanvliet_blur_axis(out, sigma)
    if img.shape[-2] > 1:
        out = jnp.swapaxes(
            vanvliet_blur_axis(jnp.swapaxes(out, -1, -2), sigma), -1, -2)
    return out
