"""Histogram equalization.

Equivalent of class equalization (/root/reference/equalization.cpp):

- gray mode (0):  256-bin histogram -> CDF -> LUT on the 0.2126/0.7152/0.0722
  luma (equalization.cpp:28-72).
- color mode (1, the one the pipeline uses): RGB -> YCbCr (with the 0.857
  luma quirk, equalization.cpp:79), equalize Y only, -> RGB with clamps
  (equalization.cpp:74-131).

Here the histogram is a one-hot reduction (bincount), the CDF a cumsum,
the mapping a 256-entry LUT lookup — one fused kernel, replacing the
reference's three image passes.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.color import rgb_to_ycbcr, ycbcr_to_rgb
from ..ops.warp import trunc_u8


def _radix_onehots(idx: jnp.ndarray):
    """Split u8 indices into exact [-..., 16] one-hots of the high and low
    nibbles. Any 256-way per-pixel operation then factors through two
    16-wide compares + a matmul contraction instead of a 256-wide compare
    loop (16x fewer compares); all values are 0/1 or small integers, exactly
    representable at any matmul precision, so results are bit-identical
    to the 256-wide form."""
    nib = jnp.arange(16, dtype=jnp.int32)
    hi = ((idx >> 4)[..., None] == nib).astype(jnp.float32)
    lo = ((idx & 15)[..., None] == nib).astype(jnp.float32)
    return hi, lo


def _equalize_lut(channel_u8: jnp.ndarray) -> jnp.ndarray:
    """LUT from a u8 channel: mapped[i] = round(255 * cdf[i])
    (equalization.cpp:57-65). The histogram is a radix-16 factored
    one-hot contraction: hist[h*16+l] = sum_p hi[p,h]*lo[p,l] — one
    [16, N] x [N, 16] matmul replaces the N x 256 compare+reduce and a
    scatter-add bincount (which of the three is fastest on the GPU is not
    measured). Counts < 2^24 stay exact in f32, TF32 operands included
    (they are 0/1)."""
    n = channel_u8.size
    vals = channel_u8.astype(jnp.int32).reshape(-1)
    hi, lo = _radix_onehots(vals)
    m = jax.lax.dot_general(hi, lo, (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    hist = m.reshape(256)
    cdf = jnp.cumsum(hist / n)
    return jnp.round(255.0 * cdf)


def _apply_lut(channel_u8: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """mapped = lut[channel] without a per-pixel gather. Radix-16 factored
    form: mapped = sum_{h,l} hi[p,h] * lo[p,l] * lut[h*16+l] — a matmul
    contraction of the high nibble with the [16, 16] LUT, then a 16-wide dot
    with
    the low-nibble one-hot. LUT entries are integers in [0, 255], exact in
    bf16/f32, so this is bit-identical to the 256-wide one-hot (and to the
    gather)."""
    idx = jnp.clip(channel_u8, 0, 255).astype(jnp.int32)
    hi, lo = _radix_onehots(idx)
    lut2 = lut.reshape(16, 16).astype(jnp.float32)
    ndim = hi.ndim
    tmp = jax.lax.dot_general(
        hi, lut2, (((ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    return jnp.sum(tmp * lo, axis=-1)


@partial(jax.jit, static_argnames=("compat_luma",))
def equalize_color(img: jnp.ndarray, compat_luma: bool = True) -> jnp.ndarray:
    """Color-mode equalization (mode=1). img: [H, W, 3] float32 u8-valued RGB.
    Returns the equalized RGB image on the u8 grid."""
    ycbcr = rgb_to_ycbcr(img, compat_luma=compat_luma, to_u8=True)
    y = ycbcr[..., 0]
    lut = _equalize_lut(y)
    # index clamp mirrors equalization.cpp:128 (y is already in [0,255])
    y_eq = _apply_lut(y, lut)
    out = jnp.stack([y_eq, ycbcr[..., 1], ycbcr[..., 2]], axis=-1)
    return ycbcr_to_rgb(out, to_u8=True)


@jax.jit
def equalize_gray(img: jnp.ndarray) -> jnp.ndarray:
    """Gray-mode equalization (mode=0). img: [H, W, 3] float32 RGB.
    Note the reference reads channels as (b, g, r) = (0, 1, 2) here
    (equalization.cpp:32-36), i.e. luma = c0*0.0722 + c1*0.7152 + c2*0.2126
    on RGB-ordered data — preserved as behavior."""
    gray = trunc_u8(0.0722 * img[..., 0] + 0.7152 * img[..., 1]
                    + 0.2126 * img[..., 2])
    lut = _equalize_lut(gray)
    return _apply_lut(gray, lut)


@partial(jax.jit, static_argnames=("compat_luma", "mix_weight"))
def equalize_and_mix(result: jnp.ndarray, compat_luma: bool = True,
                     mix_weight: float = 19.0 / 20.0) -> jnp.ndarray:
    """The pipeline tail (ImageProcess.cpp:237-268): equalize a copy, convert
    both to YCbCr (float, clamped), mix luma mix_weight : (1-mix_weight),
    convert back to RGB u8."""
    eq = equalize_color(result, compat_luma)
    ycc_res = rgb_to_ycbcr(result, compat_luma=compat_luma, to_u8=False)
    ycc_eq = rgb_to_ycbcr(eq, compat_luma=compat_luma, to_u8=False)
    y_mix = ycc_res[..., 0] * mix_weight + ycc_eq[..., 0] * (1.0 - mix_weight)
    mixed = jnp.stack([y_mix, ycc_res[..., 1], ycc_res[..., 2]], axis=-1)
    return ycbcr_to_rgb(mixed, to_u8=True)
