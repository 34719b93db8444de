"""Reinhard color transfer.

Equivalent of class transfer (/root/reference/transfer.cpp): RGB -> LMS ->
log10 -> l-alpha-beta, per-channel mean/std matched to a template image,
then back. The reference parallelizes rows over 16 Win32 threads
(transfer.cpp:45-69); here the whole thing is one fused elementwise kernel
plus two global mean/var reductions.

Present in the public API even though the reference's call sites are
commented out (ImageProcess.cpp:180-182) — it is part of the capability
surface (SURVEY.md §2.1).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

_SQRT3 = math.sqrt(3.0)
_SQRT6 = math.sqrt(6.0)
_SQRT2 = math.sqrt(2.0)


@jax.jit
def rgb_to_lab(img: jnp.ndarray) -> jnp.ndarray:
    """RGBtoLab (transfer.cpp:175-198). img: [..., 3] float32."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    l = 0.3811 * r + 0.5783 * g + 0.0402 * b
    m = 0.1967 * r + 0.7244 * g + 0.0782 * b
    s = 0.0241 * r + 0.1288 * g + 0.8444 * b
    l = jnp.where(l == 0, 1.0, l)
    m = jnp.where(m == 0, 1.0, m)
    s = jnp.where(s == 0, 1.0, s)
    l = jnp.log10(l)
    m = jnp.log10(m)
    s = jnp.log10(s)
    pa, pb, pc = 1.0 / _SQRT3, 1.0 / _SQRT6, 1.0 / _SQRT2
    big_l = pa * (l + m + s)
    alpha = pb * l + pb * m - 2.0 * pb * s
    beta = pc * l - pc * m
    return jnp.stack([big_l, alpha, beta], axis=-1)


@jax.jit
def lab_to_rgb(img: jnp.ndarray) -> jnp.ndarray:
    """LabToRGB (transfer.cpp:200-226), including its [0,255] clamps."""
    big_l, alpha, beta = img[..., 0], img[..., 1], img[..., 2]
    pa, pb, pc = _SQRT3 / 3.0, _SQRT6 / 6.0, _SQRT2 / 2.0
    l = pa * big_l + pb * alpha + pc * beta
    m = pa * big_l + pb * alpha - pc * beta
    s = pa * big_l - 2.0 * pb * alpha
    l = jnp.power(10.0, l)
    m = jnp.power(10.0, m)
    s = jnp.power(10.0, s)
    r = 4.4679 * l - 3.5873 * m + 0.1193 * s
    g = -1.2186 * l + 2.3809 * m - 0.1624 * s
    b = 0.0497 * l - 0.2439 * m + 1.2045 * s
    out = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(out, 0.0, 255.0)


@jax.jit
def color_transfer(src: jnp.ndarray, template: jnp.ndarray) -> jnp.ndarray:
    """transfer(src, template) -> output (transfer.cpp:4-13,125-173).

    src, template: [H, W, 3] float32 RGB (0..255); shapes may differ.
    Returns the color-matched image, float32.
    """
    lab_src = rgb_to_lab(src)
    lab_tpl = rgb_to_lab(template)
    mean_s = jnp.mean(lab_src, axis=(0, 1))
    mean_t = jnp.mean(lab_tpl, axis=(0, 1))
    std_s = jnp.sqrt(jnp.mean((lab_src - mean_s) ** 2, axis=(0, 1)))
    std_t = jnp.sqrt(jnp.mean((lab_tpl - mean_t) ** 2, axis=(0, 1)))
    matched = (lab_src - mean_s) * std_t / std_s + mean_t
    return lab_to_rgb(matched)
