"""Multi-band (Laplacian pyramid) blending.

Equivalent of blendTwoImages (/root/reference/ImageProcess.cpp:648-773):

1. Overlap centroid along the mid-height row -> vertical half-plane mask
   (horizontal panoramas only, as the reference states at cpp:658).
2. Gaussian pyramids of a, b, mask: blur sigma=2 + half-size resize.
   The reference's blur is CImg's recursive Van Vliet (get_blur(2,true,true));
   here it is the equivalent FIR Gaussian — within blend tolerance. The
   resize is CImg-exact (ops.resize).
3. Laplacian pyramids, per-level masked lerp, top-down reconstruction with
   per-level clamping to [0, 255].

Levels: floor(log2(max(w,h))) in the root variant (cpp:675-676) or
floor(log2(min(w,h))) in ex6 (src/ex6/ImageProcess.cpp:662-665).

The whole blend compiles to one fused XLA program per canvas shape; the
pyramids are chains of separable convs + tiny resize matmuls.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.gaussian import gaussian_blur, vanvliet_blur
from ..ops.resize import blur_shrink_hwc, cimg_resize


def _blur_hwc(img: jnp.ndarray, sigma: float,
              impl: str = "fir") -> jnp.ndarray:
    """Blur [H, W, C] (or [H, W]) along H and W only, like CImg blur.

    impl="fir": separable FIR Gaussian (fast default, within blend
    tolerance). impl="vanvliet": CImg's exact recursive Van Vliet filter
    with Triggs boundaries (get_blur(2,true,true), ImageProcess.cpp:709) —
    bit-faithful parity mode, ~several times slower (associative scans).
    """
    if impl == "vanvliet":
        if img.ndim == 2:
            return vanvliet_blur(img, sigma)
        moved = jnp.moveaxis(img, -1, 0)
        return jnp.moveaxis(vanvliet_blur(moved, sigma), 0, -1)
    if img.ndim == 2:
        return gaussian_blur(img, sigma)
    # blur [H, W, C] in place along axes (1, 0) — W then H, the same op
    # order as gaussian_blur — without the moveaxis round trip (each
    # moveaxis of the minor channel dim is a full canvas copy)
    from ..ops.gaussian import _conv1d_axis, gauss_taps
    taps = jnp.asarray(gauss_taps(sigma)).astype(img.dtype)
    return _conv1d_axis(_conv1d_axis(img, taps, 1), taps, 0)


def n_levels(h: int, w: int, mode: str = "max") -> int:
    ext = max(w, h) if mode == "max" else min(w, h)
    return int(math.floor(math.log2(ext)))


# the BlendConfig.bf16_auto_area default, used where only a dtype string
# reaches the blend (sharded path, direct blend_two_images callers)
AUTO_BF16_AREA = 1_500_000


def resolve_dtype(dtype: str, h: int, w: int,
                  area_threshold: int = AUTO_BF16_AREA) -> str:
    """Resolve the "auto" blend-precision policy at trace time: bf16 when
    the blend canvas exceeds ``area_threshold`` pixels, f32 otherwise
    (the gate's value changes output; re-deciding it from a GPU trace is
    queued in ROADMAP.md). Shapes are static, so this adds no compile variants beyond
    the canvas shape itself."""
    if dtype != "auto":
        return dtype
    return "bf16" if h * w > area_threshold else "f32"


def half_plane_mask(a: jnp.ndarray, b: jnp.ndarray,
                    content_h: jnp.ndarray | int | None = None) -> jnp.ndarray:
    """Vertical half-plane seam mask from the mid-row overlap centroid
    (blendTwoImages, ImageProcess.cpp:650-698). Returns [H, W] float32 of
    {0, 1}: 1 where canvas ``a`` wins at pyramid level 0.

    ``content_h``: when the canvas is bucket-padded (exact_canvas=False),
    the panorama content occupies rows [0, content_h) and the rest is zero.
    The seam row must be the CONTENT's mid-height row — the padded canvas's
    h//2 reads a different (possibly empty) row than the exact-canvas
    blend, which can flip the whole seam. Traced (not static): the mid row
    is a dynamic slice, so distinct content extents share one compiled
    blend per bucketed canvas shape."""
    h, w = a.shape[0], a.shape[1]
    mid = (h if content_h is None else content_h) // 2
    row_a = a[mid, :, 0]
    row_b = b[mid, :, 0]
    xs = jnp.arange(w, dtype=jnp.float32)
    a_nz = row_a != 0
    both_nz = a_nz & (row_b != 0)
    width_a = jnp.maximum(jnp.sum(a_nz.astype(jnp.float32)), 1.0)
    width_ov = jnp.maximum(jnp.sum(both_nz.astype(jnp.float32)), 1.0)
    ratio = jnp.sum(jnp.where(a_nz, xs, 0.0)) / width_a
    overlap_ratio = jnp.sum(jnp.where(both_nz, xs, 0.0)) / width_ov
    # a-content left of the overlap line -> mask the left half, else right
    left_mask = (xs < overlap_ratio).astype(jnp.float32)
    right_mask = (xs >= jnp.trunc(overlap_ratio + 1.0)).astype(jnp.float32)
    mask_row = jnp.where(ratio < overlap_ratio, left_mask, right_mask)
    return jnp.broadcast_to(mask_row[None, :], (h, w))


def blend_stacked(s0: jnp.ndarray, levels: int,
                  blur_sigma: float = 2.0,
                  blur_impl: str = "fir",
                  dtype: str = "f32") -> jnp.ndarray:
    """Pyramid blend of a pre-stacked [H, W, 7] canvas (a | b | mask
    channels): downsweep (blur+halve), per-level Laplacian masked lerp,
    top-down reconstruction with clamping. Factored out of
    blend_two_images so parallel.blend can reuse it verbatim for the
    replicated deep-pyramid tail of the row-sharded blend.

    dtype="bf16" runs the whole pyramid chain in bfloat16 — the blend is
    HBM-bandwidth-bound at panorama canvas sizes, so halving the bytes
    roughly halves the time. u8-valued canvases carry ~1 ulp of bf16
    rounding at 255, so the output can differ from f32 by a few u8 levels
    in smooth gradients (opt-in speed mode; f32 is the parity default).
    FIR blur only."""
    if dtype == "bf16":
        if blur_impl not in ("fir", "fir_fused"):
            raise ValueError("dtype='bf16' supports blur_impl='fir' only")
        s0 = s0.astype(jnp.bfloat16)
    elif dtype != "f32":
        raise ValueError(f"unknown blend dtype {dtype!r}")
    # -- gaussian pyramids (cpp:705-715)
    # a, b, mask stacked along channels: blur/resize are per-channel
    # independent, so one 7-channel chain computes the identical values
    # with a third of the op-chain
    s_pyr = [s0]
    for i in range(1, levels):
        # clamp to >= 1: with max-dim level counts a narrow canvas would hit
        # size 0 (the reference's root variant would crash there; CImg can't
        # resize to 0 — sane clamp instead)
        hp = max(s_pyr[-1].shape[0] // 2, 1)
        wp = max(s_pyr[-1].shape[1] // 2, 1)
        if blur_impl == "fir_fused":
            # fused FIR-blur + half-shrink stencil (ops.resize): identical
            # values modulo float reassociation and ~half the multiply-
            # adds; opt-in, as XLA may fuse the unfused blur +
            # strided-shrink chain better (not measured on the GPU).
            s_pyr.append(blur_shrink_hwc(s_pyr[-1], hp, wp, blur_sigma))
        else:
            s_pyr.append(cimg_resize(
                _blur_hwc(s_pyr[-1], blur_sigma,
                          "fir" if blur_impl == "fir" else blur_impl),
                hp, wp))

    # -- laplacians (cpp:727-733) + masked lerp per level (cpp:744-753)
    blend_pyr = []
    for i in range(levels):
        ab = s_pyr[i][..., :6]
        if i < levels - 1:
            hp, wp = ab.shape[0], ab.shape[1]
            ab = ab - cimg_resize(s_pyr[i + 1][..., :6], hp, wp)
        m = s_pyr[i][..., 6]
        blend_pyr.append(ab[..., :3] * m[..., None]
                         + ab[..., 3:6] * (1.0 - m[..., None]))

    # -- reconstruct with per-level clamp (cpp:762-771)
    expand = blend_pyr[-1]
    for i in range(levels - 2, -1, -1):
        hp, wp = blend_pyr[i].shape[0], blend_pyr[i].shape[1]
        expand = cimg_resize(expand, hp, wp)
        expand = jnp.clip(blend_pyr[i] + expand, 0.0, 255.0)
    return expand.astype(jnp.float32)


def seam_auto_engaged(bcfg, h: int, w: int) -> bool:
    """Trace-time: does the area-gated automatic seam-band policy apply
    to an h x w blend canvas under this BlendConfig?"""
    return bool(bcfg.seam_band == 0
                and getattr(bcfg, "seam_auto_area", 0)
                and h * w > bcfg.seam_auto_area)


def apply_composite_gain(a: jnp.ndarray, b: jnp.ndarray, bcfg,
                         h: int, w: int) -> jnp.ndarray:
    """Gain-compensate the incoming canvas ``a`` toward ``b`` when asked
    for — and ALWAYS when the seam-auto policy engages for this canvas:
    the full-canvas pyramid smears per-frame exposure differences across
    the whole panorama, a narrow seam band cannot, so without gain the
    seam shows as a vertical exposure step (verified visually on the
    1080p bench panorama, round 5). Seam-auto-implied gain uses "rgb"
    (removes tint steps too); explicit gain keeps the user's mode."""
    auto = seam_auto_engaged(bcfg, h, w)
    if not (bcfg.gain_compensation or auto):
        return a
    from .gain import gain_compensate

    return gain_compensate(
        a, b, bcfg.gain_mode if bcfg.gain_compensation else "rgb")


def blend_edge(a: jnp.ndarray, b: jnp.ndarray, bcfg,
               content_h: jnp.ndarray | int | None = None) -> jnp.ndarray:
    """Config-driven blend dispatch: the reference's full-canvas pyramid
    (BlendConfig.seam_band == 0) or the seam-band window extension.
    Resolves the "auto" precision policy against BlendConfig's area
    threshold (the seam-band path resolves on its window instead)."""
    thr = getattr(bcfg, "bf16_auto_area", AUTO_BF16_AREA)
    band = bcfg.seam_band
    if band == 0 and seam_auto_engaged(bcfg, int(a.shape[0]),
                                       int(a.shape[1])):
        # area-gated automatic seam-band (BlendConfig.seam_auto_area):
        # full-canvas reference blend below the gate, seam-window blend
        # above it — the SAME predicate apply_composite_gain uses, so
        # band and implied gain can never disagree. The window dtype is
        # pinned to the full-canvas policy's choice so the gate cannot
        # flip a big canvas back to f32.
        band = getattr(bcfg, "seam_auto_band", 256)
    if band > 0:
        wb = 4 * band
        dt = resolve_dtype(bcfg.dtype, int(a.shape[0]),
                           min(wb, int(a.shape[1])), thr)
        if (bcfg.seam_band == 0 and bcfg.dtype == "auto"
                and resolve_dtype("auto", int(a.shape[0]),
                                  int(a.shape[1]), thr) == "bf16"):
            dt = "bf16"
        return blend_seam_band(a, b, band, bcfg.level_mode,
                               bcfg.blur_sigma, bcfg.blur_impl, content_h,
                               dt)
    return blend_two_images(a, b, bcfg.level_mode, bcfg.blur_sigma,
                            bcfg.blur_impl, content_h,
                            resolve_dtype(bcfg.dtype, int(a.shape[0]),
                                          int(a.shape[1]), thr))


@partial(jax.jit, static_argnames=("band", "level_mode", "blur_sigma",
                                   "blur_impl", "dtype"))
def blend_seam_band(a: jnp.ndarray, b: jnp.ndarray, band: int,
                    level_mode: str = "max",
                    blur_sigma: float = 2.0,
                    blur_impl: str = "fir",
                    content_h: jnp.ndarray | int | None = None,
                    dtype: str = "f32") -> jnp.ndarray:
    """Seam-band multi-band blend: pyramid-blend ONLY a window around the
    seam; copy a/b verbatim elsewhere.

    The reference blends the FULL canvas per edge (blendTwoImages,
    ImageProcess.cpp:648-773), so late edges of a long chain redo
    O(H x W_total) work for a seam that moved by one image width. This is
    the OpenCV-MultiBandBlender-style alternative (an extension, off by
    default): cost O(H x 4*band) per edge regardless of canvas width, with
    the luma transition confined to ~band pixels instead of the reference's
    canvas-wide low-frequency ramp.

    Mechanics: a [H, 4*band] window is sliced (traced offset — one compile
    per canvas shape) centered on the half-plane seam column; pyramid depth
    is capped so the accumulated blur support (~8*2^levels for sigma=2)
    stays inside the outer band-wide margins, whose artifacts (resize
    zero-pad, blur replicate-pad at artificial borders) are discarded —
    only the central 2*band columns are pasted back, so the paste boundary
    is continuous with the copied region (tested < 1 u8).

    Seams within ``band`` columns of a canvas edge degrade to a hard cut in
    the copy region (overlaps live in the canvas interior in practice).
    Canvases narrower than 4*band fall back to the full blend.

    Pair with BlendConfig.gain_compensation: the reference's full-depth
    blend hides per-frame exposure differences by smearing them across the
    whole canvas; a narrow band cannot, so exposure steps show unless the
    incoming image's overlap luma is gain-matched first (verified visually
    on Input/: banding without gain, clean with)."""
    h, w = int(a.shape[0]), int(a.shape[1])
    wb = 4 * band
    if wb > w:
        return blend_two_images(a, b, level_mode, blur_sigma, blur_impl,
                                content_h, dtype)
    dtype = resolve_dtype(dtype, h, wb)
    mask0 = half_plane_mask(a, b, content_h)
    # seam column: the half-plane row has one transition; count the prefix
    # equal to its first value (works for both left- and right-side masks)
    mask_row = mask0[0]
    t = jnp.sum((mask_row == mask_row[0]).astype(jnp.int32))
    s = jnp.clip(t - wb // 2, 0, w - wb)
    stacked = jnp.concatenate([a, b, mask0[..., None]], axis=-1)
    win = jax.lax.dynamic_slice_in_dim(stacked, s, wb, axis=1)
    # support(levels) ~ 8 * 2^levels original-resolution pixels must fit in
    # the discarded band-wide margin
    levels = max(1, min(n_levels(h, wb, level_mode),
                        int(math.log2(max(band // 8, 2)))))
    blended_win = blend_stacked(win, levels, blur_sigma, blur_impl, dtype)
    copy = jnp.where(mask0[..., None] == 1.0, a, b)
    inner = jax.lax.dynamic_slice_in_dim(blended_win, band, 2 * band, axis=1)
    return jax.lax.dynamic_update_slice_in_dim(copy, inner, s + band, axis=1)


@partial(jax.jit, static_argnames=("level_mode", "blur_sigma", "blur_impl",
                                   "dtype"))
def blend_two_images(a: jnp.ndarray, b: jnp.ndarray,
                     level_mode: str = "max",
                     blur_sigma: float = 2.0,
                     blur_impl: str = "fir",
                     content_h: jnp.ndarray | int | None = None,
                     dtype: str = "f32") -> jnp.ndarray:
    """Blend canvas a (new warped image) over b (previous result).

    a, b: [H, W, 3] float32 (u8 values). Returns the blended float canvas
    (the caller truncates to u8, as the reference's CImg assignment does).
    ``content_h``: content row extent when the canvas is bucket-padded —
    see half_plane_mask. Traced, so it adds no compile variants.
    ``dtype="bf16"``: reduced-precision pyramid (see blend_stacked).
    """
    h, w = a.shape[0], a.shape[1]
    dtype = resolve_dtype(dtype, int(h), int(w))
    levels = n_levels(h, w, level_mode)
    mask0 = half_plane_mask(a, b, content_h)
    s0 = jnp.concatenate([a, b, mask0[..., None]], axis=-1)
    return blend_stacked(s0, levels, blur_sigma, blur_impl, dtype)
