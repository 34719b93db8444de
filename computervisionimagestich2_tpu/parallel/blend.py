"""Row-sharded multi-band blending — canvas compositing across devices.

The reference's unbounded dimension is the growing panorama canvas
(blendTwoImages, /root/reference/ImageProcess.cpp:648-773; SURVEY.md §5
"long-context analog"). This module runs the SAME pyramid blend as
models.blender.blend_two_images with the canvas ROWS sharded over a mesh
axis: every device owns a horizontal stripe, and the only cross-device
traffic is the filter/resize halo exchanged with row-neighbors via
``ppermute`` — the classic halo pattern, sized in rows, never the
full canvas.

Per pyramid level the H-direction ops need neighbor rows:

  blur      radius-r taps        -> r rows from above and below (edge
                                    stripes replicate their own border,
                                    VL_PAD_BY_CONTINUITY semantics)
  shrink/2  band-B CImg average  -> B rows from below (global zero pad)
  enlarge x2 3-tap CImg lerp     -> 1 row above, 2 below (global zero pad)

W-direction ops touch only local columns. Levels stay sharded while the
per-device stripe can host a single-hop halo (stripe >= blur radius) and
the halved height still splits evenly (H % 2n == 0); the small deep-pyramid
tail is all_gather'ed once and finished replicated with the exact
models.blender.blend_stacked code, so the sharded result matches the
single-device blend to f32 round-off (asserted in
tests/test_parallel.py::test_sharded_blend_matches_single_device).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.blender import blend_stacked, half_plane_mask, n_levels
from ..ops.gaussian import _conv1d_axis, gauss_taps
from ..ops.resize import _banded_weights, _resize_axis1, _resize_weights


def _down_perm(n):
    """source i -> destination i+1: receive rows from the stripe ABOVE."""
    return [(i, (i + 1) % n) for i in range(n)]


def _up_perm(n):
    """source i -> destination i-1: receive rows from the stripe BELOW."""
    return [(i, (i - 1) % n) for i in range(n)]


def _halo_above(x, k: int, axis_name: str, zero_edge: bool):
    """k halo rows from the global-previous stripe; the top stripe sees
    either zeros (resize out-of-range) or its own replicated edge (blur
    continuity)."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    got = lax.ppermute(x[-k:], axis_name, _down_perm(n))
    edge = jnp.zeros_like(got) if zero_edge else jnp.repeat(x[:1], k, axis=0)
    return jnp.where(idx == 0, edge, got)


def _halo_below(x, k: int, axis_name: str, zero_edge: bool):
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    got = lax.ppermute(x[:k], axis_name, _up_perm(n))
    edge = jnp.zeros_like(got) if zero_edge else jnp.repeat(x[-1:], k, axis=0)
    return jnp.where(idx == n - 1, edge, got)


def _halo_blur(x, taps, axis_name: str):
    """Separable FIR blur of a stripe [H_loc, W, C]: W pass local, H pass
    over a 2r-row halo. Taps/order/padding match ops.gaussian.gaussian_blur
    (W then H, continuity padding) so values are bit-comparable."""
    taps = taps.astype(x.dtype)  # keep reduced-precision stripes reduced
    r = (taps.shape[0] - 1) // 2
    xw = _conv1d_axis(x, taps, 1)
    above = _halo_above(xw, r, axis_name, zero_edge=False)
    below = _halo_below(xw, r, axis_name, zero_edge=False)
    ext = jnp.concatenate([above, xw, below], axis=0)
    out = None
    h_loc = x.shape[0]
    for j in range(taps.shape[0]):
        term = taps[j] * lax.slice_in_dim(ext, j, j + h_loc, axis=0)
        out = term if out is None else out + term
    return out


def _halo_shrink_rows(x, w_stripe, axis_name: str):
    """CImg half-shrink along rows of stripe x [2m, W, C] -> [m, W, C].

    w_stripe: this device's rows of the global banded shrink weights
    (ops.resize._banded_weights, idx0[t] == 2t for exact halving). The
    bottom stripe's out-of-range taps read zeros, matching the global
    zero pad of _shrink_half_axis1."""
    band = w_stripe.shape[1]
    below = _halo_below(x, band, axis_name, zero_edge=True)
    ext = jnp.concatenate([x, below], axis=0)
    m = x.shape[0] // 2
    out = None
    for b in range(band):
        wk = w_stripe[:, b].reshape((m,) + (1,) * (x.ndim - 1))
        term = ext[b: b + 2 * m: 2] * wk
        out = term if out is None else out + term
    return out


def _enlarge2_parity_weights(n_src: int):
    """Per-parity banded weights for the x2 CImg enlarge (n_dst = 2*n_src):
    output row 2t+p reads source rows t-1..t+1 with weights from
    ops.resize._resize_weights; out-of-range taps are zero."""
    dense = _resize_weights(n_src, 2 * n_src)
    ws = []
    for p in (0, 1):
        rows = dense[p::2]
        w = np.zeros((n_src, 3), np.float32)
        for t in range(n_src):
            for b in range(3):
                j = t - 1 + b
                if 0 <= j < n_src:
                    w[t, b] = rows[t, j]
        ws.append(w)
    return ws


def _enlarge_rows_from_ext(ext, w0, w1):
    """x2 row enlarge given the pre-extended source ext [m+3, W, C]
    (1 pad/halo row above, m stripe rows, 2 below) and this device's
    per-parity weight stripes [m, 3]. Returns [2m, W, C]."""
    m = w0.shape[0]
    halves = []
    for w in (w0, w1):
        out_p = None
        for b in range(3):
            wk = w[:, b].reshape((m,) + (1,) * (ext.ndim - 1))
            term = lax.slice_in_dim(ext, b, b + m, axis=0) * wk
            out_p = term if out_p is None else out_p + term
        halves.append(out_p)
    inter = jnp.stack(halves, axis=1)
    return inter.reshape((2 * m,) + ext.shape[1:])


def _halo_enlarge_rows(x, w0, w1, axis_name: str):
    """x2 row enlarge of a sharded stripe: 1-row halo above, 2 below."""
    above = _halo_above(x, 1, axis_name, zero_edge=True)
    below = _halo_below(x, 2, axis_name, zero_edge=True)
    return _enlarge_rows_from_ext(
        jnp.concatenate([above, x, below], axis=0), w0, w1)


def _stripe_ext_of_replicated(full, axis_name: str):
    """The [m+3, W, C] extended source for THIS device's enlarge stripe,
    sliced out of a replicated [H, W, C] level (the sharded/replicated
    pyramid boundary): global zero pad (1, 2) then the stripe window."""
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    m = full.shape[0] // n
    padded = jnp.pad(full, [(1, 2)] + [(0, 0)] * (full.ndim - 1))
    return lax.dynamic_slice_in_dim(padded, idx * m, m + 3, axis=0)


def plan_shard_levels(h: int, levels: int, n: int, blur_sigma: float) -> int:
    """How many leading pyramid levels can run row-sharded over n devices:
    stripe must host a single-hop blur halo (H/n >= radius) and the halved
    height must still split evenly (H % 2n == 0)."""
    r = (gauss_taps(blur_sigma).shape[0] - 1) // 2
    L, cur = 0, h
    while L < levels - 1 and cur % (2 * n) == 0 and cur // n >= max(r, 2):
        L += 1
        cur //= 2
    return L


@lru_cache(maxsize=64)
def _composite_program(mesh: Mesh, axis_name: str, m: int, w: int,
                       model: str):
    """Cached jit(shard_map) composite program: a fresh jit wrapper per
    call would retrace the SPMD body on every edge; the lru_cache keys it
    on the static geometry so per-edge offsets (traced operands) reuse the
    compiled executable."""
    from ..ops.warp import shift_image, warp_image

    def body(src, res, coeffs, offf, offi):
        idx = lax.axis_index(axis_name)
        a = warp_image(src, coeffs, offf[0],
                       offf[1] + (idx * m).astype(jnp.float32),
                       out_shape=(m, w), model=model)
        b = shift_image(res, offi[0], offi[1] + idx * m, out_shape=(m, w))
        return a, b

    rep = P(None, None, None)
    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(rep, rep, P(None), P(None), P(None)),
        out_specs=(P(axis_name, None, None), P(axis_name, None, None))))


def sharded_composite(src_img: jnp.ndarray, result_img: jnp.ndarray,
                      backward_coeffs: jnp.ndarray, min_x: float,
                      min_y: float, canvas_hw: tuple[int, int], mesh: Mesh,
                      axis_name: str = "sp", model: str = "bilinear"):
    """Row-sharded stitch-edge composite (compose.composite on a mesh).

    Returns (a, b) as GLOBAL [H, W, 3] arrays row-sharded over
    ``mesh[axis_name]``: a = src_img inverse-warped through
    backward_coeffs, b = the previous result shifted by the integer
    offsets (ImageProcess.cpp:218-224). Both are backward maps reading a
    replicated source, so every canvas stripe is computed independently on
    its own device with ZERO halo traffic — each stripe runs the exact
    single-device kernels with its row offset folded into offset_y.
    Feed the outputs straight into sharded_blend_two_images for the fully
    sharded composite+blend step (SURVEY.md §5 "shard the canvas
    compositing across devices").
    """
    h, w = canvas_hw
    n = mesh.shape[axis_name]
    if h % n:
        raise ValueError(f"canvas H={h} not divisible by {n} devices")
    m = h // n

    # offsets ride as operands (traced), not closure constants — per-edge
    # offsets must not recompile the SPMD program
    offf = jnp.asarray([min_x, min_y], jnp.float32)
    offi = jnp.asarray([int(min_x), int(min_y)], jnp.int32)
    fn = _composite_program(mesh, axis_name, m, w, model)
    return fn(src_img, result_img, backward_coeffs, offf, offi)


def sharded_composite_and_blend(src_img: jnp.ndarray,
                                result_img: jnp.ndarray,
                                backward_coeffs: jnp.ndarray,
                                min_x: float, min_y: float,
                                canvas_hw: tuple[int, int], mesh: Mesh,
                                axis_name: str = "sp",
                                model: str = "bilinear",
                                level_mode: str = "max",
                                blur_sigma: float = 2.0,
                                content_h: jnp.ndarray | int | None = None,
                                dtype: str = "f32") -> jnp.ndarray:
    """One full stitch edge — composite + multi-band blend — with canvas
    rows sharded end-to-end: warp and offset-copy stripes are
    halo-free backward maps (sharded_composite), the pyramid blend
    exchanges only blur/resize halos via ppermute
    (sharded_blend_two_images). Matches the single-device
    compose.composite + blend_two_images to f32 round-off
    (tests/test_parallel.py)."""
    a, b = sharded_composite(src_img, result_img, backward_coeffs,
                             min_x, min_y, canvas_hw, mesh, axis_name, model)
    return sharded_blend_two_images(a, b, mesh, axis_name, level_mode,
                                    blur_sigma, content_h, dtype)


def sharded_blend_two_images(a: jnp.ndarray, b: jnp.ndarray, mesh: Mesh,
                             axis_name: str = "sp",
                             level_mode: str = "max",
                             blur_sigma: float = 2.0,
                             content_h: jnp.ndarray | int | None = None,
                             dtype: str = "f32") -> jnp.ndarray:
    """blend_two_images with canvas rows sharded over ``mesh[axis_name]``.

    a, b: [H, W, 3] float32 u8-valued canvases. The leading
    ``plan_shard_levels`` pyramid levels run as row stripes with ppermute
    halo exchange; the deep tail is gathered once and finished replicated
    (models.blender.blend_stacked). Output matches the single-device blend
    to f32 round-off. Raises if H doesn't admit even sharding.
    ``dtype="bf16"`` mirrors BlendConfig.dtype: the stripes, halos, and the
    gathered tail all run in bfloat16 (half the memory *and* interconnect
    traffic)."""
    h, w = int(a.shape[0]), int(a.shape[1])
    n = mesh.shape[axis_name]
    from ..models.blender import resolve_dtype

    dtype = resolve_dtype(dtype, h, w)
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown blend dtype {dtype!r}")
    levels = n_levels(h, w, level_mode)
    L = plan_shard_levels(h, levels, n, blur_sigma)
    if L == 0:
        raise ValueError(
            f"H={h} not row-shardable over {n} devices "
            f"(needs H % {2 * n} == 0 and H//{n} >= blur radius)")

    mask0 = half_plane_mask(a, b, content_h)
    stacked = jnp.concatenate([a, b, mask0[..., None]], axis=-1)
    row_sharding = NamedSharding(mesh, P(axis_name, None, None))
    stacked = jax.device_put(stacked, row_sharding)
    fn, shrink_ws, enl_ws = _blend_program(mesh, axis_name, h, w, levels, L,
                                           blur_sigma, dtype)
    return fn(stacked, shrink_ws, enl_ws)


@lru_cache(maxsize=64)
def _blend_program(mesh: Mesh, axis_name: str, h: int, w: int, levels: int,
                   L: int, blur_sigma: float, dtype: str = "f32"):
    """Cached jit(shard_map) pyramid-blend program + its weight operands,
    keyed on the static geometry (a fresh jit wrapper per call would
    retrace the SPMD body on every edge)."""
    taps = jnp.asarray(gauss_taps(blur_sigma))

    # host-side shape walk + per-level weight tables (all evenly sharded:
    # level i sharded requires H_i % 2n == 0, hence H_{i+1} % n == 0)
    hs, ws_ = [h], [w]
    for _ in range(1, levels):
        hs.append(max(hs[-1] // 2, 1))
        ws_.append(max(ws_[-1] // 2, 1))
    shrink_ws, enl_ws = [], []
    for i in range(L):
        idx0, wmat = _banded_weights(hs[i], hs[i + 1])
        assert (idx0 == 2 * np.arange(hs[i + 1], dtype=np.int32)).all()
        shrink_ws.append(jnp.asarray(wmat))
        w0, w1 = _enlarge2_parity_weights(hs[i + 1])
        enl_ws.append((jnp.asarray(w0), jnp.asarray(w1)))

    def body(stripe, shr, enl):
        if dtype == "bf16":
            # reduced-precision stripes: weight operands cast alongside so
            # promotion doesn't silently pull the chain back to f32
            stripe = stripe.astype(jnp.bfloat16)
            shr = tuple(s.astype(jnp.bfloat16) for s in shr)
            enl = tuple((w0.astype(jnp.bfloat16), w1.astype(jnp.bfloat16))
                        for (w0, w1) in enl)
        # sharded downsweep: blur (H halo) -> W halve (local) -> H halve
        # (halo), same op order as blend_stacked's cimg_resize(_blur_hwc())
        s_loc = [stripe]
        for i in range(L):
            blurred = _halo_blur(s_loc[-1], taps, axis_name)
            wsh = _resize_axis1(blurred, ws_[i + 1])
            s_loc.append(_halo_shrink_rows(wsh, shr[i], axis_name))
        # replicated deep tail: gather level L once, reuse the exact
        # single-device blend code for levels L..levels-1
        full_l = lax.all_gather(s_loc[L], axis_name, tiled=True)
        expand = blend_stacked(full_l, levels - L, blur_sigma, "fir",
                               dtype).astype(stripe.dtype)
        # sharded upsweep: laplacian + masked lerp + reconstruct per level
        for i in range(L - 1, -1, -1):
            w0, w1 = enl[i]
            if i == L - 1:
                low6 = _resize_axis1(full_l[..., :6], ws_[i])
                up6 = _enlarge_rows_from_ext(
                    _stripe_ext_of_replicated(low6, axis_name), w0, w1)
                lowx = _resize_axis1(expand, ws_[i])
                upx = _enlarge_rows_from_ext(
                    _stripe_ext_of_replicated(lowx, axis_name), w0, w1)
            else:
                low6 = _resize_axis1(s_loc[i + 1][..., :6], ws_[i])
                up6 = _halo_enlarge_rows(low6, w0, w1, axis_name)
                lowx = _resize_axis1(expand, ws_[i])
                upx = _halo_enlarge_rows(lowx, w0, w1, axis_name)
            lap = s_loc[i][..., :6] - up6
            m = s_loc[i][..., 6:7]
            blended = lap[..., :3] * m + lap[..., 3:6] * (1.0 - m)
            expand = jnp.clip(blended + upx, 0.0, 255.0)
        return expand.astype(jnp.float32)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name, None, None),
                  tuple(P(axis_name, None) for _ in range(L)),
                  tuple((P(axis_name, None), P(axis_name, None))
                        for _ in range(L))),
        out_specs=P(axis_name, None, None)))
    return fn, tuple(shrink_ws), tuple(enl_ws)
