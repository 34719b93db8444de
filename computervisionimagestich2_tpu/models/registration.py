"""Fused per-edge registration — one device program, one host readback.

The reference's stitch step does matching, the direction-swap bookkeeping,
and two RANSACs as separate host-driven stages (ImageProcess.cpp:176-202).
Here the whole edge registration is fused into ONE jitted program
returning just the two 8-coefficient models (16 floats) — the only values
the host needs (for canvas planning) — so the host synchronizes once per
edge instead of once per stage.

The direction swap (keep whichever match direction found more pairs,
ImageProcess.cpp:185-198) becomes a jnp.where on the padded pair arrays.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import StitchConfig
from ..core.types import Features, MatchPairs
from .matcher import match_features_bidir
from .ransac import ransac_warp


@partial(jax.jit, static_argnames=("cfg", "img_hw"))
def register_edge(feats_src: Features, feats_dst: Features,
                  cfg: StitchConfig, edge_id: jnp.ndarray | int = 0,
                  img_hw: tuple[int, int] | None = None):
    """Returns (forward, backward, n_matches): forward maps dst-image coords
    into the src/result frame; backward maps canvas coords into dst-image
    coords. n_matches is the larger direction's match count.

    edge_id decorrelates the RANSAC draws across edges (fold_in); each
    direction additionally folds its own tag so forward/backward never share
    sample indices. Deterministic across runs for a fixed seed.

    img_hw (static, optional): the incoming image's (H, W). When given,
    the FORWARD RANSAC gates out degenerate hypotheses whose warp maps
    the image corners more than 4 image diagonals outside the matched
    region (ransac_warp corner gate) — forward feeds the canvas planner,
    where a near-singular model means an unallocatable canvas."""
    mcfg = cfg.match
    # both directions from one distance evaluation (the reference rebuilds
    # the kd-forest per direction, ImageProcess.cpp:185-198)
    s2d, d2s = match_features_bidir(feats_src, feats_dst,
                                    mcfg.ratio_threshold, mcfg.distance,
                                    mcfg.max_matches, mcfg.method,
                                    mcfg.l2pre_m)
    # direction choice on the UNCAPPED counts (the reference compares the
    # full vector sizes, ImageProcess.cpp:185)
    n_s2d = s2d.n_raw
    n_d2s = d2s.n_raw

    use_s2d = n_s2d > n_d2s

    def pick(a, b):
        return jax.tree.map(lambda x, y: jnp.where(use_s2d, x, y), a, b)

    s2d_final = pick(s2d, d2s.swapped())
    d2s_final = pick(s2d.swapped(), d2s)

    key = jax.random.fold_in(jax.random.PRNGKey(cfg.ransac.seed),
                             jnp.asarray(edge_id, jnp.uint32))
    key_fwd = jax.random.fold_in(key, 0)
    key_bwd = jax.random.fold_in(key, 1)
    if img_hw is not None:
        import math as _math

        h_img, w_img = img_hw
        corner_xy = jnp.asarray(
            [[0.0, 0.0], [w_img - 1.0, 0.0], [0.0, h_img - 1.0],
             [w_img - 1.0, h_img - 1.0]], jnp.float32)
        corner_span = 4.0 * _math.hypot(float(w_img), float(h_img))
    else:
        corner_xy = corner_span = None
    forward, _, _ = ransac_warp(d2s_final, key_fwd, cfg.ransac.n_hypotheses,
                                cfg.ransac.threshold, cfg.ransac.n_sample,
                                cfg.warp_model, cfg.ransac.lo_iters,
                                corner_xy, corner_span)
    backward, _, _ = ransac_warp(s2d_final, key_bwd, cfg.ransac.n_hypotheses,
                                 cfg.ransac.threshold, cfg.ransac.n_sample,
                                 cfg.warp_model, cfg.ransac.lo_iters)
    return (forward, backward, jnp.maximum(n_s2d, n_d2s),
            s2d_final.overflow())


def update_features_by_warp(feats: Features, coeffs: jnp.ndarray,
                            offset_x, offset_y,
                            model: str = "bilinear") -> Features:
    """updateFeaturesByHomography (ImageProcess.cpp:622-631)."""
    from ..ops.warp import warp_points

    xw, yw = warp_points(coeffs, feats.xy[:, 0], feats.xy[:, 1], model)
    xy = jnp.stack([xw - offset_x, yw - offset_y], axis=-1)
    return feats._replace(xy=xy)


def update_features_by_offset(feats: Features, offset_x, offset_y) -> Features:
    """updateFeaturesByOffset (ImageProcess.cpp:633-640); offsets are the
    int-truncated canvas mins at the call site (cpp:227)."""
    xy = feats.xy - jnp.stack([offset_x, offset_y])[None, :]
    return feats._replace(xy=xy)


def _canvas_bounds(fwd: jnp.ndarray, w_src: int, h_src: int,
                   cur_w, cur_h, model: str):
    """Device form of compose.canvas_plan (getMin/Max*AfterWarping +
    clamps, ImageProcess.cpp:206-216, 532-594)."""
    from ..ops.warp import warp_points

    xs = jnp.asarray([0.0, w_src - 1.0, 0.0, w_src - 1.0], jnp.float32)
    ys = jnp.asarray([0.0, 0.0, h_src - 1.0, h_src - 1.0], jnp.float32)
    xw, yw = warp_points(fwd, xs, ys, model)
    min_x = jnp.minimum(jnp.min(xw), 0.0)
    min_y = jnp.minimum(jnp.min(yw), 0.0)
    max_x = jnp.maximum(jnp.max(xw), cur_w)
    max_y = jnp.maximum(jnp.max(yw), cur_h)
    return min_x, min_y, jnp.ceil(max_x - min_x), jnp.ceil(max_y - min_y)


PLAN_ROW = 23  # fwd(9) + bwd(9) + [min_x, min_y, new_w, new_h, overflow]


@partial(jax.jit, static_argnames=("cfg", "img_hw", "start_hw"))
def plan_edges(feats_stacked: Features, edges: jnp.ndarray,
               img_hw: tuple[int, int], start_hw: tuple[int, int],
               cfg: StitchConfig) -> jnp.ndarray:
    """Register EVERY stitch edge in one device program.

    The reference's stitch loop re-syncs with the host per edge (matching,
    RANSAC, canvas sizing, feature bookkeeping — ImageProcess.cpp:176-227).
    This runs the whole chain as one ``lax.scan``: per edge it matches, solves both RANSAC
    directions, computes canvas-bound scalars, and applies the feature
    coordinate updates (dst by forward+offset, pre by int-truncated offset,
    cpp:226-227) — then the host reads back ONE [E, 23] plan and dispatches
    composites/blends with no further synchronization.

    feats_stacked: Features with leading image axis [N, CAP, ...].
    edges: [E, 3] int32 rows (src, dst, pre) in BFS order.
    img_hw: per-image (H, W) (uniform shapes); start_hw: the start image's.
    Returns [E, 23] rows: fwd(9), bwd(9), min_x, min_y, new_w, new_h,
    match-capacity overflow count (telemetry; 0 = nothing truncated).
    """
    h_img, w_img = img_hw

    def pad9(c):
        return jnp.pad(c, (0, 9 - c.shape[0]))

    def body(carry, edge):
        # only xy is carried: desc/scale/valid never change across edges,
        # so they stay scan CONSTANTS — carrying the whole Features made
        # every .at[].set rewrite the [N, CAP, 128] descriptor block twice
        # per edge for no reason
        xy_all, cur_w, cur_h = carry
        src, dst, pre = edge[0], edge[1], edge[2]

        def at_img(i):
            return Features(desc=feats_stacked.desc[i], xy=xy_all[i],
                            scale=feats_stacked.scale[i],
                            valid=feats_stacked.valid[i])

        f_src = at_img(src)
        f_dst = at_img(dst)
        # (src, dst) is unique per edge -> distinct RANSAC draws per edge
        fwd, bwd, _, ovf = register_edge(f_src, f_dst, cfg,
                                         src * 65536 + dst, img_hw)
        min_x, min_y, new_w, new_h = _canvas_bounds(
            fwd, w_img, h_img, cur_w, cur_h, cfg.warp_model)
        f_dst = update_features_by_warp(f_dst, fwd, min_x, min_y,
                                        cfg.warp_model)
        xy_all = xy_all.at[dst].set(f_dst.xy)
        # updateFeaturesByOffset on pre (int-truncated mins, cpp:227)
        xy_pre = xy_all[pre] - jnp.stack([jnp.trunc(min_x),
                                          jnp.trunc(min_y)])[None, :]
        xy_all = xy_all.at[pre].set(xy_pre)
        row = jnp.concatenate([pad9(fwd), pad9(bwd),
                               jnp.stack([min_x, min_y, new_w, new_h,
                                          ovf.astype(jnp.float32)])])
        return (xy_all, new_w, new_h), row

    init = (feats_stacked.xy, jnp.float32(start_hw[1]),
            jnp.float32(start_hw[0]))
    _, rows = jax.lax.scan(body, init, edges)
    return rows


@partial(jax.jit, static_argnames=("cfg",))
def all_pairs_match_counts(desc: jnp.ndarray, valid: jnp.ndarray,
                           cfg: StitchConfig) -> jnp.ndarray:
    """Match counts for every ORDERED image pair in one program.

    desc: [N, CAP, 128] stacked descriptors; valid: [N, CAP].
    Returns [N, N] counts with count[i, j] = |getImgPair(i, j)| (queries =
    j's descriptors against i's reference set, ImageProcess.cpp:117-137);
    the diagonal is 0. Both directions are computed because the reference's
    graph is directional in the rare asymmetric case: stichingMat[j][i]
    mirrors the i<j result only when THAT direction passed THRESHOLD —
    otherwise the reverse direction is computed and can independently pass
    (ImageProcess.cpp:125-135). Cost parity too: for failing pairs the
    reference also computes both directions.
    """
    from ..ops.distance import ratio_match_bidir

    n = desc.shape[0]
    if n <= 1:
        # no pairs; a (0, 2)-shaped scan would slice 0-d elements
        return jnp.zeros((n, n), jnp.int32)
    pairs = jnp.asarray([(i, j) for i in range(n) for j in range(n)
                         if i < j], jnp.int32)
    # scan over the UNORDERED i<j pair list with gathered operands — the
    # matcher body compiles ONCE and runs P times (an unrolled loop would
    # compile P copies). The bidirectional matcher returns both ordered
    # counts of a pair from one distance evaluation, so the triangle costs
    # what the reference pays for its one-directional pass.

    def body(carry, pair):
        i, j = pair[0], pair[1]
        # count[i, j] = |getImgPair(i, j)|: queries = j's descriptors
        # against i's reference set (ImageProcess.cpp:117-137)
        okq, _, okr, _ = ratio_match_bidir(
            desc[j], desc[i], valid[j], valid[i],
            cfg.match.ratio_threshold, cfg.match.distance,
            cfg.match.method, cfg.match.l2pre_m_counts)
        return carry, jnp.stack([jnp.sum(okq.astype(jnp.int32)),
                                 jnp.sum(okr.astype(jnp.int32))])

    _, counts = jax.lax.scan(body, jnp.int32(0), pairs)
    out = jnp.zeros((n, n), jnp.int32)
    out = out.at[pairs[:, 0], pairs[:, 1]].set(counts[:, 0])
    return out.at[pairs[:, 1], pairs[:, 0]].set(counts[:, 1])
