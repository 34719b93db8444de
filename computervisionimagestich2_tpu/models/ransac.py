"""RANSAC warp estimation — vmapped hypotheses instead of a sequential loop.

Equivalent of ImageProcess::RANSAC (/root/reference/ImageProcess.cpp:395-436):
sample 4 distinct pairs, solve the 8-coefficient bilinear warp, count inliers
(reprojection L2 < 4.0 over *all* pairs — the seed points are not excluded,
ImageProcess.cpp:478-480), keep the best, refit on its inliers by least
squares (getInlinerHomography, ImageProcess.cpp:500-529).

All K hypotheses run as one batch — K 4-point solves via a batched 4x4
linear solve, one [K, N] reprojection/inlier evaluation, argmax, then a
masked least-squares refit. K defaults to 128 (>= the
reference's 72 iterations computed from confidence 0.99 / inlier ratio 0.5).
RNG is threefry (jax.random); parity is on the refit model, which is stable
across RNGs at this hypothesis count (SURVEY.md §7 "RANSAC RNG").
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import RansacConfig
from ..core.types import MatchPairs
from ..ops.solve import solve_projective, solve_warp
from ..ops.warp import warp_points, warp_xy


@partial(jax.jit, static_argnames=("n_hypotheses", "threshold", "n_sample",
                                   "model", "lo_iters"))
def ransac_warp(pairs: MatchPairs, key: jax.Array,
                n_hypotheses: int = 128, threshold: float = 4.0,
                n_sample: int = 4, model: str = "bilinear",
                lo_iters: int = 0, corner_xy: jnp.ndarray | None = None,
                corner_span: jnp.ndarray | float | None = None):
    """Returns (coeffs, inlier_mask [N], n_inliers scalar). ``model`` picks
    the warp family: 'bilinear' (8 coeffs, reference behavior) or
    'projective' (9 coeffs, normalized DLT).

    ``lo_iters`` adds that many local-optimization rounds after the refit
    (LO-RANSAC, Chum et al.): re-score the refit model over all pairs and,
    if its consensus GREW, refit on the larger set — vectorized, so each
    round costs one [N] reprojection + one masked solve. The reference has
    no LO (its refit is final, ImageProcess.cpp:500-529); rounds that do
    not grow the consensus keep the previous model bit-for-bit, so lo_iters
    only ever moves the result toward a larger-consensus basin (the golden
    drift isolated by scripts/parity_refit.py, VERDICT r3 ask #6).

    PRECONDITION: ``pairs.valid`` must be PREFIX-compacted (all True
    entries first) — the matcher always produces this form
    (compact_indices), and the uniform sampler draws indices in
    [0, sum(valid)); a non-prefix mask would sample dead slots and
    never reach valid pairs past the prefix.

    ``corner_xy`` ([4, 2], optional): degenerate-model gate — a
    hypothesis whose warp maps these points (the incoming image's
    corners) further than ``corner_span`` from the valid pairs' bounding
    box scores ZERO inliers. A near-singular 4-point model can fit its
    own sample well while exploding at the image corners; the reference
    has no such guard and occasionally emits a canvas it cannot allocate
    (its catastrophic seeds, GOLDEN_ENVELOPE.md) — round 5 reproduced a
    45 GB canvas on dataset3 graph mode. The gate never fires on sane
    models (legitimate panorama warps keep corners within ~one image
    diagonal of the matched region), so clean registrations are
    bit-identical with or without it."""
    solve_fn = solve_warp if model == "bilinear" else solve_projective
    valid_f = pairs.valid.astype(jnp.float32)
    n_valid = jnp.maximum(jnp.sum(valid_f), 1.0)

    # uniform ints over the live PREFIX (matcher output is prefix-
    # compacted): [K, 4] threefry draws. The previous
    # jax.random.choice(replace=False, p=valid/n) ran a full Gumbel
    # perturbation + top-k over the [4096] capacity PER HYPOTHESIS; this
    # form is a handful of integer ops.
    # The reference re-rolls duplicate indices (ImageProcess.cpp:409-418)
    # — here a duplicate within a sample (~6/n_live chance per
    # hypothesis) makes the 4-point system singular -> nan/inf model ->
    # zero inliers, i.e. the hypothesis self-filters like any other
    # degenerate draw; K=128 vs the reference's 72 sequential iterations
    # leaves far more live hypotheses than the ~0.1% this loses.
    u = jax.random.uniform(key, (n_hypotheses, n_sample))
    sample_idx = jnp.minimum((u * n_valid).astype(jnp.int32),
                             (n_valid - 1.0).astype(jnp.int32))

    src_s = pairs.src_xy[sample_idx]                      # [K, 4, 2]
    dst_s = pairs.dst_xy[sample_idx]
    coeffs_k = jax.vmap(lambda s, d: solve_fn(s, d))(src_s, dst_s)

    # reprojection of every pair under every hypothesis: [K, N]
    x = pairs.src_xy[:, 0]
    y = pairs.src_xy[:, 1]
    xw, yw = jax.vmap(lambda c: warp_points(c, x, y, model))(coeffs_k)
    dx = xw - pairs.dst_xy[:, 0][None, :]
    dy = yw - pairs.dst_xy[:, 1][None, :]
    dist = jnp.sqrt(dx * dx + dy * dy)                    # [K, N]
    inliers = (dist < threshold) & pairs.valid[None, :]
    counts = jnp.sum(inliers.astype(jnp.int32), axis=1)   # [K]

    if corner_xy is not None:
        # degenerate-model gate (see docstring): corners of the incoming
        # image under each hypothesis must stay within corner_span of the
        # valid pairs' bbox; nan/inf corners fail the comparison too
        # the model maps src_xy -> dst_xy, so warped corners live in the
        # DST frame: bound them against the valid pairs' dst bbox
        big = 3e38
        dxv = jnp.where(pairs.valid, pairs.dst_xy[:, 0], big)
        dyv = jnp.where(pairs.valid, pairs.dst_xy[:, 1], big)
        lo_x = jnp.min(dxv) - corner_span
        lo_y = jnp.min(dyv) - corner_span
        hi_x = jnp.max(jnp.where(pairs.valid, pairs.dst_xy[:, 0], -big)) \
            + corner_span
        hi_y = jnp.max(jnp.where(pairs.valid, pairs.dst_xy[:, 1], -big)) \
            + corner_span
        cxw, cyw = jax.vmap(lambda c: warp_points(
            c, corner_xy[:, 0], corner_xy[:, 1], model))(coeffs_k)
        sane = jnp.all((cxw >= lo_x) & (cxw <= hi_x)
                       & (cyw >= lo_y) & (cyw <= hi_y), axis=1)   # [K]
        # zero the MASKS too, not just the counts: the refit/LO chain
        # runs on inliers[best] and would resurrect a gated hypothesis's
        # consensus otherwise
        inliers = inliers & sane[:, None]
        counts = jnp.where(sane, counts, 0)

    best = jnp.argmax(counts)
    best_mask = inliers[best]

    def refit(mask, init):
        if model == "bilinear":
            # warm-started residual refit: keeps every f32 intermediate at
            # O(threshold) px — without it the f32 normal equations drift
            # 1.8-3.6 px (corners) off the reference's f64 refit on the
            # SAME inlier set (scripts/parity_refit.py, RESULTS round 3)
            return solve_warp(pairs.src_xy, pairs.dst_xy,
                              mask.astype(jnp.float32), init=init)
        return solve_fn(pairs.src_xy, pairs.dst_xy,
                        mask.astype(jnp.float32))

    def score(coeffs):
        xw2, yw2 = warp_points(coeffs, x, y, model)
        d = jnp.sqrt((xw2 - pairs.dst_xy[:, 0]) ** 2
                     + (yw2 - pairs.dst_xy[:, 1]) ** 2)
        return (d < threshold) & pairs.valid

    coeffs = refit(best_mask, coeffs_k[best])
    mask, count = best_mask, counts[best]
    for _ in range(lo_iters):
        mask2 = score(coeffs)
        count2 = jnp.sum(mask2.astype(jnp.int32))
        grow = count2 > count
        coeffs2 = refit(mask2, coeffs)
        coeffs = jnp.where(grow, coeffs2, coeffs)
        mask = jnp.where(grow, mask2, mask)
        count = jnp.maximum(count2, count)

    if corner_xy is not None:
        # the REFIT can also go degenerate (a small near-collinear inlier
        # set makes the xy-term of the least squares explode — dense-graph
        # re-stitch edges, round 5); if the final
        # model fails the corner check, fall back to the gate-passing
        # best 4-point hypothesis. No-op for sane refits.
        fxw, fyw = warp_points(coeffs, corner_xy[:, 0], corner_xy[:, 1],
                               model)
        f_ok = jnp.all((fxw >= lo_x) & (fxw <= hi_x)
                       & (fyw >= lo_y) & (fyw <= hi_y)
                       & jnp.isfinite(fxw) & jnp.isfinite(fyw))
        coeffs = jnp.where(f_ok, coeffs, coeffs_k[best])
        mask = jnp.where(f_ok, mask, inliers[best])
        count = jnp.where(f_ok, count, counts[best])
    return coeffs, mask, count


def ransac_config_call(pairs: MatchPairs, cfg: RansacConfig,
                       key: jax.Array | None = None, salt: int = 0):
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    key = jax.random.fold_in(key, salt)
    return ransac_warp(pairs, key, cfg.n_hypotheses, cfg.threshold,
                       cfg.n_sample, lo_iters=cfg.lo_iters)


def reprojection_errors(coeffs: jnp.ndarray, pairs: MatchPairs) -> jnp.ndarray:
    """Per-pair reprojection L2 (the BASELINE.json parity metric)."""
    xw, yw = warp_xy(coeffs, pairs.src_xy[:, 0], pairs.src_xy[:, 1])
    return jnp.sqrt((xw - pairs.dst_xy[:, 0]) ** 2
                    + (yw - pairs.dst_xy[:, 1]) ** 2)
