"""Descriptor matching — exact all-pairs replacement for the kd-forest.

Equivalent of getImgPair (/root/reference/ImageProcess.cpp:273-351): for every
descriptor of image B, find its 2 nearest neighbors among image A's
descriptors (VlDistanceL1, 1 tree — ImageProcess.cpp:280), apply the Lowe
ratio test (< 0.5), and emit (A keypoint, B keypoint) coordinate pairs.

The tree descent becomes one dense [NB, NA] distance + top-2
(ops.distance), and the reference's descriptor-keyed reverse map lookup
(ImageProcess.cpp:333-338) disappears because descriptors and coordinates are
index-aligned (core.types.Features). Exact search can only increase match
parity vs the reference's approximate ANN.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import MatchConfig
from ..core.types import Features, MatchPairs
from ..ops import distance as dist_ops
from ..ops.compaction import compact_indices


@partial(jax.jit, static_argnames=("ratio", "distance", "max_matches",
                                   "method", "l2pre_m"))
def match_features(feats_a: Features, feats_b: Features,
                   ratio: float = 0.5, distance: str = "l1",
                   max_matches: int = 2048,
                   method: str = "exact",
                   l2pre_m: int = 32) -> MatchPairs:
    """Pairs with src = A's keypoint, dst = B's keypoint (the reference's
    ImgPair(left, right) order, ImageProcess.cpp:341)."""
    ok, idx_a = dist_ops.ratio_match(
        feats_b.desc, feats_a.desc, feats_b.valid, feats_a.valid,
        ratio, distance, method, l2pre_m)
    sel, valid = compact_indices(ok, max_matches)
    src_xy = feats_a.xy[idx_a[sel]]
    dst_xy = feats_b.xy[sel]
    return MatchPairs(src_xy=src_xy, dst_xy=dst_xy, valid=valid,
                      n_raw=jnp.sum(ok.astype(jnp.int32)))


@partial(jax.jit, static_argnames=("ratio", "distance", "max_matches",
                                   "method", "l2pre_m"))
def match_features_bidir(feats_a: Features, feats_b: Features,
                         ratio: float = 0.5, distance: str = "l1",
                         max_matches: int = 2048,
                         method: str = "exact",
                         l2pre_m: int = 32):
    """Both getImgPair directions from ONE distance evaluation.

    Returns (ab, ba) with ab == match_features(feats_a, feats_b, ...) and
    ba == match_features(feats_b, feats_a, ...) bit-identically; the
    reference rebuilds the kd-forest and re-queries per direction
    (ImageProcess.cpp:185-198), here the [NB, NA] distances are shared.
    """
    okb, idx_a, oka, idx_b = dist_ops.ratio_match_bidir(
        feats_b.desc, feats_a.desc, feats_b.valid, feats_a.valid,
        ratio, distance, method, l2pre_m)

    sel_b, valid_b = compact_indices(okb, max_matches)
    ab = MatchPairs(src_xy=feats_a.xy[idx_a[sel_b]],
                    dst_xy=feats_b.xy[sel_b], valid=valid_b,
                    n_raw=jnp.sum(okb.astype(jnp.int32)))
    sel_a, valid_a = compact_indices(oka, max_matches)
    ba = MatchPairs(src_xy=feats_b.xy[idx_b[sel_a]],
                    dst_xy=feats_a.xy[sel_a], valid=valid_a,
                    n_raw=jnp.sum(oka.astype(jnp.int32)))
    return ab, ba


@partial(jax.jit, static_argnames=("ratio", "distance", "method",
                                   "l2pre_m"))
def match_count(feats_a: Features, feats_b: Features,
                ratio: float = 0.5, distance: str = "l1",
                method: str = "exact",
                l2pre_m: int = 32) -> jnp.ndarray:
    """Number of ratio-test matches (the match-graph edge weight,
    ImageProcess.cpp:131-135)."""
    ok, _ = dist_ops.ratio_match(
        feats_b.desc, feats_a.desc, feats_b.valid, feats_a.valid,
        ratio, distance, method, l2pre_m)
    return jnp.sum(ok.astype(jnp.int32))


def match_config_call(feats_a: Features, feats_b: Features,
                      cfg: MatchConfig) -> MatchPairs:
    return match_features(feats_a, feats_b, cfg.ratio_threshold,
                          cfg.distance, cfg.max_matches, cfg.method,
                          cfg.l2pre_m)
