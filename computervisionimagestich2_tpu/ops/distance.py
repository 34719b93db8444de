"""All-pairs descriptor distances + top-2 selection.

Replacement for VLFeat's kd-forest ANN matcher
(/root/reference/vl/kdtree.c: vl_kdforest_build:530,
vl_kdforestsearcher_query:774) and the app's 2-NN + Lowe ratio wrapper
(ImageProcess.cpp:273-351). Instead of a per-query tree descent, the full
[NB, NA] distance matrix is computed densely (a matmul for L2, one fused
broadcast-abs-reduce for L1) and the 2 nearest neighbors come from one top-k — exact, so match parity can only
improve over the reference's approximate search.

Descriptors are fixed-width (128) with validity masks; invalid columns are
pushed to +inf so they never win the top-k.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# python float, not jnp scalar: module import must not initialize a backend
BIG = 3.0e38


def pairwise_l1(qry: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """L1 distances [NB, NA] between qry [NB, D] and ref [NA, D].

    Matches VlDistanceL1 (vl/mathop.c:308). XLA fuses the
    broadcast-abs-reduce into one loop nest; no [NB, NA, D] intermediate
    is materialized.
    """
    return jnp.sum(jnp.abs(qry[:, None, :] - ref[None, :, :]), axis=-1)


def pairwise_l2sq(qry: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """Squared-L2 distances via the matmul identity."""
    qn = jnp.sum(qry * qry, axis=-1, keepdims=True)
    rn = jnp.sum(ref * ref, axis=-1, keepdims=True)
    cross = jnp.dot(qry, ref.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(qn + rn.T - 2.0 * cross, 0.0)


def _use_l2pre(method: str) -> bool:
    if method not in ("exact", "l2pre"):
        raise ValueError(f"MatchConfig.method={method!r}")
    return method == "l2pre"


def _l1_rescore(qry, cand_desc, cand_idx, cand_ok):
    """Exact L1 top-2 over per-query candidate sets.

    qry [NQ, F]; cand_desc [NQ, M, F]; cand_idx [NQ, M] global reference
    indices; cand_ok [NQ, M] candidate validity. Returns (d1, d2, i1)."""
    d = jnp.sum(jnp.abs(qry[:, None, :] - cand_desc), axis=-1)
    d = jnp.where(cand_ok, d, BIG)
    j1 = jnp.argmin(d, axis=1)
    d1 = jnp.min(d, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    d2 = jnp.min(jnp.where(cols == j1[:, None], BIG, d), axis=1)
    i1 = jnp.take_along_axis(cand_idx, j1[:, None], axis=1)[:, 0]
    return d1, d2, i1


def _l2pre_one_direction(qry, ref, qry_valid, ref_valid, m: int,
                         precision=None):
    """One direction of the matmul-prefiltered L1 2-NN.

    The [NQ, NR] squared-L2 matrix is one matmul; ``approx_min_k`` keeps m
    candidates per query, and only those are rescored by exact L1. On the
    GPU ``approx_min_k`` lowers to an exact top-k, so the candidate sets
    are the true m nearest in L2. Match-set fidelity against the exact
    kernel is guarded by tests/test_match_ransac.py.

    ``precision`` is the selection matmul's precision only — the rescore
    is exact f32 either way. None = DEFAULT (TF32 on the GPU): the
    selection only ranks candidates for the exact-L1 rescore.
    """
    if precision is None:
        precision = jax.lax.Precision.DEFAULT
    qn = jnp.sum(qry * qry, axis=1, keepdims=True)
    rn = jnp.sum(ref * ref, axis=1)[None, :]
    cross = jnp.dot(qry, ref.T, preferred_element_type=jnp.float32,
                    precision=precision)
    d2sq = jnp.maximum(qn + rn - 2.0 * cross, 0.0)
    d2sq = jnp.where(ref_valid[None, :], d2sq, BIG)
    m = min(m, ref.shape[0])
    _, idx = jax.lax.approx_min_k(d2sq, m)
    cand = ref[idx]
    d1, d2, i1 = _l1_rescore(qry, cand, idx, ref_valid[idx])
    d1 = jnp.where(qry_valid, d1, BIG)
    d2 = jnp.where(qry_valid, d2, BIG)
    return d1, d2, i1


@partial(jax.jit, static_argnames=("distance", "method", "l2pre_m"))
def two_nearest(qry: jnp.ndarray, ref: jnp.ndarray,
                qry_valid: jnp.ndarray, ref_valid: jnp.ndarray,
                distance: str = "l1", method: str = "exact",
                l2pre_m: int = 32):
    """For every query descriptor, its 2 nearest reference descriptors.

    Returns (d1, d2, i1): nearest distance, second distance, nearest index —
    the inputs of the Lowe ratio test (ImageProcess.cpp:327-331). Invalid
    references never win; invalid queries get d1=d2=BIG.

    ``method`` picks the L1 strategy (config.MatchConfig.method): "l2pre"
    = candidate matmul + exact-L1 rescore; "exact" = every pair.
    """
    if distance == "l1" and _use_l2pre(method):
        return _l2pre_one_direction(qry, ref, qry_valid, ref_valid, l2pre_m)
    if distance == "l1":
        d = pairwise_l1(qry, ref)
    elif distance == "l2":
        d = pairwise_l2sq(qry, ref)
    else:
        raise ValueError(distance)
    d = jnp.where(ref_valid[None, :], d, BIG)
    # two min-reductions instead of top_k (top_k sorts; 2 passes are cheaper)
    i1 = jnp.argmin(d, axis=1)
    d1 = jnp.take_along_axis(d, i1[:, None], axis=1)[:, 0]
    cols = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    d2 = jnp.min(jnp.where(cols == i1[:, None], BIG, d), axis=1)
    d1 = jnp.where(qry_valid, d1, BIG)
    d2 = jnp.where(qry_valid, d2, BIG)
    return d1, d2, i1


@partial(jax.jit, static_argnames=("distance", "method", "l2pre_m"))
def two_nearest_bidir(qry: jnp.ndarray, ref: jnp.ndarray,
                      qry_valid: jnp.ndarray, ref_valid: jnp.ndarray,
                      distance: str = "l1", method: str = "exact",
                      l2pre_m: int = 32):
    """Both 2-NN directions from one distance evaluation.

    Returns ((d1q, d2q, i1q), (d1r, d2r, i1r)): the first tuple equals
    two_nearest(qry, ref, ...), the second the role-swapped
    two_nearest(ref, qry, ...) — same distances up to f32 reduction-order
    ulps (XLA may reassociate the feature reduce differently per matrix
    orientation), same first-lowest-index tie-breaks — at half the
    distance cost. The reference computes getImgPair twice per edge
    (ImageProcess.cpp:185-198); the distance matrix it rebuilds per
    direction is shared here. Under method="l2pre" each direction runs the
    matmul-prefiltered form (see two_nearest).
    """
    if distance == "l1" and _use_l2pre(method):
        fwd = _l2pre_one_direction(qry, ref, qry_valid, ref_valid, l2pre_m)
        bwd = _l2pre_one_direction(ref, qry, ref_valid, qry_valid, l2pre_m)
        return fwd, bwd
    if distance == "l1":
        d = pairwise_l1(qry, ref)
    elif distance == "l2":
        d = pairwise_l2sq(qry, ref)
    else:
        raise ValueError(distance)

    def top2(dm, axis, q_ok, r_ok):
        dm = jnp.where(r_ok, dm, BIG)
        i1 = jnp.argmin(dm, axis=axis)
        d1 = jnp.min(dm, axis=axis)
        idx = jax.lax.broadcasted_iota(jnp.int32, dm.shape, axis)
        sel = idx == jnp.expand_dims(i1, axis)
        d2 = jnp.min(jnp.where(sel, BIG, dm), axis=axis)
        d1 = jnp.where(q_ok, d1, BIG)
        d2 = jnp.where(q_ok, d2, BIG)
        return d1, d2, i1

    fwd = top2(d, 1, qry_valid, ref_valid[None, :])
    bwd = top2(d, 0, ref_valid, qry_valid[:, None])
    return fwd, bwd


@partial(jax.jit, static_argnames=("distance", "method", "l2pre_m"))
def ratio_match_bidir(qry: jnp.ndarray, ref: jnp.ndarray,
                      qry_valid: jnp.ndarray, ref_valid: jnp.ndarray,
                      ratio: float = 0.5, distance: str = "l1",
                      method: str = "exact", l2pre_m: int = 32):
    """Lowe ratio test in both directions from one distance evaluation.

    Returns (ok_q [NB], i1_q [NB], ok_r [NA], i1_r [NA]): the q pair equals
    ratio_match(qry, ref, ...), the r pair the role-swapped call.
    """
    (d1q, d2q, i1q), (d1r, d2r, i1r) = two_nearest_bidir(
        qry, ref, qry_valid, ref_valid, distance, method, l2pre_m)
    okq = ((d1q / d2q) < ratio) & qry_valid & (d2q < BIG)
    okr = ((d1r / d2r) < ratio) & ref_valid & (d2r < BIG)
    return okq, i1q, okr, i1r


@partial(jax.jit, static_argnames=("distance", "method", "l2pre_m"))
def ratio_match(qry: jnp.ndarray, ref: jnp.ndarray,
                qry_valid: jnp.ndarray, ref_valid: jnp.ndarray,
                ratio: float = 0.5, distance: str = "l1",
                method: str = "exact", l2pre_m: int = 32):
    """Lowe ratio test (ImageProcess.cpp:329-331): keep queries whose
    nearest/second distance ratio is < ratio.

    Returns (match_mask [NB], nearest_ref_index [NB]).
    """
    d1, d2, i1 = two_nearest(qry, ref, qry_valid, ref_valid, distance,
                             method, l2pre_m)
    ok = (d1 / d2) < ratio
    ok = ok & qry_valid & (d2 < BIG)
    return ok, i1
