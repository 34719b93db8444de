"""Stream compaction: indices of set bits of a mask, in scan order, into a
static-capacity buffer.

Replacement for ``jnp.nonzero(size=...)``. XLA lowers nonzero to a
full-domain cumsum + scatter; this formulation is scatter-free on the large
domain:

  1. reshape the mask to [blocks, 128] lanes;
  2. per-block compaction by an ascending sort of ``where(mask, lane, 128)``
     — a bitonic row sort, vectorized across blocks;
  3. flatten the per-block lists with a searchsorted over the exclusive
     block-count prefix sum (log-depth gathers) + one 2-D gather.

Exactly matches nonzero's output (same scan order, same zero fill). Whether
it beats nonzero's scatter on the GPU is not measured yet.

The reference's analog is the dynamic keypoint append buffer
(/root/reference/vl/sift.c:580-590); SURVEY.md §7 "dynamic shape laundering"
calls for exactly this static-capacity compaction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_LANES = 128


def compact_indices(mask: jnp.ndarray, capacity: int):
    """Flat indices of True entries of ``mask`` (any shape), C-scan order.

    Returns (idx [capacity] int32, valid [capacity] bool). Slots past the
    population count hold 0 with valid=False — bit-identical to
    ``jnp.nonzero(mask.ravel(), size=capacity, fill_value=0)``.
    """
    flat = mask.reshape(-1)
    n = flat.shape[0]
    nb = -(-n // _LANES)
    padded = jnp.pad(flat, (0, nb * _LANES - n)).reshape(nb, _LANES)

    # sort keys are lane positions (0..128) — uint8 keys quarter the sort's
    # memory traffic vs int32 (the bitonic stages are bandwidth-bound; the
    # sorted order is identical)
    lane = lax.broadcasted_iota(jnp.uint8, (nb, _LANES), 1)
    skeys = lax.sort(jnp.where(padded, lane, jnp.uint8(_LANES)),
                     dimension=1).astype(jnp.int32)

    cnt = jnp.sum(padded, axis=1, dtype=jnp.int32)
    csum = jnp.cumsum(cnt)
    total = csum[-1]
    excl = csum - cnt

    j = jnp.arange(capacity, dtype=jnp.int32)
    # blk[j] = searchsorted(csum, j, "right") = #{b : csum[b] <= j}. The
    # direct searchsorted costs capacity x log2(nb) point gathers; as a
    # histogram of csum values + cumsum it is ONE nb-sized scatter-add.
    # For small capacities the gather tail is cheaper than the nb-scatter,
    # so pick by the static sizes.
    if capacity * 14 > nb:
        hist = jnp.zeros((capacity + 1,), jnp.int32)
        hist = hist.at[jnp.clip(csum, 0, capacity)].add(1, mode="drop")
        blk = jnp.cumsum(hist)[:-1]
    else:
        blk = jnp.searchsorted(csum, j, side="right")
    blk = jnp.clip(blk, 0, nb - 1).astype(jnp.int32)
    rank = jnp.clip(j - excl[blk], 0, _LANES - 1)
    idx = blk * _LANES + skeys[blk, rank]
    valid = j < total
    return jnp.where(valid, idx, 0), valid


def select_strongest(valid: jnp.ndarray, strength: jnp.ndarray,
                     capacity: int):
    """Indices of the ``capacity`` strongest valid entries, in scan order.

    Replacement for scan-order truncation when a static capacity binds
    (VERDICT r3 ask #2b): scan-order keeps the FIRST ``capacity`` entries —
    biased against whatever happens to be late in the scan (for SIFT,
    later octaves/rows) — while this keeps the strongest by ``strength``
    (> 0 for every valid entry), then re-sorts the kept set ascending so
    the output is prefix-compacted in the original scan order. When
    nothing would drop, the result is bit-identical to
    ``compact_indices(valid, capacity)``.

    Returns (idx [capacity] int32, valid [capacity] bool).
    """
    n = valid.shape[0]
    if capacity >= n:
        return compact_indices(valid, capacity)
    s = jnp.where(valid, strength, -1.0)
    _, top_idx = lax.top_k(s, capacity)
    keep_valid = s[top_idx] > 0.0
    order_key = jnp.where(keep_valid, top_idx, n)
    idx = jnp.sort(order_key)
    out_valid = idx < n
    return jnp.where(out_valid, idx, 0).astype(jnp.int32), out_valid


def compact_values(mask: jnp.ndarray, capacity: int, *arrays):
    """Compact ``arrays`` (same leading shape as mask) by a shared mask.

    Returns (valid [capacity] bool, *gathered arrays). Invalid slots hold
    the arrays' row 0 (callers must consult ``valid``).
    """
    idx, valid = compact_indices(mask, capacity)
    outs = tuple(a.reshape((-1,) + a.shape[mask.ndim:])[idx] for a in arrays)
    return (valid,) + outs
