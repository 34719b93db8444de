"""Core data types.

The reference stores per-image state as ``struct Image`` with a
``map<vector<float>, VlSiftKeypoint>`` keyed by descriptor
(/root/reference/ImageProcess.h:50-55). Here: fixed-capacity aligned
arrays with validity masks — descriptors and coordinates stay index-aligned,
which removes the reference's O(log N * 128) reverse map lookup
(ImageProcess.cpp:333-338) entirely.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Features(NamedTuple):
    """SIFT features of one image, padded to a static capacity.

    desc:  [MAX_KP, 128] float32 — L2-normalized descriptors.
    xy:    [MAX_KP, 2]  float32 — keypoint (x, y) in image coords.
    scale: [MAX_KP]     float32 — keypoint sigma.
    valid: [MAX_KP]     bool.
    """

    desc: jnp.ndarray
    xy: jnp.ndarray
    scale: jnp.ndarray
    valid: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.desc.shape[0]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))

    @staticmethod
    def empty(capacity: int, desc_dim: int = 128) -> "Features":
        return Features(
            desc=jnp.zeros((capacity, desc_dim), jnp.float32),
            xy=jnp.zeros((capacity, 2), jnp.float32),
            scale=jnp.zeros((capacity,), jnp.float32),
            valid=jnp.zeros((capacity,), bool),
        )

    def with_xy(self, xy: jnp.ndarray) -> "Features":
        return self._replace(xy=xy)


jax.tree_util.register_pytree_node(
    Features,
    lambda f: (tuple(f), None),
    lambda _, leaves: Features(*leaves),
)


class MatchPairs(NamedTuple):
    """Matched keypoint coordinate pairs, padded to static capacity.

    src_xy, dst_xy: [MAX_M, 2] float32; valid: [MAX_M] bool.
    Mirrors vector<ImgPair> (ImageProcess.h:43-47).

    n_raw (optional scalar int32): the UNCAPPED ratio-test hit count.
    count() saturates at the static capacity, so overflow() > 0 flags
    truncation that would otherwise be silent.
    """

    src_xy: jnp.ndarray
    dst_xy: jnp.ndarray
    valid: jnp.ndarray
    n_raw: jnp.ndarray | None = None

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))

    def overflow(self) -> jnp.ndarray:
        """Matches dropped by the static capacity (0 when n_raw unknown)."""
        if self.n_raw is None:
            return jnp.int32(0)
        return jnp.maximum(self.n_raw - self.valid.shape[0], 0)

    def swapped(self) -> "MatchPairs":
        """Reverse direction (ImageProcess.cpp:185-198)."""
        return MatchPairs(self.dst_xy, self.src_xy, self.valid, self.n_raw)


jax.tree_util.register_pytree_node(
    MatchPairs,
    lambda m: (tuple(m), None),
    lambda _, leaves: MatchPairs(*leaves),
)
