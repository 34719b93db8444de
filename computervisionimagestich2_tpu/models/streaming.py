"""Streaming panorama: incremental registration + rolling canvas update.

BASELINE.json config 5 (a capability beyond the reference, which is strictly
batch): frames arrive one at a time (e.g. 30 fps video), each is registered
against the features of the previous frame (already in canvas coordinates),
composited, and blended into a rolling canvas.

Device specifics:
- Canvas sizes are rounded up to ``bucket``-pixel multiples so XLA compiles
  a handful of canvas shapes instead of one per frame (the answer to the
  reference's unbounded canvas growth, SURVEY.md §5).
- When the canvas exceeds ``max_width`` the oldest columns are dropped and
  feature coordinates shifted — a rolling window with O(1) memory.
- Per frame: one fused registration program + one 16-float readback, then
  composite+blend on device. The frame cadence is bounded by SIFT + one
  host round trip.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, StitchConfig
from ..ops.color import to_gray
from ..ops.warp import cylindrical_project, trunc_u8
from ..utils import obs
from . import compose
from .blender import blend_edge
from .registration import register_edge
from .sift import sift_extract
from .stitcher import _update_features_by_offset, _update_features_by_warp


def _bucket(v: int, bucket: int) -> int:
    return compose.bucket_size(v, bucket)


class StreamingStitcher:
    """Incremental panorama builder.

    Usage::

        ss = StreamingStitcher(max_width=4096)
        for frame in frames:
            ss.push(frame)            # RGB uint8 [H, W, 3]
        pano = ss.canvas()            # RGB uint8
    """

    def __init__(self, config: StitchConfig = DEFAULT_CONFIG,
                 max_width: int | None = None, project: bool = True,
                 anchor: str = "keyframe"):
        """``anchor`` picks the registration target for each new frame:

        - ``"keyframe"`` (default): register against a fixed keyframe's
          features for as long as the keyframe still yields at least
          ``config.match.pair_threshold`` ratio matches (the reference's
          THRESHOLD, ImageProcess.h:18), then promote the previous frame
          to keyframe. Registration error accumulates only across
          keyframe *switches*, not every frame.
        - ``"previous"``: register against the immediately previous
          frame (error compounds per frame; kept for comparison and for
          scenes with very low inter-frame overlap).
        """
        if anchor not in ("keyframe", "previous"):
            raise ValueError(f"unknown anchor mode {anchor!r}")
        self.config = config
        self.max_width = max_width
        self.project = project
        self.anchor = anchor
        self._result = None           # device [H, W, 3] float32
        self._feats = None            # prev frame Features, canvas coords
        self._kf_feats = None         # keyframe Features, canvas coords
        self._n_frames = 0
        self.n_keyframe_switches = 0

    def _prepare(self, frame: np.ndarray):
        img = jnp.asarray(np.asarray(frame)).astype(jnp.float32)
        if self.project:
            img = cylindrical_project(img, self.config.projection.angle_deg)
        feats = sift_extract(to_gray(img), self.config.sift)
        return img, feats

    def push(self, frame: np.ndarray) -> tuple[int, int]:
        """Ingest one frame; returns the current canvas (h, w)."""
        cfg = self.config
        img, feats = self._prepare(frame)
        if self._result is None:
            self._result = img
            self._feats = feats
            self._kf_feats = feats
            self._n_frames = 1
            return tuple(self._result.shape[:2])

        # per-frame edge id -> distinct RANSAC draws per frame
        target = (self._kf_feats if self.anchor == "keyframe"
                  else self._feats)
        forward, backward, n_matches, ovf = register_edge(
            target, feats, cfg, self._n_frames, tuple(img.shape[:2]))
        if (self.anchor == "keyframe"
                and int(np.asarray(n_matches)) < cfg.match.pair_threshold):
            # keyframe fell out of view: promote the previous frame and
            # re-register against it (drift resets to the promotion point)
            self._kf_feats = self._feats
            self.n_keyframe_switches += 1
            obs.log("stream_keyframe", frame=self._n_frames,
                    stale_matches=int(np.asarray(n_matches)))
            forward, backward, n_matches, ovf = register_edge(
                self._kf_feats, feats, cfg, self._n_frames,
                tuple(img.shape[:2]))
        if int(np.asarray(ovf)) > 0:
            obs.warn("match_overflow", frame=self._n_frames,
                    dropped=int(np.asarray(ovf)),
                    capacity=cfg.match.max_matches)
        both = np.asarray(jnp.stack([forward, backward]))

        ext_h, ext_w, min_x, min_y = compose.canvas_plan(
            both[0], img.shape[:2], self._result.shape[:2], cfg.warp_model)
        from .stitcher import Stitcher

        Stitcher._validate_canvas(ext_h, ext_w, img.shape[:2],
                                  f"stream frame {self._n_frames}")
        # bucket the canvas to bound recompilation; the pre-bucket extents
        # stay the seam-row content bound (models.blender.half_plane_mask)
        new_h = _bucket(ext_h, cfg.canvas_bucket)
        new_w = _bucket(ext_w, cfg.canvas_bucket)

        a, b = compose.composite(img, self._result, backward,
                                 min_x, min_y, (new_h, new_w),
                                 cfg.warp_model)
        from .blender import apply_composite_gain

        a = apply_composite_gain(a, b, cfg.blend, new_h, new_w)
        blended = blend_edge(a, b, cfg.blend, ext_h)
        self._result = trunc_u8(blended)

        # the new frame's features become the prev-frame anchor; the
        # keyframe's features ride the canvas-origin shift (the old result
        # moved by the int-truncated mins, ImageProcess.cpp:227)
        self._feats = _update_features_by_warp(
            feats, jnp.asarray(both[0]), jnp.float32(min_x),
            jnp.float32(min_y), cfg.warp_model)
        self._kf_feats = _update_features_by_offset(
            self._kf_feats, jnp.float32(int(min_x)), jnp.float32(int(min_y)))
        self._n_frames += 1

        if self.max_width and self._result.shape[1] > self.max_width:
            drop = self._result.shape[1] - self.max_width
            self._result = self._result[:, drop:]
            self._feats = _update_features_by_offset(
                self._feats, jnp.float32(drop), jnp.float32(0))
            self._kf_feats = _update_features_by_offset(
                self._kf_feats, jnp.float32(drop), jnp.float32(0))
        obs.log("stream", frame=self._n_frames,
                canvas=tuple(self._result.shape[:2]),
                matches=int(np.asarray(n_matches)))
        return tuple(self._result.shape[:2])

    def canvas(self) -> np.ndarray:
        if self._result is None:
            raise ValueError("no frames pushed")
        return np.asarray(self._result.astype(jnp.uint8))
