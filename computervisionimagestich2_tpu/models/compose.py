"""Canvas planning + compositing.

Host-side scalar planning (canvas bounds) + device compositing kernels,
equivalent to the canvas sizing and fill steps of the stitch loop
(/root/reference/ImageProcess.cpp:204-227):

- ``canvas_plan``  <- getMin/MaxX/YAfterWarping + the min/max clamps
  (ImageProcess.cpp:206-216, 532-594). Pure host math on 8 floats — the
  split puts shape decisions on the host so device shapes stay static (SURVEY.md §5 "Long-context" analog: canvas growth).
- ``composite``    <- warpingImageByHomography + movingImageByOffset
  (ImageProcess.cpp:596-620) as two fused gather kernels on one canvas.
"""
from __future__ import annotations

import math

import numpy as np

from ..ops.warp import shift_image, warp_image


def bucket_size(v: int, base: int = 128, ratio: float = 1.3) -> int:
    """Smallest size >= v from a geometric grid (base-aligned).

    Canvas growth per stitch edge is roughly an image width, so linear
    buckets still produce one compile per edge; a geometric grid bounds the
    number of distinct blend shapes to O(log canvas/base) for any chain
    length."""
    s = base
    while s < v:
        s = int(math.ceil(s * ratio / base) * base)
    return s


def warp_corners(coeffs: np.ndarray, w: int, h: int,
                 model: str = "bilinear") -> np.ndarray:
    """Warp the 4 corners (0,0), (w-1,0), (0,h-1), (w-1,h-1). [4, 2]."""
    c = np.asarray(coeffs, dtype=np.float32)
    xs = np.array([0, w - 1, 0, w - 1], np.float32)
    ys = np.array([0, 0, h - 1, h - 1], np.float32)
    if model == "bilinear":
        xw = c[0] * xs + c[1] * ys + c[2] * xs * ys + c[3]
        yw = c[4] * xs + c[5] * ys + c[6] * xs * ys + c[7]
    elif model == "projective":
        den = c[6] * xs + c[7] * ys + c[8]
        xw = (c[0] * xs + c[1] * ys + c[2]) / den
        yw = (c[3] * xs + c[4] * ys + c[5]) / den
    else:
        raise ValueError(model)
    return np.stack([xw, yw], axis=-1)


def canvas_plan(forward_coeffs: np.ndarray, src_shape: tuple[int, int],
                result_shape: tuple[int, int], model: str = "bilinear"):
    """New canvas size and offsets (ImageProcess.cpp:206-216).

    src_shape / result_shape: (H, W). Returns (new_h, new_w, min_x, min_y)
    with min_x/min_y floats (the offsets passed to the warp) — the reference
    clamps min to <= 0 and max to >= current result extents.
    """
    src_h, src_w = src_shape
    res_h, res_w = result_shape
    corners = warp_corners(forward_coeffs, src_w, src_h, model)
    min_x = float(min(corners[:, 0].min(), 0.0))
    min_y = float(min(corners[:, 1].min(), 0.0))
    max_x = float(max(corners[:, 0].max(), float(res_w)))
    max_y = float(max(corners[:, 1].max(), float(res_h)))
    new_w = int(math.ceil(max_x - min_x))
    new_h = int(math.ceil(max_y - min_y))
    return new_h, new_w, min_x, min_y


def composite(src_img, result_img, backward_coeffs, min_x: float, min_y: float,
              canvas_hw: tuple[int, int], model: str = "bilinear"):
    """Fill the two canvases of one stitch step.

    Returns (a, b): a = src_img inverse-warped through backward_coeffs,
    b = previous result shifted by the integer offsets
    (ImageProcess.cpp:218-224).
    """
    a = warp_image(src_img, backward_coeffs, np.float32(min_x),
                   np.float32(min_y), out_shape=canvas_hw, model=model)
    b = shift_image(result_img, np.int32(int(min_x)), np.int32(int(min_y)),
                    out_shape=canvas_hw)
    return a, b
