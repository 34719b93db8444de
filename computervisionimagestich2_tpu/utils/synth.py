"""Seeded synthetic panorama sweeps with known ground truth (numpy only).

``render_sweep`` paints a wide textured scene from a seed and cuts N
overlapping views of it through known camera yaws. Each view is rendered
through the exact inverse of the stitcher's cylindrical projection
(ops/warp.py::cylindrical_project, the reference's Projection.cpp:20-73),
so after projection adjacent frames are pure horizontal translations of
each other by ``radius * (yaw[i+1] - yaw[i])`` pixels, where ``radius`` is
the projection's cylinder radius. Small per-frame exposure gains mimic an
auto-exposing camera.

The texture is built for SIFT: multi-octave value noise (1/f-like, so the
keypoint density per pixel hardly depends on the frame size), blobs of
many radii, hard-edged polygons and soft gradients. Feature sizes are in
absolute pixels and feature counts scale with area, which keeps the
density near VLFeat's on natural photographs (about one keypoint per
200-300 px) at every resolution.

Frames are portrait (height >= width), like the reference's own sets: the
projection swaps axes for landscape input.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sweep:
    """A rendered sweep. ``frames`` are u8 RGB [H, W, 3] in scene order
    (left to right). ``offsets`` [N-1, 2] holds the true (dx, dy) of frame
    i+1 relative to frame i in the projected (cylindrical) frame, in
    pixels. ``span`` is the true width of the projected panorama."""

    frames: list
    offsets: np.ndarray
    yaws: np.ndarray
    radius: float
    span: float


def _upsample(grid: np.ndarray, h: int, w: int) -> np.ndarray:
    """Separable linear upsample of a small [gh, gw] grid to [h, w]."""
    gh, gw = grid.shape
    ys = np.linspace(0.0, gh - 1.0, h)
    xs = np.linspace(0.0, gw - 1.0, w)
    y0 = np.minimum(np.floor(ys).astype(np.int64), gh - 2)
    x0 = np.minimum(np.floor(xs).astype(np.int64), gw - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    rows = grid[y0] * (1.0 - fy) + grid[y0 + 1] * fy          # [h, gw]
    return rows[:, x0] * (1.0 - fx) + rows[:, x0 + 1] * fx


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Float32 RGB scene [h, w, 3] in 0..255."""
    area = h * w
    # 1/f-like value noise: octaves from 4 px to 256 px cells, amplitude
    # growing with the cell size, each octave with its own colour mix
    img = np.zeros((h, w, 3), np.float32)
    for cell in (4, 8, 16, 32, 64, 128, 256):
        gh, gw = h // cell + 2, w // cell + 2
        field = _upsample(rng.normal(size=(gh, gw)), h, w).astype(np.float32)
        mix = rng.uniform(0.5, 1.0, 3).astype(np.float32)
        img += (6.0 + 0.18 * cell) * field[..., None] * mix
    img += 128.0
    # soft gradients across the whole scene
    yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :, None]
    img += 20.0 * yy * rng.uniform(-1, 1, 3).astype(np.float32)
    img += 20.0 * np.sin(xx * rng.uniform(2, 5)).astype(np.float32)

    # blobs: radius log-uniform over 2..40 px, one per ~2500 px of scene
    n_blobs = area // 2500
    radii = np.exp(rng.uniform(math.log(2.0), math.log(40.0), n_blobs))
    cy = rng.uniform(0, h, n_blobs)
    cx = rng.uniform(0, w, n_blobs)
    cols = rng.uniform(0, 255, (n_blobs, 3)).astype(np.float32)
    for r, y, x, col in zip(radii, cy, cx, cols):
        y0, y1 = max(int(y - r) - 1, 0), min(int(y + r) + 2, h)
        x0, x1 = max(int(x - r) - 1, 0), min(int(x + r) + 2, w)
        if y0 >= y1 or x0 >= x1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        d2 = ((yy - y) ** 2 + (xx - x) ** 2) / (r * r)
        a = np.clip(1.5 - d2 * 1.5, 0.0, 1.0)[..., None]        # soft rim
        img[y0:y1, x0:x1] = img[y0:y1, x0:x1] * (1.0 - a) + col * a

    # hard-edged rectangles: corners and edges, one per ~40000 px
    for _ in range(area // 40000):
        rh, rw = rng.uniform(8, 90, 2)
        y, x = rng.uniform(0, h), rng.uniform(0, w)
        y0, y1 = int(max(y - rh / 2, 0)), int(min(y + rh / 2, h))
        x0, x1 = int(max(x - rw / 2, 0)), int(min(x + rw / 2, w))
        img[y0:y1, x0:x1] = (0.3 * img[y0:y1, x0:x1]
                             + 0.7 * rng.uniform(0, 255, 3))
    return np.clip(img, 0.0, 255.0)


def _bilinear(tex: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear read of tex [H, W, 3] at float coordinates (clamped)."""
    h, w = tex.shape[:2]
    x = np.clip(x, 0.0, w - 1.001)
    y = np.clip(y, 0.0, h - 1.001)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    top = tex[y0, x0] * (1 - fx) + tex[y0, x0 + 1] * fx
    bot = tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def render_sweep(seed: int, n_frames: int = 4, height: int = 1440,
                 width: int = 1080, overlap: float = 0.45,
                 angle_deg: float = 15.0, exposure: float = 0.04) -> Sweep:
    """Render ``n_frames`` overlapping portrait views of a seeded scene.

    ``overlap`` is the fraction of the frame width shared by adjacent
    projected frames; ``angle_deg`` must be the stitcher's
    ``ProjectionConfig.angle_deg`` for the ground truth to hold;
    ``exposure`` bounds each frame's random gain (1 +- exposure)."""
    if height < width:
        raise ValueError("render_sweep makes portrait frames (height >= "
                         f"width), got {height}x{width}")
    rng = np.random.default_rng(seed)
    half_w, half_h = width // 2, height // 2      # the projection's int centres
    radius = (width / 2.0) / math.tan(math.radians(angle_deg))
    step = (1.0 - overlap) * width
    # yaws jittered by up to 3% of a step, so offsets are not integers
    yaw_steps = step * (1.0 + rng.uniform(-0.03, 0.03, n_frames - 1))
    cyl = np.concatenate([[0.0], np.cumsum(yaw_steps)])   # cylinder offsets
    margin = 8
    tex = _texture(rng, height + 2 * margin,
                   int(math.ceil(cyl[-1])) + width + 2 * margin)

    # inverse of the projection's backward map s = u * sqrt(r^2 + u^2) / r:
    # the frame column s shows the cylinder column u
    s = np.arange(width, dtype=np.float64) - half_w
    u = np.sign(s) * np.sqrt(
        (-radius ** 2 + np.sqrt(radius ** 4 + 4.0 * s * s * radius ** 2))
        / 2.0)
    k = radius / np.sqrt(radius ** 2 + u * u)                # per column
    t = np.arange(height, dtype=np.float64)[:, None] - half_h
    v = t * k[None, :] + half_h + margin                     # [H, W]
    frames = []
    gains = 1.0 + rng.uniform(-exposure, exposure, n_frames)
    for i in range(n_frames):
        x = np.broadcast_to(u[None, :] + half_w + cyl[i] + margin, v.shape)
        img = _bilinear(tex, x, v) * gains[i]
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    offsets = np.stack([np.diff(cyl), np.zeros(n_frames - 1)], axis=-1)
    return Sweep(frames=frames, offsets=offsets,
                 yaws=cyl / radius, radius=radius,
                 span=float(cyl[-1] + width))


def plan_offsets(plan: np.ndarray, edge_seq, frame_hw, sweep: Sweep):
    """Per planned edge, the (dx, dy) of its dst frame relative to its src
    frame that the registration implies, beside the sweep's truth.

    ``plan`` and ``edge_seq`` are a Stitcher's (registration.plan_edges
    rows, BFS (src, dst, pre) triples). The forward warp of edge k maps
    dst-frame pixels into the canvas of step k; every frame already on
    the canvas moves by the int-truncated canvas minimum of each step (as
    the composite's offset copy moves its pixels), and the new frame sits
    where the forward warp put it. Evaluated at the frame centre.
    Returns [(src, dst, dx, dy, true_dx, true_dy), ...]."""
    h, w = frame_hw
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    truth_x = np.concatenate([[0.0], np.cumsum(sweep.offsets[:, 0])])
    truth_y = np.concatenate([[0.0], np.cumsum(sweep.offsets[:, 1])])
    pos = {edge_seq[0][0]: (0.0, 0.0)}
    out = []
    for k, (src, dst, _pre) in enumerate(edge_seq):
        c = plan[k, :8].astype(np.float64)
        fx = c[0] * cx + c[1] * cy + c[2] * cx * cy + c[3]
        fy = c[4] * cx + c[5] * cy + c[6] * cx * cy + c[7]
        out.append((src, dst, fx - cx - pos[src][0], fy - cy - pos[src][1],
                    truth_x[dst] - truth_x[src],
                    truth_y[dst] - truth_y[src]))
        min_x, min_y = float(plan[k, 18]), float(plan[k, 19])
        pos = {j: (px - math.trunc(min_x), py - math.trunc(min_y))
               for j, (px, py) in pos.items()}
        pos[dst] = (fx - cx - min_x, fy - cy - min_y)
    return out
