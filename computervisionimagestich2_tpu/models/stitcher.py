"""Panorama stitching pipeline — the flagship model.

Equivalent of class ImageProcess (/root/reference/ImageProcess.cpp), re-built
as a host orchestrator driving jit-compiled device stages:

  per image:  cylindrical projection -> u8 luma -> SIFT        (device;
              one vmapped program over a uniform-shape batch)
  ordering:   match-graph discovery (root variant,
              ImageProcess.cpp:101-147) or pre-ordered chain
              (src/ex6/ImageProcess.cpp:150-159)               (host logic,
              device match counts, one readback)
  edges:      planned mode (default): ONE scanned device program
              registers every edge (matching x2, RANSAC x2, canvas
              bounds, feature updates — registration.plan_edges) and the
              host reads back a single [E, 23] plan; then one fused
              composite+blend dispatch per edge (banded gather-free warp
              when the plan admits it). Incremental mode keeps the
              reference's per-edge host loop (streaming-style).
  tail:       histogram equalization + YCbCr luma mix           (device)

In planned mode control crosses the host/device boundary a constant number
of times per panorama (upload, ordering counts, plan, final readback) —
not per edge (SURVEY.md §3 "process/device boundaries"). The reference's
per-edge feature-coordinate bookkeeping — update the newly warped image's
features by forward_H+offset and the *previous* stitched image's by offset
only (ImageProcess.cpp:226-227, the pre-chaining that exactly covers
BFS-from-middle chains) — is reproduced faithfully in both modes.
"""
from __future__ import annotations


import os
from collections import deque
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, StitchConfig
from ..core.types import Features
from ..ops.color import to_gray
from ..ops.warp import cylindrical_project, trunc_u8, warp_points
from ..utils import artifacts, obs
from ..utils.io import load_image, save_image
from . import compose
from .blender import blend_edge
from .equalization import equalize_and_mix
from .matcher import match_features_bidir
from .registration import all_pairs_match_counts, register_edge
from .sift import sift_extract


from functools import partial


@partial(jax.jit, static_argnames=("model",))
def _update_features_by_warp(feats: Features, coeffs: jnp.ndarray,
                             offset_x, offset_y,
                             model: str = "bilinear") -> Features:
    """updateFeaturesByHomography (ImageProcess.cpp:622-631)."""
    xw, yw = warp_points(coeffs, feats.xy[:, 0], feats.xy[:, 1], model)
    xy = jnp.stack([xw - offset_x, yw - offset_y], axis=-1)
    return feats._replace(xy=xy)


@jax.jit
def _update_features_by_offset(feats: Features, offset_x, offset_y) -> Features:
    """updateFeaturesByOffset (ImageProcess.cpp:633-640). Offsets are the
    int-truncated canvas mins at the call site (cpp:227)."""
    xy = feats.xy - jnp.stack([offset_x, offset_y])[None, :]
    return feats._replace(xy=xy)


@partial(jax.jit, static_argnames=("comp_hw", "out_hw", "cfg", "warp_bands"))
def _composite_and_blend(proj_dst, result, bwd, min_x, min_y,
                         comp_hw: tuple[int, int], out_hw: tuple[int, int],
                         cfg: StitchConfig,
                         warp_bands: tuple | None = None):
    """One fused per-edge device program: inverse warp + offset copy +
    (optional gain) + Laplacian blend + u8 truncation + crop, in a single
    dispatch per edge.

    ``warp_bands`` selects the warp kernel (host-validated via
    ops.warp.plan_edge_warp): ("banded", dy, dx) -> shift-select banded
    warp; None -> point gather."""
    from ..ops.warp import shift_image, warp_image, warp_image_banded

    if warp_bands is not None:
        a = warp_image_banded(proj_dst, bwd, min_x, min_y, comp_hw,
                              warp_bands[1], warp_bands[2],
                              model=cfg.warp_model)
    else:
        a = warp_image(proj_dst, bwd, min_x, min_y, out_shape=comp_hw,
                       model=cfg.warp_model)
    b = shift_image(result, min_x.astype(jnp.int32), min_y.astype(jnp.int32),
                    out_shape=comp_hw)
    from .blender import apply_composite_gain

    a = apply_composite_gain(a, b, cfg.blend, comp_hw[0], comp_hw[1])
    blended = blend_edge(a, b, cfg.blend, out_hw[0])
    return trunc_u8(blended[:out_hw[0], :out_hw[1]])


def bfs_edge_seq(adj: list[list[bool]], start: int,
                 revisit: str = "skip") -> list[tuple[int, int, int]]:
    """BFS stitch order from ``start`` (ImageProcess.cpp:149-236): returns
    (src, dst, pre) edge triples, where pre is the previously stitched
    image whose features get the offset-only update (cpp:226-227).
    Consumes ``adj`` (edges are cleared as visited) — pass a copy to keep it.

    ``revisit``: the reference clears edges pairwise but has NO
    visited-node guard (cpp:170-174) — on a dense match graph it
    re-stitches an already-placed image, solving a model between two
    CANVAS-frame feature sets and applying it to the ORIGINAL image
    pixels: coordinates explode and the canvas allocation dies (round 5
    reproduced a 19-billion-pixel plan on dataset3 graph mode; the
    reference author only ever ran graph mode on the 4-image sparse
    set). "skip" (default) emits a spanning TREE — each image stitched
    exactly once, bit-identical to the reference whenever its own run
    would not re-stitch (every golden/parity set) and a correct
    panorama where the reference would crash. "faithful" reproduces the
    reference's re-stitch behavior for semantics studies.
    """
    n = len(adj)
    neighbors = [[j for j in range(n) if adj[i][j]] for i in range(n)]
    edge_seq = []
    pre = start
    visited = {start}
    queue = deque([start])
    while queue:
        src_i = queue.popleft()
        for dst_i in reversed(neighbors[src_i]):
            if not adj[src_i][dst_i]:
                continue
            adj[src_i][dst_i] = adj[dst_i][src_i] = False
            if revisit == "skip" and dst_i in visited:
                continue
            visited.add(dst_i)
            queue.append(dst_i)
            edge_seq.append((src_i, dst_i, pre))
            pre = dst_i
    return edge_seq


def directed_adjacency(counts, threshold: int) -> list[list[bool]]:
    """The reference's sequential stichingMat fill (ImageProcess.cpp:117-137).

    Visiting (i, j) in row-major order: if stichingMat[j][i] is already true
    the edge is mirrored without recomputation; otherwise the (i, j)
    direction's own count decides. The result is directional in the rare
    asymmetric case (count[i][j] < T but count[j][i] >= T yields only the
    j->i edge)."""
    n = len(counts)
    adj = [[False] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if adj[j][i]:
                adj[i][j] = True  # 避免重复计算 shortcut, cpp:125-128
            else:
                adj[i][j] = bool(counts[i][j] >= threshold)
    return adj


class Stitcher:
    """Panorama stitcher with the reference's semantics and a batched
    device execution plan.

    ``mesh``: optional jax.sharding.Mesh — canvas composites and pyramid
    blends then run row-sharded over ``mesh[mesh_axis]`` devices (halo
    exchange, parallel.blend.sharded_composite_and_blend) whenever the edge
    qualifies (FIR blur, no gain compensation / seam band, canvas rows
    shardable); unqualified edges fall back to the single-device program.
    The multi-device form of SURVEY.md §5 "shard the canvas compositing
    across devices" as a pipeline MODE, not a demo.

    Telemetry of the last ``stitch``: ``sift_dropped`` ([N, 4] keypoints
    dropped by static capacities per image, see sift_extract_stats),
    ``edge_seq`` (the (src, dst, pre) stitch order) and ``plan`` (the
    [E, 23] registration plan in planned mode, see
    registration.plan_edges; column 22 counts dropped matches).
    """

    def __init__(self, config: StitchConfig = DEFAULT_CONFIG,
                 artifact_dir: str | None = None,
                 mesh=None, mesh_axis: str = "sp"):
        self.config = config
        self._timer = obs.StageTimer()
        self.artifact_dir = artifact_dir
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.sift_dropped = None
        self.edge_seq = None
        self.plan = None

    # ----------------------------------------------------------- mesh mode
    def _mesh_n(self) -> int:
        return int(self.mesh.shape[self.mesh_axis])

    def _mesh_edge_ok(self, comp_hw: tuple[int, int]) -> bool:
        """Host-side gate: can this edge (blend canvas ``comp_hw``) run
        row-sharded? FIR pyramid only, no gain or seam-band variant — the
        explicit ones or the area-gated seam-auto policy the single-device
        program would apply to this canvas (the sharded path blends the
        full canvas without gain) — and the rounded canvas must admit >= 1
        truly sharded pyramid level."""
        from ..parallel.blend import plan_shard_levels
        from .blender import n_levels, seam_auto_engaged

        cfg = self.config
        if (self.mesh is None or cfg.blend.gain_compensation
                or cfg.blend.seam_band > 0 or cfg.blend.blur_impl != "fir"
                or seam_auto_engaged(cfg.blend, *comp_hw)):
            return False
        h, w = self._mesh_comp_hw(comp_hw)
        levels = n_levels(h, w, cfg.blend.level_mode)
        return plan_shard_levels(h, levels, self._mesh_n(),
                                 cfg.blend.blur_sigma) >= 1

    def _mesh_comp_hw(self, comp_hw: tuple[int, int]) -> tuple[int, int]:
        """Round the working-canvas rows up so stripes shard evenly with at
        least one halved level (H % 2n == 0)."""
        n2 = 2 * self._mesh_n()
        h = -(-comp_hw[0] // n2) * n2
        return (h, comp_hw[1])

    @property
    def stage_times(self) -> dict[str, float]:
        return self._timer.times

    # ------------------------------------------------------------- features
    def prepare(self, images: Sequence[np.ndarray]):
        """Project + SIFT for each input image (readFile,
        ImageProcess.cpp:11-24). Returns (projected f32 arrays, Features).

        Uniform-shape batches run as one vmapped program — the true
        parallelism the reference's create-then-join threads only attempted
        (src/ex6/ImageProcess.cpp:44-50)."""
        cfg = self.config
        shapes = {np.asarray(img).shape for img in images}
        if len(shapes) == 1:
            from ..parallel.batched import _project_and_extract_vmapped

            # upload u8 (4x less host-to-device traffic), convert on device
            # inside the per-image program (no whole-batch f32 materialize)
            batch_u8 = jnp.asarray(np.stack([np.asarray(i) for i in images]))
            feats_stacked, proj_stacked, stats = _project_and_extract_vmapped(
                batch_u8, cfg)
            self._log_sift_overflow(stats)
            self._feats_stacked = feats_stacked
            feats = [jax.tree.map(lambda x, i=i: x[i], feats_stacked)
                     for i in range(len(images))]
            projected = [proj_stacked[i] for i in range(len(images))]
            return projected, feats
        self._feats_stacked = None
        projected, feats = [], []
        stats = []
        for img in images:
            from .sift import sift_extract_stats

            img_f = jnp.asarray(np.asarray(img)).astype(jnp.float32)
            proj = cylindrical_project(img_f, cfg.projection.angle_deg)
            gray = to_gray(proj)
            f, s = sift_extract_stats(gray, cfg.sift)
            feats.append(f)
            stats.append(s)
            projected.append(proj)
        self._log_sift_overflow(stats)
        return projected, feats

    def _log_sift_overflow(self, stats):
        """Report static-capacity truncation (never silent — VERDICT r1 #8).

        stats: [N, 4] or list of [4] int32: dropped [candidates, refined
        keypoints, descriptors, final-capacity keypoints] per image."""
        self.sift_dropped = np.asarray(
            jnp.stack(list(stats))
            if isinstance(stats, (list, tuple)) else stats)
        obs.log_sift_overflow(self.sift_dropped)

    def _matching_feats(self):
        """Stacked features trimmed to the live prefix for the matching
        stages. The storage capacity is sized with headroom (1/160 px,
        models/sift.py); matching cost should scale with what was FOUND,
        not the headroom — the l2pre candidate matmuls and the dense plan
        scans pay the full static cap. Slices every per-image array to
        max(live) rounded up to 512 (bucketed so at most a handful of
        matcher shapes compile per run). Valid masks are prefix-compacted,
        so the dropped tail is dead slots only — byte-identical results."""
        fs = self._feats_stacked
        if fs is None:
            return None
        lives = np.asarray(jnp.sum(fs.valid.astype(jnp.int32), axis=1))
        cap = fs.desc.shape[1]
        eff = -(-max(int(lives.max()), 512) // 512) * 512
        if eff >= cap:
            return fs
        return jax.tree.map(lambda a: a[:, :eff], fs)

    # ------------------------------------------------------------- ordering
    def _match_graph(self, feats) -> list[list[int]]:
        """All-pairs stitchability (ImageProcess.cpp:101-137). The
        reference's graph is DIRECTIONAL in the asymmetric case: visiting
        (i, j) mirrors stichingMat[j][i] only if it is already true;
        otherwise it computes getImgPair(i, j) in that direction, which can
        pass independently of the reverse (cpp:125-135). The sequential
        mirror rule is reproduced exactly; all directed pair counts run as
        one device program + one readback."""
        n = len(feats)
        cfg = self.config.match
        if getattr(self, "_feats_stacked", None) is not None:
            mf = self._matching_feats()
            counts = np.asarray(all_pairs_match_counts(
                mf.desc, mf.valid, self.config))
        else:
            # mixed-shape fallback: both ordered counts of a pair from ONE
            # distance evaluation (match_features_bidir), i<j only
            counts = np.zeros((n, n), np.int64)
            for i in range(n):
                for j in range(i + 1, n):
                    ij, ji = match_features_bidir(
                        feats[i], feats[j], cfg.ratio_threshold,
                        cfg.distance, cfg.max_matches, cfg.method,
                        cfg.l2pre_m_counts)
                    # n_raw = uncapped ok count, same statistic as the
                    # stacked all_pairs_match_counts path
                    counts[i][j] = int(np.asarray(ij.n_raw))
                    counts[j][i] = int(np.asarray(ji.n_raw))
        return directed_adjacency(counts, cfg.pair_threshold)

    @staticmethod
    def _chain_adjacency(n: int) -> list[list[bool]]:
        """ex6: images are pre-ordered left-to-right
        (src/ex6/ImageProcess.cpp:150-159)."""
        adj = [[False] * n for _ in range(n)]
        for i in range(n - 1):
            adj[i][i + 1] = adj[i + 1][i] = True
        return adj

    @staticmethod
    def _middle_index(adj: list[list[bool]]) -> int:
        """Intended behavior of getMiddleIndex (ImageProcess.cpp:353-393):
        walk the chain from an endpoint, return the middle of the walk.
        (The root variant's visited check is buggy — SURVEY.md §5 'race
        detection'; we implement the intent.)"""
        n = len(adj)
        degree = [sum(row) for row in adj]
        edge = next((i for i in range(n) if degree[i] == 1), 0)
        que, seen = [edge], {edge}
        cur = edge
        while True:
            nxt = next((j for j in range(n)
                        if adj[cur][j] and j not in seen), None)
            if nxt is None:
                break
            que.append(nxt)
            seen.add(nxt)
            cur = nxt
        return que[len(que) // 2]

    # ---------------------------------------------------------------- edges
    def _stitch_edge(self, result, feats, projected, src_i: int, dst_i: int,
                     pre_i: int):
        """One stitch step (ImageProcess.cpp:176-233). Returns
        (new_result, new_pre_index)."""
        cfg = self.config

        # one fused device program (matching x2 + swap + RANSAC x2), one
        # 16-float readback
        forward, backward, _, ovf = register_edge(
            feats[src_i], feats[dst_i], cfg, src_i * 65536 + dst_i,
            tuple(projected[dst_i].shape[:2]))
        if int(np.asarray(ovf)) > 0:
            obs.warn("match_overflow", src=src_i, dst=dst_i,
                    dropped=int(np.asarray(ovf)),
                    capacity=cfg.match.max_matches)
        both = np.asarray(jnp.stack([forward, backward]))
        fwd_host = both[0]
        if cfg.color_transfer:
            # the reference's disabled per-edge histogram normalization
            # (ImageProcess.cpp:180): match the incoming image's color
            # statistics to its stitch partner, writing back into the
            # projected buffer (as the reference's in-place output arg does)
            from .transfer import color_transfer

            projected[dst_i] = color_transfer(projected[dst_i],
                                              projected[src_i])
        src_shape = projected[dst_i].shape[:2]
        new_h, new_w, min_x, min_y = compose.canvas_plan(
            fwd_host, src_shape, result.shape[:2], cfg.warp_model)
        self._validate_canvas(new_h, new_w, src_shape,
                              f"edge ({src_i}, {dst_i})")

        if cfg.exact_canvas:
            comp_hw = (new_h, new_w)
        else:
            # pad the working canvas up a geometric size grid (O(log) blend
            # shapes per run), crop the blend result back to the exact size
            comp_hw = (compose.bucket_size(new_h, cfg.canvas_bucket),
                       compose.bucket_size(new_w, cfg.canvas_bucket))

        a, b = compose.composite(projected[dst_i], result, backward,
                                 min_x, min_y, comp_hw, cfg.warp_model)
        from .blender import apply_composite_gain

        a = apply_composite_gain(a, b, cfg.blend, comp_hw[0], comp_hw[1])

        feats[dst_i] = _update_features_by_warp(
            feats[dst_i], forward, jnp.float32(min_x), jnp.float32(min_y),
            cfg.warp_model)
        feats[pre_i] = _update_features_by_offset(
            feats[pre_i], jnp.float32(int(min_x)), jnp.float32(int(min_y)))

        blended = blend_edge(a, b, cfg.blend, new_h)
        return trunc_u8(blended[:new_h, :new_w]), dst_i

    @staticmethod
    def _validate_canvas(new_h, new_w, img_hw, where: str,
                         budget_edges: int = 1):
        """Single-edge form of _validate_plan for the incremental and
        streaming paths: refuse an unallocatable canvas with an
        actionable error instead of dying in the allocator."""
        h_img, w_img = img_hw
        bound = 64.0 * (budget_edges + 1) * float(h_img) * float(w_img) \
            + 16.0 * 4096 * 4096
        if (not np.isfinite([new_h, new_w]).all() or new_h < 1
                or new_w < 1 or float(new_h) * float(new_w) > bound):
            raise ValueError(
                f"degenerate registration at {where}: planned canvas "
                f"{new_w}x{new_h} exceeds the sanity bound. The match "
                "set likely admits only a near-singular warp — re-run "
                "with a different RansacConfig.seed, more n_hypotheses, "
                "or check that the images actually overlap.")

    @staticmethod
    def _validate_plan(plan, img_hw, n_edges):
        """Failure detection (SURVEY.md §5): refuse to composite a
        degenerate registration instead of attempting an unallocatable
        canvas. A near-singular RANSAC model can place an image corner
        millions of pixels away — the reference would try to allocate
        that CImg and die with an opaque alloc failure (its catastrophic
        seeds, GOLDEN_ENVELOPE.md); round 5 reproduced a 45 GB canvas on
        dataset3 graph mode before the ransac corner gate existed. The
        bound is generous (64x the total input area) so it can only fire
        on genuinely broken models."""
        h_img, w_img = img_hw
        dims = plan[:, 20:22]
        area_bound = 64.0 * (n_edges + 1) * h_img * w_img
        bad = (~np.isfinite(plan).all(axis=1)
               | (dims[:, 0] * dims[:, 1] > area_bound)
               | (dims < 1).any(axis=1))
        if bad.any():
            k = int(np.argmax(bad))
            raise ValueError(
                f"degenerate registration at edge {k}: planned canvas "
                f"{dims[k, 0]:.0f}x{dims[k, 1]:.0f} exceeds the sanity "
                f"bound ({area_bound:.0f} px total). The match set for "
                "this edge likely admits only a near-singular warp — "
                "re-run with a different RansacConfig.seed, more "
                "n_hypotheses, or check that the images actually "
                "overlap.")

    def _stitch_planned(self, result, projected, edge_seq):
        """Planned stitch: ONE device program registers every edge
        (registration.plan_edges), ONE readback returns the [E, 23] plan,
        then all composites/blends dispatch with no further host syncs —
        the per-edge round trips of the incremental loop disappear."""
        from .registration import plan_edges

        cfg = self.config
        img_hw = tuple(projected[edge_seq[0][1]].shape[:2])
        start_hw = tuple(result.shape[:2])
        edges = jnp.asarray(np.asarray(edge_seq, np.int32))
        plan = np.asarray(plan_edges(self._matching_feats(), edges, img_hw,
                                     start_hw, cfg))
        self.plan = plan
        self._validate_plan(plan, img_hw, len(edge_seq))

        n_coef = 9 if cfg.warp_model == "projective" else 8
        if cfg.color_transfer:
            from .transfer import color_transfer
        for k, (src_i, dst_i, pre_i) in enumerate(edge_seq):
            if cfg.color_transfer:
                # see _stitch_edge: the reference's disabled per-edge
                # normalization (ImageProcess.cpp:180); features/plan are
                # untouched (the reference transfers after getImgPair)
                projected[dst_i] = color_transfer(projected[dst_i],
                                                  projected[src_i])
            bwd = jnp.asarray(plan[k, 9:9 + n_coef])
            min_x, min_y = float(plan[k, 18]), float(plan[k, 19])
            new_w, new_h = int(plan[k, 20]), int(plan[k, 21])
            if cfg.exact_canvas:
                comp_hw = (new_h, new_w)
            else:
                comp_hw = (compose.bucket_size(new_h, cfg.canvas_bucket),
                           compose.bucket_size(new_w, cfg.canvas_bucket))
            if self.mesh is not None and self._mesh_edge_ok(comp_hw):
                from ..parallel.blend import sharded_composite_and_blend

                comp_hw = self._mesh_comp_hw(comp_hw)
                blended = sharded_composite_and_blend(
                    projected[dst_i], result, bwd, min_x, min_y, comp_hw,
                    self.mesh, self.mesh_axis, cfg.warp_model,
                    cfg.blend.level_mode, cfg.blend.blur_sigma,
                    content_h=new_h, dtype=cfg.blend.dtype)
                result = trunc_u8(blended[:new_h, :new_w])
            else:
                from ..ops.warp import plan_edge_warp

                wplan = plan_edge_warp(
                    plan[k, 9:9 + n_coef], comp_hw, min_x, min_y,
                    projected[dst_i].shape[:2], cfg.warp_model)
                result = _composite_and_blend(
                    projected[dst_i], result, bwd,
                    jnp.float32(min_x), jnp.float32(min_y), comp_hw,
                    (new_h, new_w), cfg, wplan)
            obs.log("edge", src=src_i, dst=dst_i, canvas=(new_h, new_w))
            if plan[k, 22] > 0:
                obs.warn("match_overflow", src=src_i, dst=dst_i,
                        dropped=int(plan[k, 22]),
                        capacity=cfg.match.max_matches)
        if self.mesh is not None and hasattr(result, "sharding"):
            # hand the enhance tail (default-device jits) a local array —
            # mixing mesh-committed operands into them raises
            result = jnp.asarray(np.asarray(result))
        return result

    # ---------------------------------------------------------------- resume
    def _resume_features(self, images: Sequence[np.ndarray]):
        """Reload SIFT features from the artifact dir and recompute only the
        (cheap) cylindrical projections — the dump half lives in prepare();
        this is the read half (SURVEY.md §5 "Checkpoint/resume"). Returns
        (projected, feats) exactly as prepare() would."""
        cfg = self.config
        feats = artifacts.load_features(f"{self.artifact_dir}/features.npz")
        if len(feats) != len(images):
            raise ValueError(
                f"resume artifact has {len(feats)} feature sets for "
                f"{len(images)} images — stale features.npz?")
        feats = [jax.tree.map(jnp.asarray, f) for f in feats]
        projected = []
        for img in images:
            img_f = jnp.asarray(np.asarray(img)).astype(jnp.float32)
            projected.append(
                cylindrical_project(img_f, cfg.projection.angle_deg))
        shapes = {f.desc.shape for f in feats}
        self._feats_stacked = (jax.tree.map(lambda *xs: jnp.stack(xs), *feats)
                               if len(shapes) == 1 else None)
        return projected, feats

    # ----------------------------------------------------------------- main
    def stitch(self, images: Sequence[np.ndarray],
               resume: bool = False) -> np.ndarray:
        """Full pipeline (ImageProcess ctor + matching). Returns the final
        u8 RGB panorama. With ``resume=True`` (requires ``artifact_dir``),
        the SIFT stage is skipped when ``features.npz`` already exists."""
        cfg = self.config
        resumed = (resume and self.artifact_dir
                   and os.path.exists(f"{self.artifact_dir}/features.npz"))
        with self._timer.stage("features"), obs.trace("features"):
            if resumed:
                projected, feats = self._resume_features(images)
                obs.log("resume", source=f"{self.artifact_dir}/features.npz")
            else:
                projected, feats = self.prepare(images)
            jax.block_until_ready(feats)
        if self.artifact_dir and not resumed:
            artifacts.save_features(
                f"{self.artifact_dir}/features.npz", feats)

        with self._timer.stage("ordering"):
            n = len(images)
            if cfg.ordering == "chain":
                adj = self._chain_adjacency(n)
                start = n // 2  # src/ex6/ImageProcess.cpp:163
            else:
                adj = self._match_graph(feats)
                start = self._middle_index(adj)
            obs.log("ordering", start=start,
                    edges=sum(map(sum, adj)) // 2)

        # BFS stitch loop (ImageProcess.cpp:149-236)
        with self._timer.stage("stitching"), obs.trace("stitching"):
            edge_seq = bfs_edge_seq(adj, start,
                                    getattr(cfg, "graph_revisit", "skip"))
            self.edge_seq = edge_seq
            self.plan = None

            result = projected[start]
            if (cfg.planned and edge_seq
                    and getattr(self, "_feats_stacked", None) is not None):
                result = self._stitch_planned(result, projected, edge_seq)
            else:
                for src_i, dst_i, pre_i in edge_seq:
                    result, _ = self._stitch_edge(result, feats, projected,
                                                  src_i, dst_i, pre_i)
                    obs.log("edge", src=src_i, dst=dst_i,
                            canvas=result.shape[:2])
            jax.block_until_ready(result)

        with self._timer.stage("enhance"):
            if cfg.enhance.enabled:
                final = equalize_and_mix(result, cfg.enhance.compat_luma,
                                         cfg.enhance.mix_weight)
            else:
                final = result
            # convert on device: the readback is u8, not f32 (4x traffic)
            final = np.asarray(final.astype(jnp.uint8))
        if self.artifact_dir:
            artifacts.save_stage(self.artifact_dir, "canvas", canvas=final)
            artifacts.save_manifest(self.artifact_dir, n_images=n,
                                    ordering=cfg.ordering,
                                    canvas_hw=list(final.shape[:2]))
        return final


def stitch(images: Sequence[np.ndarray],
           config: StitchConfig = DEFAULT_CONFIG) -> np.ndarray:
    return Stitcher(config).stitch(images)


def stitch_files(paths: Sequence[str],
                 config: StitchConfig = DEFAULT_CONFIG,
                 output: str | None = None) -> np.ndarray:
    out = stitch([load_image(p) for p in paths], config)
    if output:
        save_image(output, out)
    return out
