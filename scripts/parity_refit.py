"""Coefficient-level registration parity vs the reference (VERDICT r2 #5).

Runs OUR pipeline on dataset1 up to each edge's final match set, then fits
that SAME match set three ways:

1. ours      — ransac_warp (the pipeline's own fit, same keys as plan_edges)
2. ref-lsq   — the reference's compiled getInlinerHomography (CImg f64
               least squares, ImageProcess.cpp:507-536) on OUR inlier set:
               isolates solver-level parity from consensus selection
3. ref-ransac— the reference's full compiled RANSAC (srand(time(0)) under
               the FAKETIME shim, swept over seeds): its own
               consensus-selection envelope on our pairs

Deltas are reported as the max displacement of the warped image corners
(pixels) — the unit that moves the canvas. If ours-vs-ref-lsq is ~0 and
ours-vs-ref-ransac sits inside the ref-vs-ref envelope, the residual
golden-image drift (GOLDEN_ENVELOPE.md) is attributable to the MATCH SET
(SIFT sub-pixel + exact-vs-ANN matching), not to solve/refit.

Build first: sh scripts/build_ex6_ref.sh. Runs on a GPU or the CPU
(slower; set JAX_PLATFORMS=cpu).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFIT = os.path.join(REPO, "build", "refit_ref")
FAKETIME_SO = os.path.join(REPO, "build", "libfaketime.so")


def ref_fit(pairs_xy: np.ndarray, mode: str | None = None,
            seed: int | None = None) -> np.ndarray:
    """Run the reference's compiled fit on [N, 4] (sx, sy, dx, dy) rows."""
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        for sx, sy, dx, dy in pairs_xy:
            f.write(f"{sx:.9g} {sy:.9g} {dx:.9g} {dy:.9g}\n")
        path = f.name
    try:
        env = dict(os.environ)
        if seed is not None:
            env["FAKETIME"] = str(seed)
            env["LD_PRELOAD"] = FAKETIME_SO
        cmd = [REFIT, path] + ([mode] if mode else [])
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             check=True).stdout.split()
        coeffs = np.asarray([float(v) for v in out[:8]], np.float64)
        return coeffs, int(out[8])
    finally:
        os.unlink(path)


def corner_delta(c1, c2, w: int, h: int) -> float:
    """Max displacement (px) of the warped image corners between two
    8-coefficient bilinear warps (the canvas-plan-moving unit)."""
    def warp(c, x, y):
        return (c[0] * x + c[1] * y + c[2] * x * y + c[3],
                c[4] * x + c[5] * y + c[6] * x * y + c[7])
    worst = 0.0
    for x, y in ((0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1)):
        x1, y1 = warp(c1, x, y)
        x2, y2 = warp(c2, x, y)
        worst = max(worst, float(np.hypot(x1 - x2, y1 - y2)))
    return worst


def main():
    import jax
    import jax.numpy as jnp

    from computervisionimagestich2_tpu.utils.cache import (
        enable_compile_cache)

    enable_compile_cache()

    from computervisionimagestich2_tpu.config import DEFAULT_CONFIG
    from computervisionimagestich2_tpu.models.matcher import (
        match_features_bidir)
    from computervisionimagestich2_tpu.models.ransac import ransac_warp
    from computervisionimagestich2_tpu.models.registration import (
        all_pairs_match_counts, update_features_by_offset,
        update_features_by_warp, _canvas_bounds)
    from computervisionimagestich2_tpu.models.sift import sift_extract
    from computervisionimagestich2_tpu.models.stitcher import (
        Stitcher, bfs_edge_seq, directed_adjacency)
    from computervisionimagestich2_tpu.ops.color import to_gray
    from computervisionimagestich2_tpu.ops.warp import cylindrical_project
    from computervisionimagestich2_tpu.utils.io import load_image

    cfg = DEFAULT_CONFIG
    images = [load_image(f"/root/reference/src/ex6/dataset1/{i}.bmp")
              for i in range(1, 5)]
    feats = []
    for im in images:
        proj = cylindrical_project(jnp.asarray(im, jnp.float32),
                                   cfg.projection.angle_deg)
        feats.append(sift_extract(to_gray(proj), cfg.sift))

    counts = np.asarray(all_pairs_match_counts(
        jnp.stack([f.desc for f in feats]),
        jnp.stack([f.valid for f in feats]), cfg))
    adj = directed_adjacency(counts, cfg.match.pair_threshold)
    start = Stitcher._middle_index(adj)
    edge_seq = bfs_edge_seq(adj, start)
    h_img, w_img = images[0].shape[:2]

    report = {"edges": [], "seeds": 8}
    cur_w, cur_h = float(w_img), float(h_img)
    for src_i, dst_i, pre_i in edge_seq:
        # mirror register_edge: both directions from one pass, keep the
        # larger direction (ImageProcess.cpp:185-198)
        s2d, d2s = match_features_bidir(
            feats[src_i], feats[dst_i], cfg.match.ratio_threshold,
            cfg.match.distance, cfg.match.max_matches, cfg.match.method)
        use_s2d = int(np.asarray(s2d.n_raw)) > int(np.asarray(d2s.n_raw))
        # register_edge: forward fits d2s_final = s2d.swapped() if use_s2d
        # else d2s (the larger direction, swapped into src->dst form)
        fwd_pairs = s2d.swapped() if use_s2d else d2s

        key = jax.random.fold_in(jax.random.PRNGKey(cfg.ransac.seed),
                                 np.uint32(src_i * 65536 + dst_i))
        key_fwd = jax.random.fold_in(key, 0)
        ours, inl_mask, n_inl = ransac_warp(
            fwd_pairs, key_fwd, cfg.ransac.n_hypotheses,
            cfg.ransac.threshold, cfg.ransac.n_sample, cfg.warp_model)
        ours = np.asarray(ours, np.float64)

        valid = np.asarray(fwd_pairs.valid)
        sxy = np.asarray(fwd_pairs.src_xy)[valid]
        dxy = np.asarray(fwd_pairs.dst_xy)[valid]
        pairs_xy = np.concatenate([sxy, dxy], axis=1)

        # solver parity: reference LSQ on OUR inlier set
        inl = np.asarray(inl_mask)[valid]
        ref_lsq, _ = ref_fit(pairs_xy[inl], mode="lsq")
        d_lsq = corner_delta(ours, ref_lsq, w_img, h_img)

        # consensus parity: reference RANSAC envelope on our pairs
        ref_runs = [ref_fit(pairs_xy, seed=1700000000 + 7919 * s)
                    for s in range(report["seeds"])]
        ref_fits = [rf for rf, _ in ref_runs]
        ref_ninl = [ni for _, ni in ref_runs]
        d_ref = [corner_delta(ours, rf, w_img, h_img) for rf in ref_fits]
        d_env = [corner_delta(a, b, w_img, h_img)
                 for i, a in enumerate(ref_fits) for b in ref_fits[i + 1:]]

        report["edges"].append({
            "edge": [int(src_i), int(dst_i)],
            "n_pairs": int(valid.sum()),
            "n_inliers": int(np.asarray(n_inl)),
            "n_inliers_ref_ransac": ref_ninl,
            "corner_px_ours_vs_ref_lsq_same_inliers": round(d_lsq, 4),
            "corner_px_ours_vs_ref_ransac": [round(d, 3) for d in d_ref],
            "corner_px_ref_vs_ref_envelope": [round(d, 3) for d in d_env],
        })

        # advance OUR pipeline state exactly as plan_edges does
        min_x, min_y, new_w, new_h = map(float, np.asarray(_canvas_bounds(
            jnp.asarray(ours, jnp.float32), w_img, h_img, cur_w, cur_h,
            cfg.warp_model)))
        feats[dst_i] = update_features_by_warp(
            feats[dst_i], jnp.asarray(ours, jnp.float32),
            jnp.float32(min_x), jnp.float32(min_y), cfg.warp_model)
        feats[pre_i] = update_features_by_offset(
            feats[pre_i], jnp.float32(int(min_x)), jnp.float32(int(min_y)))
        cur_w, cur_h = new_w, new_h

    lsq_max = max(e["corner_px_ours_vs_ref_lsq_same_inliers"]
                  for e in report["edges"])
    med = lambda v: float(np.median(v))
    report["summary"] = {
        "solver_parity_max_corner_px": lsq_max,
        "ours_vs_ref_ransac_median_px": round(med(
            [d for e in report["edges"]
             for d in e["corner_px_ours_vs_ref_ransac"]]), 3),
        "ref_vs_ref_envelope_median_px": round(med(
            [d for e in report["edges"]
             for d in e["corner_px_ref_vs_ref_envelope"]]), 3),
    }
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
