"""RANSAC consensus-basin analysis for the residual golden drift
(VERDICT r3 ask #6 fallback: "a written analysis showing the basin is
genuinely bistable in the reference too").

scripts/parity_refit.py closed the SOLVER term (our refit is 0.045 px
from the reference's f64 refit on identical inliers) and attributed the
remaining golden MAD to one edge settling in a different-but-equal
RANSAC consensus basin. This script tests whether that split is OUR
artifact or intrinsic to the problem:

For each dataset1 chain edge, on the IDENTICAL final match set:
  - run OUR vmapped RANSAC over ``--sweep`` different key salts,
  - run the REFERENCE'S compiled RANSAC (srand via the FAKETIME shim)
    over ``--sweep`` seeds,
then cluster the resulting refit models by warped-corner displacement
(two fits are one basin if their corners agree within ``--tol`` px —
half the 4 px inlier threshold) and report each basin's frequency and
inlier count for both implementations.

Verdict: if the reference's own RANSAC also lands in >1 basin on the
drifting edge (with comparable frequencies), the drift is an intrinsic
consensus ambiguity of the match set — any reference run is one draw
from the same family, and the golden gate should stand on the
ref-vs-ref envelope, not on basin agreement.

Build the oracle first: sh scripts/build_ex6_ref.sh. Runs on a GPU or
the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from scripts.parity_refit import corner_delta, ref_fit


def cluster(fits, w, h, tol):
    """Greedy leader clustering by corner displacement."""
    basins = []          # list of (leader_coeffs, [member indices])
    for i, c in enumerate(fits):
        for leader, members in basins:
            if corner_delta(leader, c, w, h) <= tol:
                members.append(i)
                break
        else:
            basins.append((c, [i]))
    return basins


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
        _canvas_bounds, all_pairs_match_counts, update_features_by_offset,
        update_features_by_warp)
    from computervisionimagestich2_tpu.models.sift import sift_extract
    from computervisionimagestich2_tpu.models.stitcher import (
        Stitcher, bfs_edge_seq, directed_adjacency)
    from computervisionimagestich2_tpu.ops.color import to_gray
    from computervisionimagestich2_tpu.ops.warp import cylindrical_project
    from computervisionimagestich2_tpu.utils.io import load_image

    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", type=int, default=24)
    ap.add_argument("--tol", type=float, default=2.0)
    args = ap.parse_args()

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

    report = {"sweep": args.sweep, "tol_px": args.tol, "edges": []}
    cur_w, cur_h = float(w_img), float(h_img)
    for src_i, dst_i, pre_i in edge_seq:
        s2d, d2s = match_features_bidir(
            feats[src_i], feats[dst_i], cfg.match.ratio_threshold,
            cfg.match.distance, cfg.match.max_matches, cfg.match.method)
        use_s2d = int(np.asarray(s2d.n_raw)) > int(np.asarray(d2s.n_raw))
        fwd_pairs = s2d.swapped() if use_s2d else d2s

        valid = np.asarray(fwd_pairs.valid)
        pairs_xy = np.concatenate([np.asarray(fwd_pairs.src_xy)[valid],
                                   np.asarray(fwd_pairs.dst_xy)[valid]], 1)

        # OUR RANSAC across salts (the pipeline's own key first)
        ours_fits, ours_ninl = [], []
        base = jax.random.fold_in(jax.random.PRNGKey(cfg.ransac.seed),
                                  np.uint32(src_i * 65536 + dst_i))
        for s in range(args.sweep):
            key = jax.random.fold_in(base, 0) if s == 0 \
                else jax.random.fold_in(base, 1000 + s)
            c, _, n = ransac_warp(fwd_pairs, key, cfg.ransac.n_hypotheses,
                                  cfg.ransac.threshold, cfg.ransac.n_sample,
                                  cfg.warp_model, cfg.ransac.lo_iters)
            ours_fits.append(np.asarray(c, np.float64))
            ours_ninl.append(int(np.asarray(n)))

        # REFERENCE RANSAC across seeds on the same pairs
        ref_fits, ref_ninl = [], []
        for s in range(args.sweep):
            c, n = ref_fit(pairs_xy, seed=1700000000 + 7919 * s)
            ref_fits.append(c)
            ref_ninl.append(n)

        def basin_row(fits, ninl):
            rows = []
            for leader, members in cluster(fits, w_img, h_img, args.tol):
                rows.append({
                    "freq": len(members) / len(fits),
                    "n_inliers": [ninl[i] for i in members[:4]],
                    "corners_vs_basin0": round(
                        corner_delta(fits[0], leader, w_img, h_img), 2),
                })
            return rows

        cross = min(corner_delta(o, r, w_img, h_img)
                    for o in ours_fits for r in ref_fits)
        edge_row = {
            "edge": [int(src_i), int(dst_i)],
            "n_pairs": int(valid.sum()),
            "ours_basins": basin_row(ours_fits, ours_ninl),
            "ref_basins": basin_row(ref_fits, ref_ninl),
            "min_cross_impl_corner_px": round(cross, 2),
        }
        report["edges"].append(edge_row)
        print(json.dumps(edge_row), flush=True)

        # advance the pipeline state with the pipeline's own fit
        ours = ours_fits[0]
        min_x, min_y, new_w, new_h = map(float, np.asarray(_canvas_bounds(
            jnp.asarray(ours, jnp.float32), w_img, h_img, cur_w, cur_h,
            cfg.warp_model)))
        feats[dst_i] = update_features_by_warp(
            feats[dst_i], jnp.asarray(ours, jnp.float32),
            jnp.float32(min_x), jnp.float32(min_y), cfg.warp_model)
        feats[pre_i] = update_features_by_offset(
            feats[pre_i], jnp.float32(int(min_x)), jnp.float32(int(min_y)))
        cur_w, cur_h = new_w, new_h

    print(json.dumps(report["edges"] and {
        "multibasin_edges_ours": sum(
            1 for e in report["edges"] if len(e["ours_basins"]) > 1),
        "multibasin_edges_ref": sum(
            1 for e in report["edges"] if len(e["ref_basins"]) > 1),
    }))


if __name__ == "__main__":
    main()
