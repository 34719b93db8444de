"""Compare our panorama against the reference's committed golden output.

Golden: /root/reference/src/ex6/dataset1/result.bmp (1057x525), produced by
the ex6 variant (chain ordering, 5/6:1/6 luma mix, min-dim pyramid levels)
on images identical to Input/ (verified by md5).

The golden is ONE RANDOM DRAW: the reference seeds RANSAC with
srand(time(0)) (src/ex6/ImageProcess.cpp:403). scripts/golden_envelope.py
re-runs the reference's own binary across seeds and measures its
self-variance vs the golden: successful runs score MAD 10.9..20.3 /
PSNR 16.8..21.6 dB / canvas width delta 4..25 px (and ~20% of seeds
catastrophically truncate the panorama to ~822 px). The gates below are
calibrated to that envelope (GOLDEN_ENVELOPE.md): our output must look like
*another reference run*, which is the strictest achievable standard.

Run (GPU or CPU):  python scripts/compare_golden.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import argparse

    from computervisionimagestich2_tpu.config import DEFAULT_CONFIG
    from computervisionimagestich2_tpu.models.stitcher import Stitcher
    from computervisionimagestich2_tpu.utils.cache import enable_compile_cache
    from computervisionimagestich2_tpu.utils.io import load_image

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--hypotheses", type=int, default=0,
                    help="override RansacConfig.n_hypotheses (attribution "
                         "experiments; 0 = config default)")
    ap.add_argument("--seed", type=int, default=0,
                    help="override the RANSAC base seed (our own "
                         "draw-envelope studies; 0 = reference's 666666)")
    ap.add_argument("--parity", action="store_true",
                    help="pin the reference-faithful algorithm pair: "
                         "exact-L1 matching (no l2pre matmul "
                         "prefilter) AND lo_iters=0 (the reference's "
                         "refit-and-stop RANSAC, ImageProcess.cpp:500-529)"
                         " — the perf defaults intentionally diverge")
    args = ap.parse_args()

    golden = load_image("/root/reference/src/ex6/dataset1/result.bmp")
    images = [load_image(f"/root/reference/src/ex6/dataset1/{i}.bmp")
              for i in range(1, 5)]

    cfg = dataclasses.replace(
        DEFAULT_CONFIG, ordering="chain",
        blend=dataclasses.replace(DEFAULT_CONFIG.blend, level_mode="min"),
        enhance=dataclasses.replace(DEFAULT_CONFIG.enhance,
                                    mix_weight=5.0 / 6.0))
    if args.hypotheses:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
            cfg.ransac, n_hypotheses=args.hypotheses))
    if args.seed:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
            cfg.ransac, seed=args.seed))
    if args.parity:
        cfg = dataclasses.replace(
            cfg,
            match=dataclasses.replace(cfg.match, method="exact"),
            ransac=dataclasses.replace(cfg.ransac, lo_iters=0))
    ours = Stitcher(cfg).stitch(images)

    gh, gw = golden.shape[:2]
    oh, ow = ours.shape[:2]
    h = min(gh, oh)
    w = min(gw, ow)
    a = golden[:h, :w].astype(np.float64)
    b = ours[:h, :w].astype(np.float64)
    # content-present overlap only (both non-black)
    m = (a.sum(-1) > 0) & (b.sum(-1) > 0)
    diff = np.abs(a - b)[m]
    mse = float((diff ** 2).mean())
    psnr = 10 * np.log10(255.0 ** 2 / mse) if mse > 0 else float("inf")
    report = {
        "golden_hw": [gh, gw],
        "ours_hw": [oh, ow],
        "canvas_delta": [abs(gh - oh), abs(gw - ow)],
        "overlap_frac": float(m.mean()),
        "mean_abs_diff": float(diff.mean()),
        "psnr_db": round(psnr, 2),
    }
    print(json.dumps(report))
    # Gates TIGHTENED round 3 (VERDICT r2 weak #3) after the coefficient-
    # level attribution closed the solver term: scripts/parity_refit.py now
    # measures our refit 0.045 px (corners) from the reference's f64 CImg
    # refit on the same inlier set (was 3.63 px before the warm-started
    # residual refit, ops/solve.py), and our post-fix score is MAD 19.6 /
    # PSNR 17.66 / canvas (1,5) vs the ref-vs-ref family 7.0..24.0 (median
    # 18.0, GOLDEN_ENVELOPE.md). Remaining drift is match-set level (one
    # edge settles in a different-but-equal RANSAC consensus basin).
    # Gates: MAD within median+2, PSNR at the successful-run median floor,
    # canvas within the tight spread — no longer the envelope's worst tail.
    ok = (abs(gh - oh) <= 4 and abs(gw - ow) <= 10
          and diff.mean() <= 20.0 and psnr >= 17.5)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
