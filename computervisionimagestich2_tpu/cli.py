"""CLI entry point.

Replaces the reference's two mains: the hardcoded-path variant
(/root/reference/main.cpp:3-11) and the stdin-driven ex6 variant
(/root/reference/src/ex6/main.cpp:3-13, which reads dataset name + image
count and writes result.bmp with wall-clock timing prints).
"""
from __future__ import annotations

import argparse
import os
import time


def build_config(args):
    """Thread parsed CLI flags into a StitchConfig (pure; unit-testable).

    Chain ordering flips the ex6 variant's knobs: 5/6:1/6 luma mix
    (src/ex6/ImageProcess.cpp:270 vs root's 19/20, ImageProcess.cpp:261)
    and min-dim pyramid levels (src/ex6/ImageProcess.cpp:662-665)."""
    import dataclasses

    from .config import DEFAULT_CONFIG

    cfg = dataclasses.replace(DEFAULT_CONFIG, ordering=args.ordering,
                              warp_model=args.warp_model,
                              exact_canvas=args.exact_canvas,
                              color_transfer=args.color_transfer)
    if args.no_enhance:
        cfg = dataclasses.replace(
            cfg, enhance=dataclasses.replace(cfg.enhance, enabled=False))
    if args.ordering == "chain":
        cfg = dataclasses.replace(
            cfg, enhance=dataclasses.replace(cfg.enhance, mix_weight=5.0 / 6.0),
            blend=dataclasses.replace(cfg.blend, level_mode="min"))
    if args.gain_compensation:
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend, gain_compensation=True))
    if args.gain_mode != "luma":
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend,
                                           gain_mode=args.gain_mode))
    if args.blend_dtype != "auto":
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend, dtype=args.blend_dtype))
    if args.seam_band:
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend,
                                           seam_band=args.seam_band))
    if args.no_seam_auto:
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend, seam_auto_area=0))
    if args.match_method != "exact" or args.l2pre_m:
        mrepl = {"method": args.match_method}
        if args.l2pre_m:
            mrepl["l2pre_m"] = args.l2pre_m
            mrepl["l2pre_m_counts"] = args.l2pre_m
        cfg = dataclasses.replace(
            cfg, match=dataclasses.replace(cfg.match, **mrepl))
    return cfg


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="panorama-tpu",
        description="JAX panorama stitcher "
                    "(images named 1.bmp..N.bmp in a directory)")
    p.add_argument("--input", required=True,
                   help="directory containing 1.bmp..N.bmp")
    p.add_argument("--count", type=int, default=None,
                   help="number of images (default: all i.bmp present)")
    p.add_argument("--output", default="result.bmp")
    p.add_argument("--ordering", choices=["graph", "chain"], default="graph",
                   help="graph = unordered discovery (root variant); "
                        "chain = pre-ordered left-to-right (ex6 variant)")
    p.add_argument("--timing", action="store_true",
                   help="print per-stage and end-to-end seconds "
                        "(the ex6 clock() print)")
    p.add_argument("--no-enhance", action="store_true",
                   help="skip the equalization/luma-mix tail")
    p.add_argument("--warp-model", choices=["bilinear", "projective"],
                   default="bilinear",
                   help="bilinear = reference-exact; projective = true DLT")
    p.add_argument("--gain-compensation", action="store_true",
                   help="match overlap luma before blending")
    p.add_argument("--gain-mode", choices=["luma", "rgb"], default="luma",
                   help="gain-compensation statistic: one scalar luma gain "
                        "or per-channel gains (also removes tint steps; "
                        "recommended with --seam-band)")
    p.add_argument("--blend-dtype", choices=["auto", "f32", "bf16"],
                   default="auto",
                   help="auto (default) = bf16 pyramid blend on canvases "
                        "over ~1.5 Mpx, f32 below; "
                        "f32 = parity mode; bf16 = force reduced precision "
                        "(a few u8 levels of rounding in smooth gradients)")
    p.add_argument("--no-seam-auto", action="store_true",
                   help="disable the area-gated automatic seam-band blend "
                        "(BlendConfig.seam_auto_area): full-canvas "
                        "reference blend at EVERY canvas size")
    p.add_argument("--seam-band", type=int, default=0, metavar="PX",
                   help="pyramid-blend only a 4*PX-wide window at each "
                        "seam, copying the rest (O(H x band) per edge "
                        "instead of O(H x canvas width)); 0 = the "
                        "reference's full-canvas blend (default). Pair "
                        "with --gain-compensation to absorb per-frame "
                        "exposure steps the narrow band can't hide")
    p.add_argument("--match-method", choices=["exact", "l2pre"],
                   default="exact",
                   help="L1 2-NN strategy: 'exact' = every descriptor "
                        "pair (default, parity mode); 'l2pre' = L2 "
                        "matmul candidate prefilter + exact-L1 rescore "
                        "(config.MatchConfig.method)")
    p.add_argument("--l2pre-m", type=int, default=0, metavar="M",
                   help="candidates rescored per query for l2pre (0 = "
                        "config defaults: 12 edges / 8 ordering counts; "
                        "sets BOTH when given)")
    p.add_argument("--color-transfer", action="store_true",
                   help="per-edge Reinhard color transfer of each incoming "
                        "image toward its stitch partner (the reference's "
                        "disabled call, ImageProcess.cpp:180)")
    p.add_argument("--exact-canvas", action="store_true",
                   help="composite/blend at the reference's exact canvas "
                        "size per edge (bitwise parity mode; one XLA "
                        "compile per distinct canvas — slow cold start)")
    p.add_argument("--bucketed-canvas", dest="exact_canvas",
                   action="store_false",
                   help="pad canvases onto a geometric size grid "
                        "(default: O(log) compiles for long chains; "
                        "output equal outside a thin seam band)")
    p.set_defaults(exact_canvas=False)
    p.add_argument("--sp", type=int, default=0, metavar="N",
                   help="shard canvas composites/blends row-wise over N "
                        "devices (jax.sharding Mesh + ppermute halo "
                        "exchange); 0 = single device. Requires "
                        "N visible devices and --bucketed-canvas")
    p.add_argument("--artifacts", default=None,
                   help="directory to dump per-stage npz artifacts")
    p.add_argument("--resume", action="store_true",
                   help="skip SIFT when --artifacts/features.npz exists "
                        "(dump-and-resume, SURVEY.md §5)")
    p.add_argument("--verbose", action="store_true",
                   help="structured stage logging to stderr")
    return p


def main(argv=None):
    p = make_parser()
    args = p.parse_args(argv)

    # pure argument validation happens before any image loads
    if args.resume and not args.artifacts:
        p.error("--resume requires --artifacts")

    # Persistent XLA compilation cache: later invocations with repeat
    # shapes reload compiled executables (utils/cache.py says where).
    from .utils.cache import enable_compile_cache

    enable_compile_cache()

    from .models.stitcher import Stitcher
    from .utils.io import load_image, save_image

    count = args.count
    if count is None:
        count = 0
        while os.path.exists(os.path.join(args.input, f"{count + 1}.bmp")):
            count += 1
    if count < 2:
        p.error(f"need at least 2 images, found {count} in {args.input}")

    paths = [os.path.join(args.input, f"{i}.bmp") for i in range(1, count + 1)]
    images = [load_image(pth) for pth in paths]

    cfg = build_config(args)
    if args.verbose:
        from .utils import obs

        obs.set_verbose(True)

    mesh = None
    if args.sp:
        import jax

        from .parallel.mesh import make_mesh

        if args.exact_canvas:
            p.error("--sp requires --bucketed-canvas (sharded stripes need "
                    "bucketed canvas rows)")
        if len(jax.devices()) < args.sp:
            p.error(f"--sp {args.sp} needs {args.sp} devices, have "
                    f"{len(jax.devices())}")
        mesh = make_mesh(args.sp, sp=args.sp)

    t0 = time.perf_counter()
    stitcher = Stitcher(cfg, artifact_dir=args.artifacts, mesh=mesh)
    out = stitcher.stitch(images, resume=args.resume)
    elapsed = time.perf_counter() - t0

    save_image(args.output, out)
    if args.timing:
        for stage, secs in stitcher.stage_times.items():
            print(f"{stage}: {secs:.3f} s")
        print(f"total time: {elapsed:.3f} s")
    print(f"wrote {args.output} ({out.shape[1]}x{out.shape[0]})")


if __name__ == "__main__":
    main()
