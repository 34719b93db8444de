"""Chip smoke test: stitch seeded panoramas on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # one GPU: phases a-d
    python3 chip_smoke.py --multi    # four GPUs: phase e only

Phases (each failure exits non-zero; the last stdout line is one JSON
object, ``{"ok": true, "device": {...}}`` on success):

a. Device: JAX's first device must be a GPU (no CPU fallback); prints the
   card's name and power limit from nvidia-smi.
b. End to end: a seeded 4 x 1440x1080 sweep (utils/synth.py) through
   ``Stitcher`` with the default config (graph ordering). Every planned
   edge's translation must be within 3 px of the scene's true offset, the
   canvas width within 2% of the true span, and no keypoint, candidate,
   descriptor or match may be dropped by a static capacity. Prints the
   cold and the median warm wall time, with the SIFT kernels on (the
   default) and off (the plain XLA batch).
c. GPU against CPU: the same kind of seeded set at 4 x 512x384 stitched
   on the GPU and on ``jax.devices("cpu")`` in this process: canvas
   shapes within 2 px, mean absolute difference over the shared content
   at most 3 u8 levels.
d. Kernels: the orientation and descriptor kernels (ops/sift_triton.py)
   against the XLA formulation on octave-0 keypoint lists of a 1440x1080
   seeded frame, both in f32 at HIGHEST precision; prints both times.
   Also times the plain-JAX alternatives the stitcher chooses between:
   exact against l2pre matching, banded against gather warps.
e. (--multi) Four GPUs: Stitcher(mesh=make_mesh(4, sp=4)) against the
   single-device panorama on the 4 x 1440x1080 set of (b) (full-canvas
   blend, so every edge takes the sharded path), and
   parallel.batched_stitch_chain over four seeded 4 x 512x384 sets (the
   reference's Input/ shape, BASELINE config 3) sharded on data=4 against
   each set stitched alone.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# phase (c) needs the CPU backend beside the GPU
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

FRAME_HW = (1440, 1080)
SMALL_HW = (512, 384)
N_FRAMES = 4


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def timed(fn, *args):
    """Wall ms of fn(*args), blocked on its result."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) * 1e3, out


def median_ms(fn, *args, runs: int = 5) -> float:
    return float(np.median([timed(fn, *args)[0] for _ in range(runs)]))


# ------------------------------------------------------------------ phases
def phase_device(n_devices: int):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (first device: {devs[0].platform})")
    check(len(devs) >= n_devices,
          f"need {n_devices} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}")
    print(f"jax: {jax.__version__} devices={len(devs)} "
          f"kind={devs[0].device_kind}")
    return devs


def check_against_truth(stitcher, out, sweep, frame_hw, label: str):
    from computervisionimagestich2_tpu.utils.synth import plan_offsets

    drops = np.asarray(stitcher.sift_dropped)
    check(drops.sum() == 0, f"{label}: SIFT dropped {drops.tolist()} "
          "(candidates, keypoints, descriptors, final) per image")
    plan = stitcher.plan
    check(plan is not None, f"{label}: no registration plan")
    check(float(plan[:, 22].sum()) == 0,
          f"{label}: matches dropped per edge {plan[:, 22].tolist()}")
    worst = 0.0
    for src, dst, dx, dy, tx, ty in plan_offsets(
            plan, stitcher.edge_seq, frame_hw, sweep):
        err = max(abs(dx - tx), abs(dy - ty))
        worst = max(worst, err)
        print(f"  {label} edge {src}->{dst}: measured ({dx:.2f}, {dy:.2f}) "
              f"true ({tx:.2f}, {ty:.2f}) px")
        check(err <= 3.0, f"{label}: edge {src}->{dst} off by {err:.2f} px")
    width = out.shape[1]
    check(abs(width - sweep.span) <= 0.02 * sweep.span,
          f"{label}: canvas width {width} vs true span {sweep.span:.1f}")
    print(f"  {label}: {len(stitcher.edge_seq)} edges, worst edge error "
          f"{worst:.2f} px, canvas {out.shape[1]}x{out.shape[0]} "
          f"(true span {sweep.span:.1f}), drops 0")


def phase_end_to_end(seed: int, frame_hw=FRAME_HW):
    from computervisionimagestich2_tpu.config import DEFAULT_CONFIG
    from computervisionimagestich2_tpu.models.stitcher import Stitcher
    from computervisionimagestich2_tpu.utils.synth import render_sweep

    sweep = render_sweep(seed, N_FRAMES, *frame_hw)
    xla = dataclasses.replace(
        DEFAULT_CONFIG,
        sift=dataclasses.replace(DEFAULT_CONFIG.sift, pallas="off"))
    tag = f"{N_FRAMES}x{frame_hw[0]}x{frame_hw[1]}"
    result = {}
    for label, cfg in (("kernels", DEFAULT_CONFIG), ("xla", xla)):
        st = Stitcher(cfg)
        cold, out = timed(st.stitch, sweep.frames)
        check_against_truth(st, out, sweep, frame_hw, label)
        warm = median_ms(st.stitch, sweep.frames)
        result[label] = (cold, warm)
        stages = ", ".join(f"{k} {v * 1e3:.3f}"
                           for k, v in st.stage_times.items())
        print(f"(b) {tag} stitch [{label}]: cold {cold:.1f} ms, "
              f"warm median of 5 {warm:.3f} ms (last run's host stage "
              f"walls, ms: {stages})")
    return result


def shared_mad(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute difference over pixels where both panoramas have
    content, on their common top-left crop."""
    h, w = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
    a = a[:h, :w].astype(np.int32)
    b = b[:h, :w].astype(np.int32)
    both = (a.sum(-1) > 0) & (b.sum(-1) > 0)
    return float(np.abs(a - b)[both].mean())


def phase_gpu_vs_cpu(seed: int, frame_hw=SMALL_HW):
    import jax

    from computervisionimagestich2_tpu.models.stitcher import Stitcher
    from computervisionimagestich2_tpu.utils.synth import render_sweep

    sweep = render_sweep(seed, N_FRAMES, *frame_hw)
    gpu = Stitcher().stitch(sweep.frames)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = Stitcher().stitch(sweep.frames)
    dh = abs(gpu.shape[0] - cpu.shape[0])
    dw = abs(gpu.shape[1] - cpu.shape[1])
    mad = shared_mad(gpu, cpu)
    print(f"(c) {N_FRAMES}x{frame_hw[0]}x{frame_hw[1]}: gpu canvas "
          f"{gpu.shape[1]}x{gpu.shape[0]}, cpu canvas "
          f"{cpu.shape[1]}x{cpu.shape[0]}, shared-content MAD {mad:.3f}")
    check(dh <= 2 and dw <= 2, "(c) canvas shapes differ by more than 2 px")
    check(mad <= 3.0, f"(c) GPU/CPU MAD {mad:.3f} > 3 u8 levels")


def octave0_lists(gray, cfg):
    """Level-0 keypoint and keypoint-angle lists of octave 0, built the
    way models/sift.py::_process_octave builds them."""
    import jax.numpy as jnp

    from computervisionimagestich2_tpu.models import sift
    from computervisionimagestich2_tpu.ops import sift_kernels as sk

    h, w = gray.shape
    first, _ = sift.scale_space_sigmas(cfg)
    octave = sift.build_octave(gray, cfg, first)
    dog = sk.dog_stack(octave)
    coords, cvalid = sk.compact_mask(sk.extrema_mask(dog, cfg.peak_thresh),
                                     sift.candidate_capacity(h, w))
    ok, x, y, sigma, lvl, _ = sk.refine_keypoints(
        dog, coords, cvalid, w, h, cfg.peak_thresh, cfg.edge_thresh,
        cfg.s_min, cfg.s_max, 1.0, cfg.sigma0, cfg.n_levels)
    grad = sk.polar_gradient(octave[1:1 + cfg.n_levels])
    cap_l = max(128, 2 * sift.keypoint_capacity(h, w, 0) // 3)
    idx, valid = sk.compact_indices(ok & (lvl == 0), cap_l)
    return grad[0], x[idx], y[idx], sigma[idx], valid


def phase_kernels(seed: int, frame_hw=FRAME_HW):
    import jax
    import jax.numpy as jnp

    from computervisionimagestich2_tpu.config import SiftConfig
    from computervisionimagestich2_tpu.ops import sift_kernels as sk
    from computervisionimagestich2_tpu.ops import sift_triton as st
    from computervisionimagestich2_tpu.ops.color import to_gray
    from computervisionimagestich2_tpu.ops.warp import cylindrical_project
    from computervisionimagestich2_tpu.utils.synth import render_sweep

    cfg = SiftConfig()
    frame = render_sweep(seed, 1, *frame_hw).frames[0]
    gray = to_gray(cylindrical_project(jnp.asarray(frame, jnp.float32),
                                       15.0))
    h, w = gray.shape
    grad, x, y, sigma, valid = octave0_lists(gray, cfg)
    n_live = int(valid.sum())
    r_ori = sk.ori_patch_radius(cfg.sigma0, cfg.n_levels, cfg.s_max, 0)
    r_desc = sk.desc_patch_radius(cfg.sigma0, cfg.n_levels, cfg.s_max,
                                  cfg.magnif, cfg.n_spatial_bins, 0)
    print(f"(d) octave 0 of a {h}x{w} frame: {n_live} level-0 keypoints "
          f"in {x.shape[0]} slots, r_ori={r_ori} r_desc={r_desc}")

    @jax.jit
    def ori_xla(grad, x, y, sigma, valid):
        gp = jnp.pad(jnp.moveaxis(grad, 0, -1)[None],
                     ((0, 0), (r_ori, r_ori), (r_ori, r_ori), (0, 0)))
        return sk.orientation_histograms(
            gp, jnp.zeros(x.shape[0], jnp.int32), x, y, sigma, valid, w, h,
            r_ori, cfg.n_ori_bins, cfg.max_angles)

    @jax.jit
    def ori_kernel(grad, x, y, sigma, valid):
        hist, ok = st.orientation_hist(grad[0], grad[1], x, y, sigma, valid,
                                       w, h, r_ori, cfg.n_ori_bins)
        return sk.orientation_peaks(hist, ok, cfg.n_ori_bins,
                                    cfg.max_angles)

    args = (grad, x, y, sigma, valid)
    (ang_x, av_x), (ang_k, av_k) = ori_xla(*args), ori_kernel(*args)
    av_x, av_k = np.asarray(av_x), np.asarray(av_k)
    both = av_x & av_k
    d_ang = np.abs(np.asarray(ang_x) - np.asarray(ang_k))[both]
    d_ang = np.minimum(d_ang, 2 * np.pi - d_ang)
    n_diff = int((av_x != av_k).sum())
    t_x, t_k = median_ms(ori_xla, *args), median_ms(ori_kernel, *args)
    print(f"(d) orientation [f32 HIGHEST]: xla {t_x:.3f} ms, kernel "
          f"{t_k:.3f} ms; {int(av_x.sum())} angles, {n_diff} differ in "
          f"presence, max angle diff {d_ang.max():.2e} rad")
    check(n_diff <= max(2, av_x.sum() // 1000),
          f"(d) orientation peaks differ at {n_diff} slots")
    check(d_ang.max() <= 1e-3, "(d) orientation angles differ > 1e-3 rad")

    # descriptors on the expanded keypoint x angle list (XLA's angles)
    m = cfg.max_angles
    rep = lambda a: jnp.repeat(a, m)
    dx, dy, ds = rep(x), rep(y), rep(sigma)
    da, dv = ang_x.reshape(-1), jnp.asarray(av_x.reshape(-1))
    cap_d = x.shape[0] + x.shape[0] // 2
    idx, dvalid = sk.compact_indices(dv, cap_d)
    dargs = (grad, dx[idx], dy[idx], ds[idx], da[idx], dvalid)

    @jax.jit
    def desc_xla(grad, x, y, sigma, angle, valid):
        gp = jnp.pad(jnp.moveaxis(grad, 0, -1)[None],
                     ((0, 0), (r_desc, r_desc), (r_desc, r_desc), (0, 0)))
        return sk.descriptors(gp, jnp.zeros(x.shape[0], jnp.int32), x, y,
                              sigma, angle, valid, w, h, r_desc, cfg.magnif,
                              cfg.n_spatial_bins / 2.0, cfg.n_spatial_bins,
                              cfg.n_desc_ori_bins)

    @jax.jit
    def desc_kernel(grad, x, y, sigma, angle, valid):
        return st.descriptors(grad[0], grad[1], x, y, sigma, angle, valid,
                              w, h, r_desc, cfg.magnif,
                              cfg.n_spatial_bins / 2.0, cfg.n_spatial_bins,
                              cfg.n_desc_ori_bins)

    (d_x, ok_x), (d_k, ok_k) = desc_xla(*dargs), desc_kernel(*dargs)
    ok_x, ok_k = np.asarray(ok_x), np.asarray(ok_k)
    d_x, d_k = np.asarray(d_x)[ok_x], np.asarray(d_k)[ok_x]
    cos = (d_x * d_k).sum(1) / np.maximum(
        np.linalg.norm(d_x, axis=1) * np.linalg.norm(d_k, axis=1), 1e-30)
    rel = np.abs(d_x - d_k).max() / max(np.abs(d_x).max(), 1e-30)
    t_x, t_k = median_ms(desc_xla, *dargs), median_ms(desc_kernel, *dargs)
    print(f"(d) descriptors [f32 HIGHEST]: xla {t_x:.3f} ms, kernel "
          f"{t_k:.3f} ms; {int(ok_x.sum())} descriptors in {cap_d} slots, "
          f"min cosine {cos.min():.7f}, max diff / max value {rel:.2e}")
    check(np.array_equal(ok_x, ok_k), "(d) descriptor validity differs")
    check(cos.min() >= 0.99999, f"(d) descriptor cosine {cos.min()}")
    return x.shape[0]


def phase_alternatives(seed: int, frame_hw=FRAME_HW):
    """Times of the plain-JAX alternatives the stitcher picks between
    (no hand-written kernel involved): the matcher's exact and l2pre
    strategies, and the banded and gather warps of the (b) edges."""
    import jax
    import jax.numpy as jnp

    from computervisionimagestich2_tpu.config import DEFAULT_CONFIG
    from computervisionimagestich2_tpu.models.stitcher import Stitcher
    from computervisionimagestich2_tpu.ops import distance
    from computervisionimagestich2_tpu.ops.warp import (
        cylindrical_project, plan_edge_warp, warp_image, warp_image_banded)
    from computervisionimagestich2_tpu.utils.synth import render_sweep

    sweep = render_sweep(seed, N_FRAMES, *frame_hw)
    st = Stitcher(DEFAULT_CONFIG)
    st.stitch(sweep.frames)
    feats = st._matching_feats()
    mcfg = DEFAULT_CONFIG.match
    src, dst, _ = st.edge_seq[0]
    args = (feats.desc[dst], feats.desc[src], feats.valid[dst],
            feats.valid[src])
    runs = {}
    for method, m in (("exact", mcfg.l2pre_m), ("l2pre", mcfg.l2pre_m)):
        fn = jax.jit(lambda q, r, qv, rv, method=method, m=m:
                     distance.ratio_match_bidir(q, r, qv, rv,
                                                mcfg.ratio_threshold, "l1",
                                                method, m))
        runs[method] = (median_ms(fn, *args), fn(*args))
    ex, l2 = runs["exact"][1], runs["l2pre"][1]
    n_diff = int((np.asarray(ex[0]) != np.asarray(l2[0])).sum()
                 + (np.asarray(ex[2]) != np.asarray(l2[2])).sum())
    print(f"(d) matcher edge {src}->{dst} ({int(args[2].sum())} x "
          f"{int(args[3].sum())} live of {args[0].shape[0]} slots): exact "
          f"{runs['exact'][0]:.3f} ms, l2pre m={mcfg.l2pre_m} "
          f"{runs['l2pre'][0]:.3f} ms, {n_diff} decisions differ")

    proj = [cylindrical_project(jnp.asarray(f, jnp.float32), 15.0)
            for f in sweep.frames]
    plan = st.plan
    for k, (_, dst_i, _) in enumerate(st.edge_seq):
        bwd = jnp.asarray(plan[k, 9:17])
        min_x, min_y = float(plan[k, 18]), float(plan[k, 19])
        hw = (int(plan[k, 21]), int(plan[k, 20]))
        wplan = plan_edge_warp(plan[k, 9:17], hw, min_x, min_y,
                               proj[dst_i].shape[:2])
        gather = jax.jit(lambda s, c, ox, oy, hw=hw:
                         warp_image(s, c, ox, oy, out_shape=hw))
        wargs = (proj[dst_i], bwd, jnp.float32(min_x), jnp.float32(min_y))
        t_g = median_ms(gather, *wargs)
        line = (f"(d) warp edge {k} canvas {hw[1]}x{hw[0]}: gather "
                f"{t_g:.3f} ms")
        if wplan is not None:
            banded = jax.jit(lambda s, c, ox, oy, hw=hw, b=wplan:
                             warp_image_banded(s, c, ox, oy, hw, b[1], b[2]))
            t_b = median_ms(banded, *wargs)
            same = bool(np.array_equal(np.asarray(gather(*wargs)),
                                       np.asarray(banded(*wargs))))
            line += (f", banded (dy={wplan[1]}, dx={wplan[2]}) {t_b:.3f} ms,"
                     f" identical={same}")
        else:
            line += ", banded refused by the planner"
        print(line)


def phase_multi(seed: int, frame_hw=FRAME_HW, batch_hw=SMALL_HW,
                n: int = 4):
    import jax
    import jax.numpy as jnp

    from computervisionimagestich2_tpu.config import DEFAULT_CONFIG
    from computervisionimagestich2_tpu.models.sift import kernel_route
    from computervisionimagestich2_tpu.models.stitcher import Stitcher
    from computervisionimagestich2_tpu.parallel import make_mesh
    from computervisionimagestich2_tpu.parallel.batched import (
        batched_stitch_chain, shard_batch)
    from computervisionimagestich2_tpu.utils.synth import render_sweep

    # bucketed canvases (the sharded blend needs them) and the full-canvas
    # blend at every size: canvases past BlendConfig.seam_auto_area take
    # the seam-band blend, which has no sharded form, so with the default
    # gate every 1440x1080 edge would fall back to one device
    cfg = dataclasses.replace(
        DEFAULT_CONFIG, exact_canvas=False,
        blend=dataclasses.replace(DEFAULT_CONFIG.blend, seam_auto_area=0))
    sweep = render_sweep(seed, N_FRAMES, *frame_hw)
    mesh = make_mesh(n, sp=n)
    ids = sorted(d.id for d in mesh.devices.flat)
    check(len(set(ids)) == n, f"(e) mesh devices {ids} are not distinct")
    single = Stitcher(cfg).stitch(sweep.frames)
    t_mesh, meshed = timed(Stitcher(cfg, mesh=mesh).stitch, sweep.frames)
    check(meshed.shape == single.shape,
          f"(e) mesh canvas {meshed.shape} vs single {single.shape}")
    diff = np.abs(meshed.astype(np.int32) - single.astype(np.int32))
    frac = float((diff > 1).mean())
    print(f"(e) Stitcher mesh sp={n} on devices {ids}: canvas "
          f"{meshed.shape[1]}x{meshed.shape[0]}, {frac:.2e} of pixels "
          f"differ by >1 u8 from one device (cold {t_mesh:.1f} ms)")
    check(frac < 1e-3, f"(e) mesh panorama differs at {frac:.2e} of pixels")

    sets = np.stack([np.stack(render_sweep(seed + 1 + i, N_FRAMES,
                                           *batch_hw).frames)
                     for i in range(n)])
    dmesh = make_mesh(n, sp=1)
    (sharded,) = shard_batch(dmesh, jnp.asarray(sets))
    canv, plans = batched_stitch_chain(sharded, cfg)
    jax.block_until_ready(canv)
    shard_devs = sorted({s.device.id for s in canv.addressable_shards})
    check(len(shard_devs) == n,
          f"(e) batched output lives on devices {shard_devs}")
    for i in range(n):
        c1, p1 = batched_stitch_chain(jnp.asarray(sets[i:i + 1]), cfg)
        d = np.abs(np.asarray(canv[i]) - np.asarray(c1[0]))
        frac = float((d > 1).mean())
        ext = float(np.abs(np.asarray(plans[i])[:, 18:22]
                           - np.asarray(p1[0])[:, 18:22]).max())
        print(f"(e) batched set {i} on device {shard_devs[i]}: {frac:.2e} "
              f"of pixels differ by >1 u8 from the set alone, plan "
              f"extents within {ext:.3f} px")
        check(frac < 1e-3 and ext <= 1.0,
              f"(e) batched set {i} differs from its lone stitch")
    lone = jnp.asarray(sets[:1])
    t_b = median_ms(lambda: batched_stitch_chain(sharded, cfg)[0])
    t_1 = median_ms(lambda: batched_stitch_chain(lone, cfg)[0])
    print(f"(e) batched {n}x{N_FRAMES}x{batch_hw[0]}x{batch_hw[1]} on "
          f"data={n} [SIFT route {kernel_route(cfg.sift)}]: warm median of "
          f"5 {t_b:.3f} ms; one set on one device {t_1:.3f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU phase (e)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n_dev = 4 if args.multi else 1
    t0 = time.perf_counter()
    try:
        devs = phase_device(n_dev)
        from computervisionimagestich2_tpu.utils.cache import (
            enable_compile_cache)

        print(f"compile cache: {enable_compile_cache() or 'as set by env'}")
        phases = ([phase_multi] if args.multi else
                  [phase_end_to_end, phase_gpu_vs_cpu, phase_kernels,
                   phase_alternatives])
        for phase in phases:
            phase(args.seed)
            print(f"{phase.__name__} done at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    except (PhaseError, ImportError, subprocess.SubprocessError,
            OSError) as e:
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}))
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
