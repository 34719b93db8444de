"""SIFT feature extraction — scale-space driver.

Re-design of VLFeat's octave-at-a-time streaming filter
(/root/reference/vl/sift.c: vl_sift_new:217, vl_sift_process_first_octave:322,
vl_sift_process_next_octave:428) and the app wrapper ``siftAlgorithm``
(/root/reference/ImageProcess.cpp:44-99).

Differences by design (SURVEY.md §7):
- The octave loop runs on host (static shapes per octave); within an octave
  every level / candidate / keypoint is batched on device.
- Dynamic keypoint buffers (vl/sift.c:580-590) become static-capacity arrays
  with validity masks, compacted with top-k style gathers.
- The descriptor-keyed ``map`` (ImageProcess.h:54) becomes index-aligned
  arrays; its dedup/ordering side effects are not reproduced (flagged in
  SURVEY §3.3 — exact matching makes the reverse lookup unnecessary).

App defaults: noctaves=4, nlevels=2, o_min=0 (ImageProcess.cpp:54-55), input
is the u8-truncated ITU-601 luma in 0..255 (ImageProcess.cpp:27-40,47-51).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..config import SiftConfig
from ..core.types import Features
from ..ops import sift_kernels as sk
from ..ops import sift_triton
from ..ops.gaussian import gaussian_blur
from ..ops.resize import vlfeat_downsample, vlfeat_upsample_rows


def kernel_route(cfg: SiftConfig) -> str | None:
    """Backend of the per-keypoint orientation and descriptor stages:
    "triton" (ops/sift_triton.py compiled for the GPU), "interpret" (the
    same kernels through the Pallas interpreter, for CPU tests) or None
    (the dense XLA batch of ops/sift_kernels.py).

    "auto" takes the kernels where the program will run on a GPU: the
    platform of ``jax.default_device`` when one is set, else the default
    backend."""
    if cfg.pallas == "interpret":
        return "interpret"
    if cfg.pallas == "off":
        return None
    if cfg.pallas != "auto":
        raise ValueError(f"SiftConfig.pallas={cfg.pallas!r}")
    dev = jax.config.jax_default_device
    if dev is None:
        platform = jax.default_backend()
    else:
        platform = dev if isinstance(dev, str) else dev.platform
    return "triton" if platform == "gpu" else None


def scale_space_sigmas(cfg: SiftConfig):
    """Per-level incremental smoothing sigmas, identical for every octave
    (vl/sift.c:394-404)."""
    first = None
    sa = cfg.sigma0 * cfg.sigma_k ** cfg.s_min
    # the nominal input smoothing scales with the first-octave sampling rate
    # (vl/sift.c:389-392: sb = sigma_n / pow(2, o_min))
    sb = cfg.sigma_n / (2.0 ** cfg.o_min)
    if sa > sb:
        first = math.sqrt(sa * sa - sb * sb)
    inc = [cfg.dsigma0 * cfg.sigma_k ** s
           for s in range(cfg.s_min + 1, cfg.s_max + 1)]
    return first, inc


def build_octave(base: jnp.ndarray, cfg: SiftConfig, first_sigma: float | None):
    """GSS levels [S+3, H, W] from a base image (level s_min)."""
    lvl = gaussian_blur(base, first_sigma) if first_sigma else base
    levels = [lvl]
    _, inc = scale_space_sigmas(cfg)
    for sd in inc:
        lvl = gaussian_blur(lvl, sd)
        levels.append(lvl)
    return jnp.stack(levels)


def candidate_capacity(h: int, w: int) -> int:
    """Static candidate-list capacity per octave. Strict 26-neighbor extrema
    are sparse: on photographs upscaled to 1440x1080, octave 0 found
    6.2-7.3k (4.0-4.7 per 1000 px) and later octaves fall off ~7x per
    octave. area/128 (7.8 per 1000 px) keeps ~1.66x headroom over the
    densest such image. The refine stage's point gathers scale with this
    capacity, so headroom is not free. Overflow drops trailing candidates
    in scan order and is reported via telemetry (cand_dropped)."""
    return max(1024, min((h * w) // 128, 32768))


def keypoint_capacity(h: int, w: int, cap_max: int) -> int:
    """Static accepted-keypoint capacity per octave. VLFeat densities on
    natural images are ~1 keypoint per 500 px at these settings; 1/128 px
    leaves ~4x headroom while keeping the per-keypoint orientation and
    descriptor batches (the dominant SIFT cost) proportional to octave
    area instead of a global worst case. cap_max == 0 means auto (8192 —
    the area term is the binding constraint for any input below ~4k)."""
    return max(128, min((h * w) // 128, cap_max or 8192))


def total_keypoint_capacity(h: int, w: int, cap_max: int) -> int:
    """Static final feature capacity for an input of h x w pixels.

    Auto (cap_max == 0) scales 1 slot / 160 px. Photographs upscaled to
    1440x1080 measured 1 keypoint / 188 px (7.7-8.3k per image); a
    1/256-px cap dropped ~2k keypoints per image there. 1/160 px gives
    ~17% headroom over the densest such image (9728 slots at 1440x1080)
    and still never binds at the app's native 384x512 (2048 minimum,
    finds ~1.4k). Matching trims the stacked features to the live prefix
    (Stitcher._matching_feats), so headroom costs little. Rounded up to a
    multiple of 128."""
    if cap_max:
        return cap_max
    cap = max(2048, min((h * w) // 160, 16384))
    return -(-cap // 128) * 128


@partial(jax.jit, static_argnames=("cfg", "octave_index"))
def _process_octave(octave: jnp.ndarray, cfg: SiftConfig, octave_index: int):
    """Detect + refine + orient + describe all keypoints of one octave.

    Returns fixed-capacity (desc, xy, sigma, valid) for this octave, with
    xy/sigma in input-image coordinates.
    """
    n_lvl, h, w = octave.shape
    xper = float(2 ** octave_index)
    cap_cand = candidate_capacity(h, w)
    cap_kp = keypoint_capacity(h, w, cfg.max_keypoints_per_octave)

    route = kernel_route(cfg)
    interp = route == "interpret"
    dog = sk.dog_stack(octave)
    mask = sk.extrema_mask(dog, cfg.peak_thresh)
    coords, cvalid = sk.compact_mask(mask, cap_cand)
    n_cand = jnp.sum(mask.astype(jnp.int32))
    # telemetry: candidates dropped by the static capacity
    cand_dropped = jnp.maximum(n_cand - cap_cand, 0)
    ok, x, y, sigma, lvl, resp = sk.refine_keypoints(
        dog, coords, cvalid, w, h, cfg.peak_thresh, cfg.edge_thresh,
        cfg.s_min, cfg.s_max, xper, cfg.sigma0, cfg.n_levels)

    # gradient field for levels s in [s_min+1, s_max-2] (octave indices
    # 1..S), plane-major [S, 2, H, W]: the kernels read one plane each
    grad = sk.polar_gradient(octave[1:1 + cfg.n_levels])

    # per-level batches: level-l keypoints have sn < l + 1.5 (|b_s| < 1.5),
    # so their orientation/descriptor windows are tighter — the dominant
    # per-keypoint cost scales with the realistic patch, not the worst case.
    # Extrema density halves per scale level (measured l1/l0 ~ 0.35 on the
    # reference's datasets), so upper levels get half the slots.
    def cap_level(l: int) -> int:
        return max(128, (2 * cap_kp) // ((cfg.n_levels + 1) * (2 if l else 1)))
    results = []
    kp_dropped = jnp.int32(0)
    desc_dropped = jnp.int32(0)
    for l in range(cfg.n_levels):
        cap_l = cap_level(l)
        sel = ok & (lvl == l)
        kp_idx, kp_valid = sk.compact_indices(sel, cap_l)
        kp_dropped += jnp.maximum(jnp.sum(sel.astype(jnp.int32)) - cap_l, 0)
        xl, yl, sl, rl = x[kp_idx], y[kp_idx], sigma[kp_idx], resp[kp_idx]

        r_ori = sk.ori_patch_radius(cfg.sigma0, cfg.n_levels, cfg.s_max, l)
        # interleaved [1, H, W, 2] view for the XLA kernels (their patch
        # gather wants minor-dim planes)
        grad_l = jnp.moveaxis(grad[l:l + 1], 1, -1)
        if route:
            hist, o_ok = sift_triton.orientation_hist(
                grad[l, 0], grad[l, 1], xl / xper, yl / xper, sl / xper,
                kp_valid, w, h, r_ori, cfg.n_ori_bins, interpret=interp)
            angles, a_valid = sk.orientation_peaks(
                hist, o_ok, cfg.n_ori_bins, cfg.max_angles)
        else:
            grad_pad = jnp.pad(grad_l, ((0, 0), (r_ori, r_ori),
                                        (r_ori, r_ori), (0, 0)))
            zeros_lvl = jnp.zeros(cap_l, jnp.int32)
            angles, a_valid = sk.orientation_histograms(
                grad_pad, zeros_lvl, xl / xper, yl / xper, sl / xper,
                kp_valid, w, h, r_ori, cfg.n_ori_bins, cfg.max_angles)

        # expand keypoints x angles -> flat list, compact
        cap_d = cap_l + cap_l // 2
        ka_valid = a_valid.reshape(-1)
        rep = lambda a: jnp.repeat(a, cfg.max_angles, axis=0)
        ka_x, ka_y, ka_sigma, ka_resp = map(rep, (xl, yl, sl, rl))
        ka_angle = angles.reshape(-1)
        da_idx, d_valid = sk.compact_indices(ka_valid, cap_d)
        desc_dropped += jnp.maximum(
            jnp.sum(ka_valid.astype(jnp.int32)) - cap_d, 0)
        d_x, d_y, d_sigma, d_angle, d_resp = (
            ka_x[da_idx], ka_y[da_idx], ka_sigma[da_idx],
            ka_angle[da_idx], ka_resp[da_idx])

        r_desc = sk.desc_patch_radius(cfg.sigma0, cfg.n_levels, cfg.s_max,
                                      cfg.magnif, cfg.n_spatial_bins, l)
        if route:
            desc, d_ok = sift_triton.descriptors(
                grad[l, 0], grad[l, 1], d_x / xper, d_y / xper,
                d_sigma / xper, d_angle, d_valid, w, h, r_desc, cfg.magnif,
                cfg.n_spatial_bins / 2.0, cfg.n_spatial_bins,
                cfg.n_desc_ori_bins, interpret=interp)
        else:
            grad_pad2 = jnp.pad(grad_l, ((0, 0), (r_desc, r_desc),
                                         (r_desc, r_desc), (0, 0)))
            desc, d_ok = sk.descriptors(
                grad_pad2, jnp.zeros(cap_d, jnp.int32), d_x / xper,
                d_y / xper, d_sigma / xper, d_angle, d_valid, w, h, r_desc,
                cfg.magnif, cfg.n_spatial_bins / 2.0, cfg.n_spatial_bins,
                cfg.n_desc_ori_bins)
        results.append((desc, jnp.stack([d_x, d_y], axis=-1), d_sigma,
                        d_ok, d_resp))

    desc = jnp.concatenate([r[0] for r in results])
    xy = jnp.concatenate([r[1] for r in results])
    sigmas = jnp.concatenate([r[2] for r in results])
    oks = jnp.concatenate([r[3] for r in results])
    resps = jnp.concatenate([r[4] for r in results])
    stats = jnp.stack([cand_dropped, kp_dropped, desc_dropped])
    return desc, xy, sigmas, oks, resps, stats


@partial(jax.jit, static_argnames=("cfg",))
def sift_extract_stats(gray: jnp.ndarray,
                       cfg: SiftConfig = SiftConfig()):
    """sift_extract plus capacity-overflow telemetry.

    Returns (Features, stats) where stats is int32 [4]:
    [candidates dropped, refined keypoints dropped, descriptors dropped,
    final-capacity keypoints dropped] — all 0 on a healthy run. Static
    capacities replace VLFeat's realloc'd buffers (vl/sift.c:580-590);
    truncation is legal but must be visible (VERDICT r1 #8).
    """
    first_sigma, _ = scale_space_sigmas(cfg)

    base = gray.astype(jnp.float32)
    if cfg.o_min < 0:
        # upsampled first octave (vl_sift_process_first_octave,
        # vl/sift.c:322-409): each doubling is a copy_and_upsample_rows
        # PAIR — the row upsample transposes, so two calls double both dims
        for _ in range(-cfg.o_min):
            base = vlfeat_upsample_rows(vlfeat_upsample_rows(base))
    elif cfg.o_min > 0:
        base = vlfeat_downsample(base, cfg.o_min)

    per_octave = []
    for o in range(cfg.n_octaves):
        if min(base.shape[-2:]) < 8:
            break
        octave = build_octave(base, cfg, first_sigma if o == 0 else None)
        # octave index counts from o_min: xper = 2^(o_min + o) maps octave
        # pixels back to input coordinates (0.5/px for the upsampled octave)
        per_octave.append(_process_octave(octave, cfg, cfg.o_min + o))
        if o + 1 < cfg.n_octaves:
            # next octave base: decimate level s_min + S (octave index S)
            base = vlfeat_downsample(octave[cfg.n_levels], 1)

    desc = jnp.concatenate([p[0] for p in per_octave])
    xy = jnp.concatenate([p[1] for p in per_octave])
    sigma = jnp.concatenate([p[2] for p in per_octave])
    valid = jnp.concatenate([p[3] for p in per_octave])
    resp = jnp.concatenate([p[4] for p in per_octave])
    stats3 = sum(p[5] for p in per_octave)

    cap = total_keypoint_capacity(gray.shape[-2], gray.shape[-1],
                                  cfg.max_keypoints)
    final_dropped = jnp.maximum(jnp.sum(valid.astype(jnp.int32)) - cap, 0)
    # response-ranked selection (VERDICT r3 ask #2b): when the cap binds,
    # keep the CAP strongest keypoints by |DoG response| instead of the
    # first cap in scan order (which silently biases against later
    # octaves/rows; the reference keeps all, vl/sift.c:580-590). Output
    # stays prefix-compacted in scan order and is bit-identical to plain
    # compaction whenever nothing drops (ops.compaction.select_strongest).
    from ..ops.compaction import select_strongest

    idx, out_valid = select_strongest(valid, resp, cap)
    feats = Features(desc=desc[idx], xy=xy[idx], scale=sigma[idx],
                     valid=out_valid)
    return feats, jnp.concatenate([stats3, final_dropped[None]])


def sift_extract(gray: jnp.ndarray, cfg: SiftConfig = SiftConfig()) -> Features:
    """Extract SIFT features from a grayscale image [H, W] float32 (0..255).

    Equivalent of siftAlgorithm (ImageProcess.cpp:44-99): all octaves, up to
    4 orientations per keypoint, one 128-d descriptor per orientation.
    One jitted program end-to-end — a single dispatch with full XLA fusion
    (fragmenting it into per-stage programs measured ~1.6x slower).
    (Thin wrapper over sift_extract_stats; XLA dead-code-eliminates the
    telemetry when the caller drops it.)
    """
    return sift_extract_stats(gray, cfg)[0]
