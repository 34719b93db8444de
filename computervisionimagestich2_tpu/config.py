"""Configuration for the panorama stitcher.

All defaults mirror the reference application's compile-time constants
(/root/reference/ImageProcess.h:13-32, Projection.h:12-13, equalization.cpp:2,
transfer.cpp:2) and VLFeat's SIFT defaults (/root/reference/vl/sift.c:238-275).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """SIFT scale-space / detector / descriptor parameters.

    Mirrors VlSiftFilt defaults (vl/sift.c:233-275) and the app's choices
    (ImageProcess.cpp:54-55: noctaves=4, nlevels=2, o_min=0).
    """

    n_octaves: int = 4            # NOTAVES_NUM, ImageProcess.h:15
    n_levels: int = 2             # LEVEL_NUM (S), ImageProcess.h:16
    o_min: int = 0                # first octave index (ImageProcess.cpp:55)
    sigma_n: float = 0.5          # nominal input smoothing, vl/sift.c:251
    sigma0_factor: float = 1.6    # sigma0 = 1.6 * 2^(1/S), vl/sift.c:253
    peak_thresh: float = 0.0      # vl/sift.c:267
    edge_thresh: float = 10.0     # vl/sift.c:268
    norm_thresh: float = 0.0      # vl/sift.c:269
    magnif: float = 3.0           # descriptor SBP = magnif * sigma, vl/sift.c:270
    n_ori_bins: int = 36          # orientation histogram bins, vl/sift.c:934
    n_spatial_bins: int = 4       # NBP, vl/sift.c:19
    n_desc_ori_bins: int = 8      # NBO, vl/sift.c:18
    max_angles: int = 4           # <=4 orientations per keypoint, sift.c:1018
    # Static capacity knobs (dense masks instead of realloc, replacing
    # the dynamic keys buffer at vl/sift.c:580-590). 0 = auto: scale with
    # the input pixel count at trace time, so high-resolution inputs keep
    # every keypoint the reference's dynamic buffers would (a fixed 2048
    # cap measurably truncated 1080p photos — ~4.5k found).
    max_keypoints_per_octave: int = 0
    max_keypoints: int = 0        # total after orientation expansion
    # Per-keypoint orientation/descriptor backend: "auto" runs the Pallas
    # Triton kernels (ops/sift_triton.py) where the program runs on a GPU
    # and the dense XLA batch elsewhere; "off" forces the XLA batch (mesh-
    # sharded batch programs, and the reference the kernels are measured
    # against), "interpret" the kernels through the Pallas interpreter
    # (CPU tests).
    pallas: str = "auto"

    @property
    def sigma_k(self) -> float:
        return 2.0 ** (1.0 / self.n_levels)

    @property
    def sigma0(self) -> float:
        return self.sigma0_factor * self.sigma_k

    @property
    def dsigma0(self) -> float:
        import math
        return self.sigma0 * math.sqrt(1.0 - 1.0 / (self.sigma_k * self.sigma_k))

    @property
    def s_min(self) -> int:
        return -1                 # vl/sift.c:238

    @property
    def s_max(self) -> int:
        return self.n_levels + 1  # vl/sift.c:239


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching. The reference uses a 1-tree kd-forest with L1
    distance and Lowe ratio 0.5 (ImageProcess.cpp:280, ImageProcess.h:22).
    Here: exact all-pairs distance + top-2 on the device."""

    ratio_threshold: float = 0.5  # RATIO_THRESHOLD, ImageProcess.h:22
    distance: str = "l1"          # VlDistanceL1, ImageProcess.cpp:280
    pair_threshold: int = 20      # THRESHOLD (min matches to stitch), ImageProcess.h:18
    # Static capacity for match pairs. 4096: 1440x1080 photo sets
    # produce up to ~2.3k ratio-test matches per direction (a 2048 cap
    # dropped 132-242 pairs per edge, reported via match_overflow
    # telemetry); the reference keeps every match (vector<ImgPair>). The
    # [K, N] RANSAC inlier evaluation this sizes is small at either value.
    max_matches: int = 4096
    # L1 2-NN strategy. "exact" evaluates every descriptor pair's L1 (one
    # fused broadcast-abs-reduce). "l2pre" computes L2 candidates with
    # one matmul, keeps the l2pre_m nearest per query, and rescores only
    # those by exact L1. The Lowe 0.5 ratio only accepts unambiguous
    # matches, which is why candidate-set rescoring preserves them almost
    # perfectly: against the exact-L1 oracle over 40 directed pairs of
    # the reference's photo sets (~300k queries), decision diffs totalled
    # 2 at m=32, 5 at m=16 and 8 at m=8. The reference's kd-forest ANN
    # (vl/kdtree.c) is far noisier than any of these.
    method: str = "exact"
    # candidates rescored per query for l2pre: rescore cost is linear in
    # m; m=12 and m=16 made identical decisions over the same 40 pairs
    l2pre_m: int = 12
    # the ordering stage needs only pair counts vs THRESHOLD=20
    # (ImageProcess.cpp:117-137); m=8 changed counts by <= 1 per direction
    l2pre_m_counts: int = 8


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC warp estimation (ImageProcess.cpp:395-529)."""

    n_sample: int = 4             # NUM_OF_PAIR, ImageProcess.h:29
    confidence: float = 0.99      # CONFIDENCE (hardcoded again at cpp:398)
    inlier_ratio: float = 0.5     # INLINER_RATIO
    threshold: float = 4.0        # RANSAC_THRESHOLD, ImageProcess.h:32
    seed: int = 666666            # srand(666666), ImageProcess.cpp:397
    # hypotheses are vmapped; >= the reference's 72 sequential iters.
    n_hypotheses: int = 128
    # Local-optimization rounds after the refit (LO-RANSAC): re-score the
    # refit model and refit again when its consensus grew. Nearly free
    # (one [N] reprojection + one masked solve per round) and moves edges
    # out of smaller-consensus basins — the residual golden drift
    # isolated in round 3 (VERDICT r3 ask #6). 0 = the reference's plain
    # refit-and-stop behavior (ImageProcess.cpp:500-529).
    lo_iters: int = 1

    @property
    def reference_iterations(self) -> int:
        import math
        return math.ceil(
            math.log(1 - self.confidence)
            / math.log(1 - self.inlier_ratio ** self.n_sample)
        )


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    """Cylindrical projection (Projection.h:12, Projection.cpp:20-73)."""

    angle_deg: float = 15.0       # ANGLE, Projection.h:12


@dataclasses.dataclass(frozen=True)
class BlendConfig:
    """Multi-band Laplacian blend (ImageProcess.cpp:648-773)."""

    blur_sigma: float = 2.0       # get_blur(2,...), ImageProcess.cpp:709
    # "fir": separable FIR Gaussian (fast default, within blend tolerance);
    # "vanvliet": CImg's exact recursive filter + Triggs boundaries
    # (get_blur(2,true,true)) — bit-faithful parity mode, slower.
    blur_impl: str = "fir"
    # root variant: levels = floor(log2(max(w,h))) (ImageProcess.cpp:675-676)
    # ex6 variant:  levels = floor(log2(min(w,h))) (src/ex6/ImageProcess.cpp:662-665)
    level_mode: str = "max"       # "max" (root) | "min" (ex6)
    max_levels: int = 12
    # Extension beyond the reference (BASELINE.json config 4): match the
    # incoming image's overlap-mean luma to the canvas before blending.
    gain_compensation: bool = False
    # "luma" = one scalar gain; "rgb" = one gain per channel (also removes
    # tint steps — recommended with seam_band, models/gain.py).
    gain_mode: str = "luma"
    # "f32" | "bf16" | "auto" (default): bfloat16 halves the pyramid
    # chain's bytes. "auto" resolves per blend canvas at trace time: bf16
    # when the canvas area exceeds ``bf16_auto_area`` pixels, f32 below
    # (so the dataset1 golden-parity canvas, 0.55 Mpx, stays f32). Cost: a
    # few u8 levels of rounding in smooth gradients at bf16. FIR blur
    # only. The gate's value changes output, so it stays until it is
    # re-decided from a GPU trace.
    dtype: str = "auto"
    bf16_auto_area: int = 1_500_000
    # 0 (parity default) = blend the full canvas like the reference;
    # > 0 = pyramid-blend only a 4*seam_band-wide window at the seam and
    # copy a/b elsewhere (models/blender.py::blend_seam_band) — per-edge
    # blend cost becomes O(H x band) instead of O(H x W_canvas), the
    # OpenCV-MultiBandBlender-style extension for long chains.
    seam_band: int = 0
    # Area-gated automatic seam-band (like the bf16 "auto" policy): when
    # seam_band == 0 and the blend canvas exceeds seam_auto_area pixels,
    # blend a 4*seam_auto_band window at the seam instead of the full
    # canvas. Rationale: the full-canvas pyramid re-blends O(H x W_total)
    # per edge for a seam that moved one image width (reference behavior,
    # ImageProcess.cpp:648-773); the outputs differ only in how far the
    # low-frequency luma ramp spreads from the seam. Every golden-parity
    # canvas (dataset1, 0.56 Mpx) sits far below the gate and still takes
    # the reference's exact full blend. The value changes output, so it
    # stays until it is re-decided from a GPU trace.
    # seam_auto_area=0 disables the policy (strict reference behavior at
    # every size); pair big exposure-mismatched sets with
    # gain_compensation (the narrow band cannot hide exposure steps).
    seam_auto_area: int = 2_000_000
    seam_auto_band: int = 256


@dataclasses.dataclass(frozen=True)
class EnhanceConfig:
    """Histogram equalization + YCbCr luma mix (ImageProcess.cpp:237-270)."""

    # Run the equalization/luma-mix tail at all (CLI --no-enhance clears it).
    enabled: bool = True
    # Reference quirk: Y uses 0.857 for G instead of 0.587 at all three
    # conversion sites (ImageProcess.cpp:242,252; equalization.cpp:79).
    # compat=True reproduces it; compat=False uses the correct 0.587.
    compat_luma: bool = True
    # root mixes 19/20 : 1/20 (ImageProcess.cpp:261); ex6 uses 5/6 : 1/6
    # (src/ex6/ImageProcess.cpp:270).
    mix_weight: float = 19.0 / 20.0


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    sift: SiftConfig = dataclasses.field(default_factory=SiftConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    projection: ProjectionConfig = dataclasses.field(default_factory=ProjectionConfig)
    blend: BlendConfig = dataclasses.field(default_factory=BlendConfig)
    enhance: EnhanceConfig = dataclasses.field(default_factory=EnhanceConfig)
    # "bilinear" = the reference's 8-coefficient warp (ImageProcess.h:58-73);
    # "projective" = true DLT homography (the report describes it,
    # 16340028.md §DLT; documented 'correct mode', default off for parity).
    warp_model: str = "bilinear"
    # "graph" = root variant's match-graph discovery over unordered images
    # (ImageProcess.cpp:101-147); "chain" = ex6's pre-ordered left-to-right
    # adjacency (src/ex6/ImageProcess.cpp:150-159).
    ordering: str = "graph"
    # Dense-graph BFS behavior: "skip" (default) stitches each image
    # exactly once (spanning tree — identical to the reference whenever
    # its run would not re-stitch, i.e. every golden/parity set);
    # "faithful" reproduces the reference's unguarded BFS, which
    # re-stitches images on dense graphs with a canvas-frame model
    # applied to image pixels and dies on the resulting canvas
    # (models/stitcher.py::bfs_edge_seq).
    graph_revisit: str = "skip"
    # Per-edge Reinhard color transfer of the incoming image toward its
    # stitch partner — the reference compiles transfer.cpp in and has this
    # exact call commented out in the stitch loop (ImageProcess.cpp:180:
    # ``transfer tran(imgs[dst].projectedSrc, imgs[src].projectedSrc,
    # imgs[dst].projectedSrc)``). Off by default, like the reference.
    color_transfer: bool = False
    # Canvas sizes are bucketed (rounded up) to bound XLA recompilation;
    # the answer to the reference's unbounded canvas growth
    # (ImageProcess.cpp:215-219).
    canvas_bucket: int = 128
    # planned=True registers every stitch edge in ONE device program (a
    # lax.scan over edges — matching, RANSAC, canvas bounds, feature
    # updates) and reads back a single [E, 23] plan, so the stitch loop
    # dispatches composites/blends with no per-edge host-device round trip.
    # False = the incremental per-edge loop (streaming-style).
    planned: bool = True
    # exact_canvas=True (default) composites/blends at the reference's exact
    # canvas size — one compile per distinct canvas shape (parity mode).
    # False pads each canvas up to canvas_bucket multiples for the blend and
    # crops back, so an N-image panorama compiles only a handful of blend
    # shapes; output differs from exact mode only by pyramid blur bleed near
    # the padded borders (within blend tolerance).
    exact_canvas: bool = True
    # Compute dtype for image-space kernels.
    dtype: str = "float32"


DEFAULT_CONFIG = StitchConfig()
