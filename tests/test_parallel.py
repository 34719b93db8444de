"""Multi-device tests on the virtual 8-device CPU mesh (conftest)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from computervisionimagestich2_tpu.config import (
    DEFAULT_CONFIG, MatchConfig, RansacConfig, SiftConfig)
from computervisionimagestich2_tpu.parallel import (
    batched_pairwise_register, make_mesh, sharded_gaussian_blur, shard_batch)
from computervisionimagestich2_tpu.ops.gaussian import gaussian_blur


TINY = dataclasses.replace(
    DEFAULT_CONFIG,
    sift=SiftConfig(n_octaves=1, max_keypoints_per_octave=128,
                    max_keypoints=256),
    match=MatchConfig(max_matches=128),
    ransac=RansacConfig(n_hypotheses=32),
)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_blur_matches_single_device(rng):
    mesh = make_mesh(8, sp=8)
    img = rng.normal(size=(128, 64)).astype(np.float32)
    got = np.asarray(sharded_gaussian_blur(jnp.asarray(img), 2.0, mesh, "sp"))
    expect = np.asarray(gaussian_blur(jnp.asarray(img), 2.0))
    np.testing.assert_allclose(got, expect, atol=1e-4)


@pytest.mark.slow
def test_sharded_blend_matches_single_device(rng):
    """The row-sharded halo-exchange blend must reproduce the single-device
    pyramid blend (SURVEY.md §5 'shard the canvas compositing') — overlap
    seam, Laplacian levels, clamps and all."""
    from computervisionimagestich2_tpu.models.blender import blend_two_images
    from computervisionimagestich2_tpu.parallel.blend import (
        plan_shard_levels, sharded_blend_two_images)

    mesh = make_mesh(8, sp=8)
    h, w = 256, 192
    # panorama-shaped canvases: a fills the left 2/3, b the right 2/3, with
    # zero borders (the mask derives from mid-row zero/nonzero structure)
    a = np.zeros((h, w, 3), np.float32)
    b = np.zeros((h, w, 3), np.float32)
    a[8:-8, : 2 * w // 3] = rng.uniform(10, 250, (h - 16, 2 * w // 3, 3))
    b[4:-12, w // 3:] = rng.uniform(10, 250, (h - 16, w - w // 3, 3))

    assert plan_shard_levels(h, 8, 8, 2.0) >= 2  # >=2 levels truly sharded
    got = np.asarray(sharded_blend_two_images(
        jnp.asarray(a), jnp.asarray(b), mesh, "sp"))
    expect = np.asarray(blend_two_images(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, atol=2e-3)


def test_sharded_composite_and_blend_matches_single_device(rng):
    """The full sharded stitch edge — halo-free warp/offset stripes +
    halo-exchange blend — must reproduce compose.composite +
    blend_two_images (the warp/shift stripes must be bit-identical; the
    blend to f32 round-off)."""
    from computervisionimagestich2_tpu.models.blender import blend_two_images
    from computervisionimagestich2_tpu.models import compose
    from computervisionimagestich2_tpu.parallel.blend import (
        sharded_composite, sharded_composite_and_blend)

    mesh = make_mesh(8, sp=8)
    h, w = 96, 128
    src = rng.uniform(10, 250, (h, w, 3)).astype(np.float32)
    prev = rng.uniform(10, 250, (h, w - 20, 3)).astype(np.float32)
    # near-translation bilinear warp (a realistic stitch edge), canvas
    # grows right/down; offsets negative like a leftward stitch
    coeffs = jnp.asarray([1.01, 0.02, 1e-5, -0.01, 0.99, 2e-5, 1e-6,
                          3.0], jnp.float32)
    min_x, min_y = -12.7, -8.3
    canvas_hw = (128, 160)

    a_s, b_s = sharded_composite(jnp.asarray(src), jnp.asarray(prev),
                                 coeffs, min_x, min_y, canvas_hw, mesh)
    a_e, b_e = compose.composite(jnp.asarray(src), jnp.asarray(prev),
                                 coeffs, min_x, min_y, canvas_hw)
    np.testing.assert_array_equal(np.asarray(a_s), np.asarray(a_e))
    np.testing.assert_array_equal(np.asarray(b_s), np.asarray(b_e))

    got = np.asarray(sharded_composite_and_blend(
        jnp.asarray(src), jnp.asarray(prev), coeffs, min_x, min_y,
        canvas_hw, mesh))
    expect = np.asarray(blend_two_images(a_e, b_e))
    np.testing.assert_allclose(got, expect, atol=2e-3)


@pytest.mark.slow  # 15s; f32 sharded-blend equality stays quick
def test_sharded_blend_bf16_matches_single_device_bf16(rng):
    """dtype='bf16' must behave the same sharded as on one device (the
    config knob can't silently mean f32 on the multi-chip path)."""
    from computervisionimagestich2_tpu.models.blender import blend_two_images
    from computervisionimagestich2_tpu.parallel.blend import (
        sharded_blend_two_images)

    mesh = make_mesh(8, sp=8)
    h, w = 128, 96
    a = np.zeros((h, w, 3), np.float32)
    b = np.zeros((h, w, 3), np.float32)
    a[8:-8, : 2 * w // 3] = rng.uniform(10, 250, (h - 16, 2 * w // 3, 3))
    b[8:-8, w // 3:] = rng.uniform(10, 250, (h - 16, w - w // 3, 3))
    got = np.asarray(sharded_blend_two_images(
        jnp.asarray(a), jnp.asarray(b), mesh, "sp", dtype="bf16"))
    single = np.asarray(blend_two_images(jnp.asarray(a), jnp.asarray(b),
                                         dtype="bf16"))
    # bf16 rounding differs slightly between the halo and padded formulations
    assert np.abs(got - single).max() < 4.0
    f32 = np.asarray(blend_two_images(jnp.asarray(a), jnp.asarray(b)))
    assert np.abs(got - f32).max() < 8.0  # still a faithful blend


def test_sharded_programs_are_cached_across_calls(rng):
    """Per-edge calls with the same geometry must reuse the compiled SPMD
    programs (the jit cache is keyed on the wrapper object, so a fresh
    jit(shard_map) per call would retrace every edge)."""
    from computervisionimagestich2_tpu.parallel import blend as pblend

    mesh = make_mesh(8, sp=8)
    h, w = 64, 96
    src = jnp.asarray(rng.uniform(10, 250, (h, w, 3)), jnp.float32)
    prev = jnp.asarray(rng.uniform(10, 250, (h, w - 16, 3)), jnp.float32)
    coeffs = jnp.asarray([1.0, 0.01, 1e-5, -0.005, 1.0, 2e-5, 0.0, 2.0],
                         jnp.float32)

    pblend._composite_program.cache_clear()
    pblend._blend_program.cache_clear()
    for min_x in (-3.5, -7.25):  # distinct per-edge offsets, same geometry
        pblend.sharded_composite_and_blend(
            src, prev, coeffs, min_x, -2.0, (h, w), mesh)
    assert pblend._composite_program.cache_info().misses == 1
    assert pblend._composite_program.cache_info().hits == 1
    assert pblend._blend_program.cache_info().misses == 1
    assert pblend._blend_program.cache_info().hits == 1


def test_sharded_blend_rejects_unshardable_height():
    from computervisionimagestich2_tpu.parallel.blend import (
        sharded_blend_two_images)

    mesh = make_mesh(8, sp=8)
    a = jnp.zeros((100, 64, 3), jnp.float32)  # 100 % 16 != 0
    with pytest.raises(ValueError):
        sharded_blend_two_images(a, a, mesh, "sp")


@pytest.mark.slow
def test_batched_register_sharded(rng):
    """Sharded execution must agree with single-device execution — the
    invariant that matters for dp sharding (absolute registration quality is
    covered by test_match_ransac / test_integration)."""
    mesh = make_mesh(4, sp=1)
    b = mesh.shape["data"]
    # a registration-FRIENDLY scene (blobs -> strong distinctive keypoints):
    # blurred noise alone yields ~6 borderline inliers and an unstable fit,
    # where shard-vs-unshard comparison measures RANSAC noise, not sharding
    base = rng.uniform(60, 200, (48, 64)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    ys_g, xs_g = np.mgrid[0:48, 0:64]
    for _ in range(18):
        cy, cx = rng.uniform(6, 42), rng.uniform(6, 58)
        r = rng.uniform(2, 5)
        m = ((ys_g - cy) ** 2 + (xs_g - cx) ** 2) < r * r
        base[m] = rng.uniform(0, 255)
    gray_a = jnp.asarray(np.stack([base] * b))
    gray_b = jnp.asarray(np.stack([np.roll(base, 5, axis=1)] * b))

    ref_coeffs, ref_inliers = batched_pairwise_register(gray_a, gray_b, TINY)
    a, bb = shard_batch(mesh, gray_a, gray_b)
    coeffs, inliers = batched_pairwise_register(a, bb, TINY)

    # GSPMD may partition reductions differently, flipping distance ties and
    # hence the exact match set / refit — compare the fitted warps where it
    # matters: reprojection agreement over the image (cf. test_projective),
    # plus agreement of BOTH with the known ground truth (x -> x - 5).
    from computervisionimagestich2_tpu.ops.warp import warp_points

    px, py = np.meshgrid(np.linspace(4, 60, 8), np.linspace(4, 44, 8))
    px = jnp.asarray(px.ravel().astype(np.float32))
    py = jnp.asarray(py.ravel().astype(np.float32))
    for k in range(b):
        xr, yr = warp_points(ref_coeffs[k], px, py)
        xs, ys = warp_points(coeffs[k], px, py)
        dev = np.hypot(np.asarray(xr - xs), np.asarray(yr - ys)).max()
        assert dev < 2.0, dev
        gt = np.hypot(np.asarray(xr) - (np.asarray(px) - 5),
                      np.asarray(yr) - np.asarray(py)).max()
        assert gt < 2.0, gt
    assert np.abs(np.asarray(inliers) - np.asarray(ref_inliers)).max() <= \
        0.1 * np.asarray(ref_inliers).max() + 2


@pytest.mark.slow
def test_dryrun_multichip_entrypoint():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    mod.dryrun_multichip(8)


@pytest.mark.slow
def test_batched_stitch_chain_matches_per_panorama(rng):
    """BASELINE config 3 as written: a batch of panoramas stitched in one
    vmapped program must equal the same fixed-canvas stitch run per
    panorama (and the content extent must match the Stitcher's canvas)."""
    from computervisionimagestich2_tpu.parallel.batched import (
        _stitch_one_fixed, batched_stitch_chain)

    from tests.test_integration import make_scene

    h, w, k = 128, 112, 3
    base = make_scene(np.random.default_rng(3), h, 3 * w).astype(np.float32)
    # two panoramas of k overlapping crops each (~60% overlap)
    step = int(w * 0.4)
    def crops(off):
        return np.stack([base[:, off + i * step: off + i * step + w]
                         for i in range(k)])
    batch = jnp.asarray(np.stack([crops(0), crops(24)]).astype(np.uint8))

    canvas_hw = (192, 256)
    out, plans = batched_stitch_chain(batch, TINY, canvas_hw)
    assert out.shape == (2, 192, 256, 3)

    from computervisionimagestich2_tpu.models.stitcher import bfs_edge_seq
    adj = [[abs(i - j) == 1 for j in range(k)] for i in range(k)]
    edge_seq = tuple(bfs_edge_seq(adj, k // 2))
    for i in range(2):
        single, plan_1 = _stitch_one_fixed(batch[i], TINY, canvas_hw,
                                           edge_seq)
        np.testing.assert_allclose(np.asarray(out[i]), np.asarray(single),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(plans[i]), np.asarray(plan_1),
                                   rtol=1e-5, atol=1e-4)
    # registration sanity: the synthetic shift must be recovered — final
    # content width ~ w + 2*step within a few px
    final_w = np.asarray(plans[:, -1, 20])
    assert np.all(np.abs(final_w - (w + 2 * step)) < 10), final_w


@pytest.mark.slow
def test_batched_stitch_chain_sharded_over_mesh(rng):
    """The panorama batch axis shards over the data mesh axis (config 3's
    multi-chip form): per-device results equal the unsharded run."""
    from computervisionimagestich2_tpu.parallel.batched import (
        batched_stitch_chain)

    from tests.test_integration import make_scene

    h, w, k = 128, 112, 2
    base = make_scene(np.random.default_rng(5), h, 2 * w + 8).astype(
        np.float32)
    step = int(w * 0.4)
    panos = []
    for off in range(8):
        panos.append(np.stack([base[:, off + i * step: off + i * step + w]
                               for i in range(k)]))
    batch = jnp.asarray(np.stack(panos).astype(np.uint8))

    mesh = make_mesh(8, sp=1)  # data axis = 8
    (sharded,) = shard_batch(mesh, batch)
    out_ref, plans_ref = batched_stitch_chain(batch, TINY, (192, 256))
    out_sh, plans_sh = batched_stitch_chain(sharded, TINY, (192, 256))
    # GSPMD partitioning reassociates f32 reductions, which can flip a
    # near-tie RANSAC hypothesis and move the warp by sub-pixel — identical
    # semantics, not bit-identical pixels. Demand near-equality: <0.1% of
    # pixels may differ, none by more than a fine-structure step.
    diff = np.abs(np.asarray(out_sh) - np.asarray(out_ref))
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()
    assert diff.max() <= 16.0, diff.max()
    np.testing.assert_allclose(np.asarray(plans_sh)[:, :, 18:22],
                               np.asarray(plans_ref)[:, :, 18:22], atol=1.0)


def test_batched_stitch_chain_sharded_takes_the_kernel_route():
    """A data-sharded batch runs the SIFT kernel route like the Stitcher
    (the kernels vmap over the batch; here through the Pallas
    interpreter): each panorama matches the XLA route stitched unsharded,
    and the output stays split across the data axis."""
    from computervisionimagestich2_tpu.parallel.batched import (
        batched_stitch_chain)

    from tests.test_integration import make_scene

    h, w, k = 96, 96, 2
    base = make_scene(np.random.default_rng(7), h, 2 * w).astype(np.float32)
    step = int(w * 0.45)
    batch = jnp.asarray(np.stack([
        np.stack([base[:, off + i * step: off + i * step + w]
                  for i in range(k)]) for off in (0, 8, 16, 24)
    ]).astype(np.uint8))
    kern = dataclasses.replace(
        TINY, sift=dataclasses.replace(TINY.sift, pallas="interpret"))
    xla = dataclasses.replace(
        TINY, sift=dataclasses.replace(TINY.sift, pallas="off"))

    (sharded,) = shard_batch(make_mesh(4, sp=1), batch)
    out_k, plans_k = batched_stitch_chain(sharded, kern, (128, 192))
    out_x, plans_x = batched_stitch_chain(batch, xla, (128, 192))
    assert len({s.device for s in out_k.addressable_shards}) == 4
    diff = np.abs(np.asarray(out_k) - np.asarray(out_x))
    assert (diff > 1).mean() < 1e-3, (diff > 1).mean()
    np.testing.assert_allclose(np.asarray(plans_k)[:, :, 18:22],
                               np.asarray(plans_x)[:, :, 18:22], atol=1.0)


def test_mesh_edge_gate_follows_seam_auto_policy():
    """An edge whose blend canvas engages the area-gated seam-auto policy
    (seam-band blend + rgb gain on one device) must not take the sharded
    full-canvas blend, or the meshed panorama differs from the
    single-device one everywhere the gain moved the exposure."""
    from computervisionimagestich2_tpu.models.stitcher import Stitcher

    mesh = make_mesh(8, sp=8)
    blend = dataclasses.replace(TINY.blend, seam_auto_area=100_000)
    st = Stitcher(dataclasses.replace(TINY, blend=blend), mesh=mesh)
    assert st._mesh_edge_ok((256, 384))            # 98 kpx: full blend
    assert not st._mesh_edge_ok((256, 512))        # 131 kpx: seam-auto
    off = dataclasses.replace(blend, seam_auto_area=0)
    st = Stitcher(dataclasses.replace(TINY, blend=off), mesh=mesh)
    assert st._mesh_edge_ok((256, 512))


@pytest.mark.slow
def test_stitcher_mesh_mode_matches_single_device():
    """Stitcher(mesh=...) — multi-device as a MODE: the full pipeline with
    row-sharded composite+blend edges must reproduce the single-device
    panorama (same plan; blend differs only by f32 round-off -> at most
    +-1 u8 after truncation)."""
    from tests.test_integration import make_scene
    from computervisionimagestich2_tpu.models.stitcher import Stitcher

    h, w, k = 128, 112, 3
    base = make_scene(np.random.default_rng(3), h, 3 * w)
    step = int(w * 0.4)
    images = [base[:, i * step: i * step + w] for i in range(k)]
    cfg = dataclasses.replace(TINY, ordering="chain", exact_canvas=False)

    single = Stitcher(cfg).stitch(images)
    mesh = make_mesh(8, sp=8)
    st = Stitcher(cfg, mesh=mesh)
    meshed = st.stitch(images)
    assert meshed.shape == single.shape
    diff = np.abs(meshed.astype(np.int32) - single.astype(np.int32))
    assert (diff > 1).mean() < 1e-3, (diff > 1).mean()
    assert diff.max() <= 16, diff.max()


@pytest.mark.slow
def test_stitcher_mesh_mode_with_pallas_interpret_kernels():
    """Mesh mode + the SIFT kernel route (ops/sift_triton.py in interpret
    mode): the meshed stitch with the kernels must match the
    single-device stitch on the XLA route, so the mesh path exercises the
    same kernel wiring the GPU default uses. (Compiling the kernels for
    the card is chip_smoke.py's job.)
    """
    from tests.test_integration import make_scene
    from computervisionimagestich2_tpu.models.stitcher import Stitcher

    h, w = 128, 112
    base = make_scene(np.random.default_rng(5), h, 2 * w)
    images = [base[:, :w], base[:, int(0.4 * w): int(0.4 * w) + w]]
    cfg = dataclasses.replace(
        TINY, ordering="chain", exact_canvas=False,
        sift=dataclasses.replace(TINY.sift, pallas="interpret"))

    single = Stitcher(dataclasses.replace(cfg, sift=dataclasses.replace(
        cfg.sift, pallas="off"))).stitch(images)
    meshed = Stitcher(cfg, mesh=make_mesh(8, sp=8)).stitch(images)
    assert meshed.shape == single.shape
    diff = np.abs(meshed.astype(np.int32) - single.astype(np.int32))
    assert (diff > 1).mean() < 1e-3, (diff > 1).mean()
