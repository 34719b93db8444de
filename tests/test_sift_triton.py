"""Per-keypoint SIFT kernels (ops/sift_triton.py, Pallas Triton route) in
interpret mode against the XLA formulation (ops/sift_kernels.py), the
backend choice, and the XLA detect stage against a NumPy 26-neighbour
scan."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from computervisionimagestich2_tpu.config import SiftConfig
from computervisionimagestich2_tpu.models import sift as sift_mod
from computervisionimagestich2_tpu.ops import sift_kernels as sk
from computervisionimagestich2_tpu.ops import sift_triton as st


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    h, w = 96, 80
    mod = jnp.asarray(rng.random((h, w), dtype=np.float32))
    ang = jnp.asarray((rng.random((h, w)) * 2 * np.pi).astype(np.float32))
    n, nv = 48, 31
    # some keypoints fall off the image: the kernels' guards must agree
    x = jnp.asarray((rng.random(n) * (w - 1) * 1.06 - 2).astype(np.float32))
    y = jnp.asarray((rng.random(n) * (h - 1) * 1.06 - 2).astype(np.float32))
    sig = jnp.asarray((1.2 + rng.random(n) * 2.5).astype(np.float32))
    a0 = jnp.asarray((rng.random(n) * 2 * np.pi).astype(np.float32))
    valid = jnp.arange(n) < nv
    return h, w, mod, ang, x, y, sig, a0, valid


def _padded(mod, ang, r):
    grad = jnp.stack([mod, ang], axis=-1)[None]
    return jnp.pad(grad, ((0, 0), (r, r), (r, r), (0, 0)))


def test_orientation_matches_xla(scene):
    h, w, mod, ang, x, y, sig, _, valid = scene
    r = 17
    n = x.shape[0]
    ang_ref, av_ref = sk.orientation_histograms(
        _padded(mod, ang, r), jnp.zeros(n, jnp.int32), x, y, sig, valid,
        w, h, r, 36, 4)
    hist, ok = st.orientation_hist(mod, ang, x, y, sig, valid, w, h, r, 36,
                                   interpret=True)
    ang_p, av_p = sk.orientation_peaks(hist, ok, 36, 4)
    np.testing.assert_array_equal(np.asarray(av_ref), np.asarray(av_p))
    np.testing.assert_allclose(np.asarray(ang_ref), np.asarray(ang_p),
                               atol=1e-5)


def test_descriptor_matches_xla(scene):
    h, w, mod, ang, x, y, sig, a0, valid = scene
    r = 28
    n = x.shape[0]
    desc_ref, ok_ref = sk.descriptors(
        _padded(mod, ang, r), jnp.zeros(n, jnp.int32), x, y, sig, a0, valid,
        w, h, r, 3.0, 2.0, 4, 8)
    desc_p, ok_p = st.descriptors(mod, ang, x, y, sig, a0, valid, w, h, r,
                                  3.0, 2.0, 4, 8, interpret=True)
    okr = np.asarray(ok_ref)
    np.testing.assert_array_equal(okr, np.asarray(ok_p))
    dr, dp = np.asarray(desc_ref), np.asarray(desc_p)
    np.testing.assert_allclose(dp, dr, rtol=1e-5, atol=1e-6)
    cos = (dr[okr] * dp[okr]).sum(1) / (
        np.linalg.norm(dr[okr], axis=1) * np.linalg.norm(dp[okr], axis=1))
    assert cos.min() >= 0.99999, cos.min()


def test_dead_slots_zeroed(scene):
    h, w, mod, ang, x, y, sig, a0, _ = scene
    valid = jnp.arange(x.shape[0]) < 5
    desc, ok = st.descriptors(mod, ang, x, y, sig, a0, valid, w, h, 10,
                              interpret=True)
    hist, ook = st.orientation_hist(mod, ang, x, y, sig, valid, w, h, 10,
                                    interpret=True)
    assert not np.asarray(ok)[5:].any() and not np.asarray(ook)[5:].any()
    np.testing.assert_array_equal(np.asarray(desc)[5:], 0.0)
    np.testing.assert_array_equal(np.asarray(hist)[5:], 0.0)


def test_kernels_batch_under_vmap(scene):
    """The pallas_call batching rule: a vmapped batch of levels equals the
    per-level calls (the Stitcher vmaps SIFT over its frames)."""
    h, w, mod, ang, x, y, sig, a0, valid = scene
    mods = jnp.stack([mod, mod[::-1]])
    angs = jnp.stack([ang, ang[:, ::-1]])
    fn = jax.vmap(lambda m, a: st.descriptors(m, a, x, y, sig, a0, valid,
                                              w, h, 12, interpret=True))
    d_b, ok_b = fn(mods, angs)
    for i in range(2):
        d_i, ok_i = st.descriptors(mods[i], angs[i], x, y, sig, a0, valid,
                                   w, h, 12, interpret=True)
        np.testing.assert_allclose(np.asarray(d_b[i]), np.asarray(d_i),
                                   atol=1e-6)
        np.testing.assert_array_equal(np.asarray(ok_b[i]), np.asarray(ok_i))


def test_sift_extract_kernel_route_matches_xla():
    """The whole sift_extract through the kernel route (interpret mode)
    finds the same keypoints with the same descriptors as the XLA
    route."""
    from computervisionimagestich2_tpu.utils.synth import render_sweep

    rgb = render_sweep(3, 1, 112, 96).frames[0].astype(np.float32)
    img = rgb @ np.asarray([0.299, 0.587, 0.114], np.float32)
    base = dict(n_octaves=2, max_keypoints=1024,
                max_keypoints_per_octave=512)
    f_x = sift_mod.sift_extract(jnp.asarray(img),
                                SiftConfig(pallas="off", **base))
    f_k = sift_mod.sift_extract(jnp.asarray(img),
                                SiftConfig(pallas="interpret", **base))
    for a, b in ((f_x.valid, f_k.valid), (f_x.xy, f_k.xy),
                 (f_x.scale, f_k.scale)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(np.asarray(f_x.desc), np.asarray(f_k.desc),
                               atol=2e-5)
    assert int(np.asarray(f_x.valid).sum()) > 20


def test_kernel_route_auto_picks_triton_only_on_gpu(monkeypatch):
    cfg = SiftConfig()
    assert sift_mod.kernel_route(cfg) is None             # tests run on CPU
    for platform, want in (("gpu", "triton"), ("cpu", None), ("rocm", None)):
        monkeypatch.setattr(sift_mod.jax, "default_backend",
                            lambda p=platform: p)
        assert sift_mod.kernel_route(cfg) == want, platform
    # an explicit default device overrides the backend (a CPU stitch
    # inside a GPU process takes the XLA route)
    monkeypatch.setattr(sift_mod.jax, "default_backend", lambda: "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert sift_mod.kernel_route(cfg) is None
    for pallas, want in (("off", None), ("interpret", "interpret")):
        assert sift_mod.kernel_route(
            dataclasses.replace(cfg, pallas=pallas)) == want
    with pytest.raises(ValueError):
        sift_mod.kernel_route(dataclasses.replace(cfg, pallas="on"))


# ------------------------------------------------------------------ detect
def oracle_extrema(dog, peak_thresh):
    """Strict 26-neighbour extrema (vl/sift.c:539-603) as a NumPy scan:
    coords [K, 3] (mask slice, y, x) in scan order."""
    n_s, h, w = dog.shape
    gate = 0.8 * peak_thresh
    v = dog[1:-1, 1:-1, 1:-1]
    is_max = v >= gate
    is_min = v <= -gate
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == dy == dx == 0:
                    continue
                nb = dog[1 + ds:n_s - 1 + ds, 1 + dy:h - 1 + dy,
                         1 + dx:w - 1 + dx]
                is_max &= v > nb
                is_min &= v < nb
    s, y, x = np.nonzero(is_max | is_min)
    return np.stack([s, y + 1, x + 1], axis=-1)


@pytest.mark.parametrize("hw", [(64, 96), (61, 130), (33, 40)])
def test_detect_compact_matches_xla(hw):
    """extrema_mask + compact_mask == the NumPy scan: same coordinates in
    the same scan order, including odd dims."""
    rng = np.random.default_rng(11)
    h, w = hw
    dog = rng.normal(size=(4, h, w)).astype(np.float32) * 2
    want = oracle_extrema(dog, 1.0)
    mask = sk.extrema_mask(jnp.asarray(dog), 1.0)
    coords, valid = sk.compact_mask(mask, 2048)
    n = int(np.asarray(valid).sum())
    assert n == len(want) == int(np.asarray(mask).sum())
    np.testing.assert_array_equal(np.asarray(coords)[:n], want)


def test_detect_compact_capacity_truncation():
    """A binding capacity keeps the FIRST cap hits in scan order, and the
    uncapped count (what the cand_dropped telemetry subtracts) stays
    exact."""
    rng = np.random.default_rng(5)
    dog = rng.normal(size=(4, 48, 64)).astype(np.float32) * 3
    want = oracle_extrema(dog, 0.5)
    assert len(want) > 8
    mask = sk.extrema_mask(jnp.asarray(dog), 0.5)
    coords, valid = sk.compact_mask(mask, 8)
    assert np.asarray(valid).all()
    np.testing.assert_array_equal(np.asarray(coords), want[:8])
    assert int(np.asarray(mask).sum()) == len(want)
