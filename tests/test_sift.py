"""Validate the vectorized SIFT kernels against the scalar NumPy oracle
(tests/sift_oracle.py, a transcription of vl/sift.c semantics)."""
import numpy as np
import pytest

import sift_oracle as oracle
from computervisionimagestich2_tpu.config import SiftConfig
from computervisionimagestich2_tpu.models.sift import sift_extract




def make_image(seed=42, shape=(48, 64)):
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, size=shape)
    # cheap separable box smoothing to create blobs
    for _ in range(3):
        img = (np.roll(img, 1, 0) + img + np.roll(img, -1, 0)) / 3
        img = (np.roll(img, 1, 1) + img + np.roll(img, -1, 1)) / 3
    return np.trunc(img).astype(np.float32)


@pytest.mark.parametrize("seed", [42, 7])
def test_sift_matches_oracle(seed):
    img = make_image(seed)
    ocfg = oracle.Cfg(n_octaves=2, n_levels=2)
    expected = oracle.extract(img.astype(np.float64), ocfg)
    assert len(expected) > 5, "oracle should find keypoints"

    cfg = SiftConfig(n_octaves=2, max_keypoints_per_octave=512,
                     max_keypoints=1024)
    feats = sift_extract(img, cfg)
    got_valid = np.asarray(feats.valid)
    got_xy = np.asarray(feats.xy)[got_valid]
    got_desc = np.asarray(feats.desc)[got_valid]
    got_sigma = np.asarray(feats.scale)[got_valid]

    exp_xy = np.array([(e[0], e[1]) for e in expected])
    exp_sigma = np.array([e[2] for e in expected])
    exp_desc = np.stack([e[4] for e in expected])

    # counts agree within float32-vs-float64 threshold jitter
    assert abs(len(exp_xy) - len(got_xy)) <= max(2, 0.05 * len(exp_xy)), \
        (len(exp_xy), len(got_xy))

    # match each oracle keypoint to its nearest extracted keypoint
    d = np.linalg.norm(exp_xy[:, None, :] - got_xy[None, :, :], axis=-1)
    nearest = d.argmin(axis=1)
    near_d = d[np.arange(len(exp_xy)), nearest]
    matched = near_d < 0.1
    assert matched.mean() > 0.9, f"only {matched.mean():.2f} matched"

    # sigma parity on the matched set
    np.testing.assert_allclose(got_sigma[nearest[matched]],
                               exp_sigma[matched], rtol=1e-3)
    # descriptor parity: a keypoint can emit several angles at the same xy,
    # so pair each oracle descriptor with the best cosine among co-located
    # extracted descriptors.
    cos_all = exp_desc @ got_desc.T                     # [E, G]
    colocated = d < 0.1
    cos_best = np.where(colocated, cos_all, -1.0).max(axis=1)[matched]
    assert cos_best.min() > 0.999, cos_best.min()


def test_sift_order_matches_scan_order():
    """Keypoint-angle output order should follow the reference's
    octave -> (s, y, x) scan -> angle nesting (needed only for debugging
    comparisons; not a contract)."""
    img = make_image(3)
    cfg = SiftConfig(n_octaves=1, max_keypoints_per_octave=512,
                     max_keypoints=512)
    feats = sift_extract(img, cfg)
    valid = np.asarray(feats.valid)
    xy = np.asarray(feats.xy)[valid]
    assert len(xy) > 0


@pytest.mark.slow  # 18s full sift compile; zero-keypoint guard
def test_sift_empty_image():
    img = np.zeros((32, 32), np.float32)
    cfg = SiftConfig(n_octaves=2, max_keypoints_per_octave=128,
                     max_keypoints=256)
    feats = sift_extract(img, cfg)
    assert int(np.asarray(feats.count())) == 0


@pytest.mark.slow
def test_sift_omin_negative_upsampled_octave():
    """o_min=-1 (vl/sift.c:322-409): the upsampled first octave detects
    finer scales (sigma below the o_min=0 floor), coordinates stay in
    input-pixel units, and the coarser octaves' keypoints persist. True
    parity vs the real library is gated by scripts/parity_vlfeat.py's
    o_min section."""
    import jax.numpy as jnp

    img = make_image(7, (64, 80))
    cfg0 = SiftConfig(n_octaves=2, max_keypoints_per_octave=512,
                      max_keypoints=1024)
    cfg_up = SiftConfig(n_octaves=3, o_min=-1,
                        max_keypoints_per_octave=512, max_keypoints=1024)
    f0 = sift_extract(jnp.asarray(img), cfg0)
    fu = sift_extract(jnp.asarray(img), cfg_up)
    v0, vu = np.asarray(f0.valid), np.asarray(fu.valid)
    xy0, xyu = np.asarray(f0.xy)[v0], np.asarray(fu.xy)[vu]
    s0, su = np.asarray(f0.scale)[v0], np.asarray(fu.scale)[vu]
    assert len(xyu) > len(xy0)                       # extra fine keypoints
    assert su.min() < s0.min() * 0.75                # sub-sigma0 scales
    # coordinates in input units despite the 2x octave (xper = 0.5)
    assert xyu[:, 0].max() < img.shape[1] and xyu[:, 1].max() < img.shape[0]
    assert xyu.min() >= 0
    # coarse keypoints persist: for most o_min=0 keypoints there is an
    # o_min=-1 keypoint within 1 px (smoothing history differs slightly,
    # so demand 70%, not all)
    d = np.linalg.norm(xy0[:, None] - xyu[None, :], axis=-1).min(axis=1)
    assert (d <= 1.0).mean() > 0.7, (d <= 1.0).mean()


@pytest.mark.slow  # 85s: two full-image CPU sift compiles; select_strongest logic is quick-covered in test_compaction
def test_final_cap_keeps_strongest_by_response():
    """When the total keypoint capacity binds, the kept set must be the
    strongest-by-|DoG response| keypoints, in scan order, prefix-compacted
    (VERDICT r3 ask #2b; VLFeat keeps every keypoint, vl/sift.c:580-590,
    so a binding cap may only shed the weakest)."""
    import dataclasses

    import jax.numpy as jnp

    from computervisionimagestich2_tpu.config import SiftConfig
    from computervisionimagestich2_tpu.models.sift import sift_extract_stats
    from computervisionimagestich2_tpu.ops.color import to_gray
    from computervisionimagestich2_tpu.utils.synth import render_sweep

    img = render_sweep(1, 1, 512, 384).frames[0]
    gray = to_gray(jnp.asarray(img, jnp.float32))
    cfg_all = SiftConfig(pallas="off", max_keypoints=4096)
    f_all, st_all = sift_extract_stats(gray, cfg_all)
    n_all = int(np.asarray(f_all.valid.sum()))
    assert int(np.asarray(st_all)[3]) == 0 and n_all > 300

    cap = 256
    cfg_cap = dataclasses.replace(cfg_all, max_keypoints=cap)
    f_cap, st_cap = sift_extract_stats(gray, cfg_cap)
    assert int(np.asarray(st_cap)[3]) == n_all - cap  # reported, not silent
    v = np.asarray(f_cap.valid)
    assert v.sum() == cap and v.all()  # prefix-compacted, full

    # the kept keypoints must be exactly the cap strongest of the full set:
    # every kept (x, y, scale) appears in the full run's top-cap response
    # set. Responses aren't returned, so check via set inclusion of coords
    # against the full run ranked by... descriptor identity: each kept
    # descriptor row must exist in the full set (bitwise).
    full = np.asarray(f_all.desc)[np.asarray(f_all.valid)]
    kept = np.asarray(f_cap.desc)
    full_rows = {r.tobytes() for r in full}
    for r in kept:
        assert r.tobytes() in full_rows
    # and the kept set differs from plain scan-order truncation whenever a
    # stronger keypoint exists past the cap: compare with the full run's
    # first-cap rows — scan-order truncation would keep exactly those.
    first_cap = {r.tobytes() for r in full[:cap]}
    kept_set = {r.tobytes() for r in kept}
    assert kept_set != first_cap
