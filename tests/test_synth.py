"""Seeded sweeps (utils/synth.py): determinism, the translation ground
truth, and the Stitcher recovering it on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from computervisionimagestich2_tpu.config import (
    DEFAULT_CONFIG, MatchConfig, RansacConfig, SiftConfig)
from computervisionimagestich2_tpu.models.stitcher import Stitcher
from computervisionimagestich2_tpu.ops.warp import cylindrical_project
from computervisionimagestich2_tpu.utils.synth import (
    plan_offsets, render_sweep)


def test_render_sweep_deterministic_with_translation_truth():
    a = render_sweep(5, 3, 160, 128)
    b = render_sweep(5, 3, 160, 128)
    c = render_sweep(6, 3, 160, 128)
    for fa, fb in zip(a.frames, b.frames):
        assert fa.shape == (160, 128, 3) and fa.dtype == np.uint8
        np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    assert not np.array_equal(a.frames[0], c.frames[0])
    assert a.offsets.shape == (2, 2) and np.all(a.offsets[:, 1] == 0)
    assert abs(a.span - (a.offsets[:, 0].sum() + 128)) < 1e-9
    # after the stitcher's projection, frame 1 is frame 0 moved left by
    # the true offset (bilinear resampling blurs, so compare loosely;
    # equal exposures)
    flat = render_sweep(5, 2, 160, 128, exposure=0.0)
    p0, p1 = (np.asarray(cylindrical_project(jnp.asarray(f, jnp.float32)))
              for f in flat.frames)
    dx = int(round(flat.offsets[0, 0]))
    ov0, ov1 = p0[40:120, dx + 20:108], p1[40:120, 20:108 - dx]
    assert np.abs(ov0 - ov1).mean() < 6.0
    shifted = p1[40:120, 23:111 - dx]          # 3 px off: clearly worse
    assert np.abs(ov0 - shifted).mean() > 2 * np.abs(ov0 - ov1).mean()


def test_stitcher_recovers_ground_truth():
    """4 x 320x256 seeded sweep, graph ordering: every planned edge within
    3 px of the true offset, canvas width within 2% of the true span,
    nothing dropped by a static capacity."""
    cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        sift=SiftConfig(n_octaves=3),
        match=MatchConfig(max_matches=1024),
        ransac=RansacConfig(n_hypotheses=64))
    sweep = render_sweep(0, 4, 320, 256)
    st = Stitcher(cfg)
    out = st.stitch(sweep.frames)
    assert np.asarray(st.sift_dropped).sum() == 0
    assert st.plan[:, 22].sum() == 0
    assert len(st.edge_seq) == 3
    for src, dst, dx, dy, tx, ty in plan_offsets(st.plan, st.edge_seq,
                                                 (320, 256), sweep):
        assert abs(dx - tx) <= 3.0 and abs(dy - ty) <= 3.0, (src, dst,
                                                             dx, tx, dy)
    assert abs(out.shape[1] - sweep.span) <= 0.02 * sweep.span
