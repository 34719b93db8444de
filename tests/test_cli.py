"""CLI argument parsing and flag -> config threading (cli.py, the L5
entry — SURVEY.md §2.1 "Entry point"). Pure parse/config tests: the
stitching behind the CLI is covered by tests/test_integration.py and the
GPU run in chip_smoke.py."""
import pytest

from computervisionimagestich2_tpu import cli


def parse(*argv):
    return cli.make_parser().parse_args(["--input", "dir", *argv])


def test_defaults_match_root_variant():
    """Bare invocation = the root main's semantics (graph discovery,
    19/20 mix via DEFAULT_CONFIG, bucketed canvases)."""
    cfg = cli.build_config(parse())
    assert cfg.ordering == "graph"
    assert cfg.warp_model == "bilinear"
    assert not cfg.exact_canvas
    assert not cfg.color_transfer
    assert cfg.enhance.enabled
    assert cfg.enhance.mix_weight == pytest.approx(19.0 / 20.0)
    assert cfg.blend.level_mode == "max"
    assert not cfg.blend.gain_compensation


def test_chain_flips_ex6_knobs():
    """--ordering chain = the ex6 variant: 5/6 luma mix
    (src/ex6/ImageProcess.cpp:270) and min-dim pyramid levels
    (src/ex6/ImageProcess.cpp:662-665)."""
    cfg = cli.build_config(parse("--ordering", "chain"))
    assert cfg.ordering == "chain"
    assert cfg.enhance.mix_weight == pytest.approx(5.0 / 6.0)
    assert cfg.blend.level_mode == "min"


def test_feature_flags_thread_into_config():
    cfg = cli.build_config(parse(
        "--no-enhance", "--color-transfer", "--gain-compensation",
        "--warp-model", "projective", "--exact-canvas"))
    assert not cfg.enhance.enabled
    assert cfg.color_transfer
    assert cfg.blend.gain_compensation
    assert cfg.warp_model == "projective"
    assert cfg.exact_canvas
    assert cfg.blend.dtype == "auto"


def test_blend_dtype_flag_threads_into_config():
    assert cli.build_config(parse("--blend-dtype", "bf16")).blend.dtype == \
        "bf16"
    assert cli.build_config(parse("--blend-dtype", "f32")).blend.dtype == \
        "f32"
    assert cli.build_config(parse()).blend.dtype == "auto"


def test_seam_band_flag_threads_into_config():
    cfg = cli.build_config(parse("--seam-band", "256"))
    assert cfg.blend.seam_band == 256
    assert cli.build_config(parse()).blend.seam_band == 0


def test_gain_mode_flag_threads_into_config():
    cfg = cli.build_config(parse("--gain-compensation", "--gain-mode", "rgb"))
    assert cfg.blend.gain_compensation and cfg.blend.gain_mode == "rgb"
    assert cli.build_config(parse()).blend.gain_mode == "luma"


def test_bucketed_canvas_flag_overrides_exact():
    a = parse("--exact-canvas", "--bucketed-canvas")
    assert not cli.build_config(a).exact_canvas


def test_missing_input_dir_needs_two_images(tmp_path, monkeypatch):
    """count autodetect over 1.bmp..N.bmp; < 2 images is a parser error
    (the reference would just crash on a missing read)."""
    monkeypatch.setenv("PANORAMA_TPU_NO_CACHE", "1")
    with pytest.raises(SystemExit):
        cli.main(["--input", str(tmp_path)])


def test_resume_requires_artifacts(tmp_path, monkeypatch):
    monkeypatch.setenv("PANORAMA_TPU_NO_CACHE", "1")
    import numpy as np

    from computervisionimagestich2_tpu.utils.io import save_image

    rng = np.random.default_rng(0)
    for i in (1, 2):
        save_image(str(tmp_path / f"{i}.bmp"),
                   rng.integers(0, 255, (32, 24, 3)).astype(np.uint8))
    with pytest.raises(SystemExit):
        cli.main(["--input", str(tmp_path), "--resume"])
