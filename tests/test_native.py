"""Native codec tests (built with g++ at first use; falls back if absent)."""
import numpy as np
import pytest

from computervisionimagestich2_tpu.native import codec
from computervisionimagestich2_tpu.utils import bmp


pytestmark = pytest.mark.skipif(not codec.available(),
                                reason="no native toolchain")


def test_native_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    p = str(tmp_path / "x.bmp")
    codec.write_bmp(p, img)
    out = codec.read_bmp(p)
    np.testing.assert_array_equal(out, img)


def test_native_matches_python_codec(tmp_path, rng):
    img = rng.integers(0, 256, (21, 33, 3), dtype=np.uint8)
    p = str(tmp_path / "x.bmp")
    bmp.write_bmp(p, img)
    np.testing.assert_array_equal(codec.read_bmp(p), bmp.read_bmp(p))


def test_native_reads_reference_dataset(input_paths):
    """Input/-shaped dataset (seeded, conftest.input_paths): the native
    and the Python decoders agree."""
    got = codec.read_bmp(input_paths[0])
    expect = bmp.read_bmp(input_paths[0])
    assert got.shape == (512, 384, 3)
    np.testing.assert_array_equal(got, expect)


def test_native_batch_loader(input_paths):
    paths = input_paths
    batch = codec.load_batch(paths)
    assert batch.shape == (4, 512, 384, 3)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(batch[i], bmp.read_bmp(p))


def test_native_rejects_garbage(tmp_path):
    p = str(tmp_path / "bad.bmp")
    with open(p, "wb") as f:
        f.write(b"NOTABMP" * 20)
    with pytest.raises(ValueError):
        codec.read_bmp(p)
