"""Test harness: run everything on a virtual 8-device CPU mesh.

Mirrors the multi-device testing strategy: sharding paths are exercised on
CPU devices (SURVEY.md §4); the GPU runs go through chip_smoke.py.

The platform is pinned through jax.config so the tests stay on the CPU
even where a GPU is present. XLA_FLAGS is honoured because backends
initialize lazily.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# NOTE: do not enable the persistent compilation cache here — the XLA:CPU
# AOT loader flags machine-feature mismatches on this host (+prefer-no-
# scatter/-gather) and reloaded code can SIGILL.

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_sessionstart(session):
    assert jax.default_backend() == "cpu", jax.default_backend()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules: the XLA:CPU JIT
    segfaulted twice deep into full-suite runs (inside
    backend_compile_and_load, hundreds of cached executables in-process)
    while the same test passed alone — bounding the live compilation state
    avoids it, and caps the suite's memory growth."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def reference_dir():
    """Root of the reference C++ checkout (Input/, src/ex6/dataset*/), named
    by PANORAMA_TPU_REFERENCE_DIR; tests of its real photographs skip
    without it."""
    d = os.environ.get("PANORAMA_TPU_REFERENCE_DIR", "")
    if not os.path.isdir(d):
        pytest.skip("real photographs need PANORAMA_TPU_REFERENCE_DIR "
                    "(the reference checkout)")
    return d


@pytest.fixture(scope="session")
def input_paths(tmp_path_factory):
    """A seeded 4-image set shaped like the reference's Input/ dataset
    (4 x 512x384 portrait frames), written as 1.bmp..4.bmp through
    save_image."""
    from computervisionimagestich2_tpu.utils import save_image
    from computervisionimagestich2_tpu.utils.synth import render_sweep

    d = tmp_path_factory.mktemp("input")
    paths = []
    for i, frame in enumerate(render_sweep(1, 4, 512, 384).frames, 1):
        paths.append(str(d / f"{i}.bmp"))
        save_image(paths[-1], frame)
    return paths


@pytest.fixture(scope="session")
def input_images(input_paths):
    """The seeded 4-image set read back as RGB uint8 arrays."""
    from computervisionimagestich2_tpu.utils import load_image

    return [load_image(p) for p in input_paths]


@pytest.fixture()
def rng():
    """Function-scoped: each test draws from a fresh seed-0 stream, so test
    data never depends on which tests ran before (a session-scoped stream
    made gates order-dependent: adding a test upstream reshuffled every
    later test's scene)."""
    return np.random.default_rng(0)
