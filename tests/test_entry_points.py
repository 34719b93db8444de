"""Entry-point plumbing: compile-cache placement (utils/cache.py) and
chip_smoke.py's refusal to run without a GPU."""
import json
import os
import subprocess
import sys

from computervisionimagestich2_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("PANORAMA_TPU_NO_CACHE", raising=False)
    assert cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    calls = []
    monkeypatch.setattr("jax.config.update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    assert cache.enable_compile_cache() == os.path.join(ROOT, ".jax_cache")
    assert ("jax_compilation_cache_dir",
            os.path.join(ROOT, ".jax_cache")) in calls
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_env_var_is_left_alone(monkeypatch):
    calls = []
    monkeypatch.setattr("jax.config.update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert cache.cache_dir() is None
    assert cache.enable_compile_cache() is None
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    monkeypatch.setenv("PANORAMA_TPU_NO_CACHE", "1")
    assert cache.enable_compile_cache() is None
    assert calls == []


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and "GPU" in last["error"]
