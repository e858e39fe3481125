"""Backend bootstrap and compile-cache placement (utils.runtime,
utils.profiling): no probe child, no fallback, one cache directory."""

import os
import subprocess

import jax
import pytest

from audio_raytracing_studio_tpu.utils import profiling, runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert profiling.compilation_cache_dir() == str(tmp_path / "cc")


def test_cache_dir_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = profiling.compilation_cache_dir()
    assert d == os.path.join(REPO, ".jax_cache")
    assert d == profiling.compilation_cache_dir()  # not per call or process
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compilation_cache_uses_env_dir(monkeypatch, tmp_path,
                                               restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert profiling.enable_compilation_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    assert os.path.isdir(tmp_path / "cc")


def test_ensure_backend_starts_no_subprocess(monkeypatch, restore_cache_config):
    def forbidden(*a, **k):
        raise AssertionError("ensure_backend started a child process")

    monkeypatch.setattr(subprocess, "Popen", forbidden)
    monkeypatch.setattr(subprocess, "run", forbidden)
    assert runtime.ensure_backend() == "cpu"


def test_ensure_backend_never_falls_back(monkeypatch, restore_cache_config):
    """A platform that cannot start is an error, not a silent CPU run."""
    def broken():
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "devices", broken)
    platforms = jax.config.jax_platforms
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.ensure_backend()
    assert jax.config.jax_platforms == platforms


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        runtime.require_gpu()


def test_gpu_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert runtime.gpu_card_info().startswith("not available")
