"""utils/device.py: the one GPU test and the compilation-cache location."""

import jax

from graphtyper_tpu.utils import device


def test_gpu_available_false_on_cpu():
    assert jax.default_backend() == "cpu"
    assert device.gpu_available() is False


def test_cache_defaults_to_checkout_dir(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(device, "_CACHE_SET", False)
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    device.enable_compilation_cache()
    device.enable_compilation_cache()  # once per process
    repo = __file__.rsplit("/tests/", 1)[0]
    assert calls == [("jax_compilation_cache_dir", f"{repo}/.jax_cache")]


def test_cache_env_wins_and_nothing_is_set(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    monkeypatch.setattr(device, "_CACHE_SET", False)
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    device.enable_compilation_cache()
    assert calls == []
