"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR when set, else
one fixed directory inside the checkout (listed in .gitignore)."""

from __future__ import annotations

import os

from swiftmp3_tpu.utils import compilation_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilation_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compilation_cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
