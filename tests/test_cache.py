"""Persistent-compilation-cache plumbing (utils/cache.py)."""

import os
import subprocess

import jax

from heat_cf.utils import cache
from heat_cf.utils.cache import enable_compilation_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_enable_sets_default_dir_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("HEAT_CF_NO_COMPILATION_CACHE", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        out = enable_compilation_cache()
        assert out == os.path.join(REPO, ".jax_cache")
        assert os.path.isdir(out)
        assert jax.config.jax_compilation_cache_dir == out
        # A second call (another process) lands on the same fixed path.
        assert enable_compilation_cache() == out
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_default_dir_is_git_ignored():
    rel = os.path.relpath(cache.DEFAULT_DIR, REPO)
    assert not rel.startswith("..")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        patterns = {line.strip().strip("/") for line in fh}
    assert rel in patterns
    probe = subprocess.run(
        ["git", "check-ignore", "-q", os.path.join(rel, "x")],
        cwd=REPO, capture_output=True,
    )
    # 0 = ignored; 128 = not a git checkout (an unpacked archive).
    assert probe.returncode in (0, 128)


def test_env_var_is_honoured_and_nothing_is_set(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        assert enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_enable_respects_existing_config(tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        assert enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_enable_disabled_by_env(monkeypatch):
    monkeypatch.setenv("HEAT_CF_NO_COMPILATION_CACHE", "1")
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        assert enable_compilation_cache() is None
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
