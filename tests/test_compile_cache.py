"""Where the persistent compilation cache lives (runtime/compile_cache.py):
the environment's directory when it names one, otherwise one fixed,
gitignored directory inside the checkout."""

import os
from pathlib import Path

import jax
import pytest

from astroburst_tpu.runtime import compile_cache as CC

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_honoured_and_nothing_else_set(monkeypatch, tmp_path,
                                                  config_updates):
    monkeypatch.setenv(CC.ENV_VAR, str(tmp_path / "cc"))
    assert CC.cache_dir() == str(tmp_path / "cc")
    assert CC.enable_compile_cache() == str(tmp_path / "cc")
    assert config_updates == []


@pytest.mark.parametrize("env", [None, ""])
def test_default_is_fixed_gitignored_dir_in_checkout(monkeypatch, env,
                                                     config_updates):
    if env is None:
        monkeypatch.delenv(CC.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(CC.ENV_VAR, env)
    path = Path(CC.enable_compile_cache())
    assert config_updates == [("jax_compilation_cache_dir", str(path))]
    assert path == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert f"{path.name}/" in ignored


def test_default_path_does_not_move(monkeypatch, tmp_path):
    """The path is part of the cache key: the same from any working
    directory, on every call, with no process id in it."""
    monkeypatch.delenv(CC.ENV_VAR, raising=False)
    first = CC.cache_dir()
    monkeypatch.chdir(tmp_path)
    assert CC.cache_dir() == first == str(REPO / ".jax_cache")
    assert str(os.getpid()) not in first


def test_api_import_points_jax_at_the_cache():
    """The api is an entry point: importing it configures the cache
    directory (the tests themselves keep the cache switched off)."""
    import astroburst_tpu.api  # noqa: F401
    assert jax.config.jax_compilation_cache_dir == CC.cache_dir()
    assert jax.config.jax_enable_compilation_cache is False
