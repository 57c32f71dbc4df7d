"""Persistent compilation cache placement (utils.cache)."""

import os

import jax
import pytest

from jaxmot.utils import cache


@pytest.fixture
def restore_jax_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_var_wins_and_nothing_is_set_in_code(monkeypatch, tmp_path,
                                                 restore_jax_cache_config):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert cache.cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_checkout_cache(monkeypatch,
                                       restore_jax_cache_config):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    got = cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_default_path_is_stable(monkeypatch):
    """Fixed across calls and processes: absolute, inside the checkout,
    derived from no temporary name, process id or time."""
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    a, b = cache.cache_dir(), cache.cache_dir()
    assert a == b == cache.DEFAULT_DIR
    assert os.path.isabs(a) and os.path.basename(a) == ".jax_cache"
    assert str(os.getpid()) not in a
    with open(os.path.join(cache.CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_program_entry_enables_cache(monkeypatch):
    """`python -m jaxmot ...` places the cache; a library call of
    cli.main with an argument list leaves the process's config alone."""
    import sys

    from jaxmot import cli

    calls = []
    monkeypatch.setattr(cache, "enable_compile_cache",
                        lambda: calls.append(1))
    monkeypatch.setattr(cli, "cmd_mot", lambda args: 0)
    assert cli.main(["mot", "--synthetic"]) == 0 and calls == []
    monkeypatch.setattr(sys, "argv", ["jaxmot", "mot", "--synthetic"])
    assert cli.main() == 0 and calls == [1]
