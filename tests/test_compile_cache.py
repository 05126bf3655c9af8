"""Where the persistent compilation cache goes: JAX_COMPILATION_CACHE_DIR
when set (and nothing overrides it), else the checkout's .jax_cache/."""

import os
import subprocess
import sys
from pathlib import Path

from basisu_rs_jax.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    monkeypatch.delenv(compile_cache.ENV)
    assert compile_cache.cache_dir() == str(ROOT / ".jax_cache")


def _configured_dir(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop(compile_cache.ENV, None)
    if env_value is not None:
        env[compile_cache.ENV] = env_value
    code = (
        "import jax; from basisu_rs_jax.utils.compile_cache import configure; "
        "print(configure()); print(jax.config.jax_compilation_cache_dir)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_configure_keeps_env_dir(tmp_path):
    assert _configured_dir(str(tmp_path)) == [str(tmp_path)] * 2


def test_configure_defaults_to_checkout_dir():
    assert _configured_dir(None) == [str(ROOT / ".jax_cache")] * 2
