"""The package's former name: an alias of basisu_rs_jax that warns on import
and resolves every submodule to the same module object."""

import importlib
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

import basisu_rs_jax

ROOT = Path(__file__).resolve().parents[1]
FORMER = sorted(
    p.name for p in ROOT.iterdir()
    if p.name.startswith("basisu_rs_") and p.name != "basisu_rs_jax" and (p / "__init__.py").is_file()
)


def _import_former():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return importlib.import_module(FORMER[0])


def _python(*args):
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120,
    )


def test_one_former_name_next_to_the_package():
    assert len(FORMER) == 1


def test_import_warns_deprecation():
    r = _python("-W", "error::DeprecationWarning", "-c", f"import {FORMER[0]}")
    assert r.returncode != 0 and "basisu_rs_jax" in r.stderr
    assert _python("-c", f"import {FORMER[0]}").returncode == 0


def test_public_api_is_reexported():
    former = _import_former()
    for name in basisu_rs_jax.__all__:
        assert getattr(former, name) is getattr(basisu_rs_jax, name), name


@pytest.mark.parametrize("sub", ["ops.dispatch", "container.basis", "parallel.mesh", "models"])
def test_submodules_are_the_same_objects(sub):
    _import_former()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        alias = importlib.import_module(f"{FORMER[0]}.{sub}")
    real = importlib.import_module(f"basisu_rs_jax.{sub}")
    assert alias is real
    assert real.__spec__.name == f"basisu_rs_jax.{sub}"


def test_python_dash_m_runs_the_cli():
    r = _python("-m", FORMER[0], "--help")
    assert r.returncode == 0, r.stderr
    assert "transcode" in r.stdout
