"""Multi-host fan-out: deterministic corpus sharding + overflow-safe global
stats, including a real 2-process jax.distributed smoke test on CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from basisu_rs_jax.parallel.multihost import global_stats, shard_corpus


def test_shard_corpus_single_process_owns_all():
    paths = [f"f{i}" for i in range(7)]
    assert shard_corpus(paths) == paths


def test_global_stats_single_process_no_overflow():
    # Texel counts beyond int32 (the old psum wrapped at 2.1e9).
    t, e = global_stats(3_000_000_000, 5)
    assert (t, e) == (3_000_000_000, 5)


_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")

    from basisu_rs_jax.parallel.multihost import global_stats, initialize, shard_corpus

    pid = int(sys.argv[1])
    initialize(coordinator_address=sys.argv[2], num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.process_index() == pid

    paths = [f"f{i}" for i in range(5)]
    mine = shard_corpus(paths)
    expected = [p for i, p in enumerate(paths) if i % 2 == pid]
    assert mine == expected, (mine, expected)

    # per-process counters: process 0 brings 3e9 texels (beyond int32), 1 err
    t, e = global_stats(3_000_000_000 if pid == 0 else 7, 1 if pid == 0 else 2)
    assert (t, e) == (3_000_000_007, 3), (t, e)
    print(f"proc{pid} ok")
    """
)


def test_two_process_distributed_smoke(tmp_path):
    """Spawn two real processes, bootstrap jax.distributed over localhost,
    and check sharding + gathered stats end-to-end."""
    # reserve a genuinely free port (pid-derived ports can collide across
    # concurrent runs); the brief close->bind race window is acceptable for
    # a smoke test
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["XLA_FLAGS"] = ""  # no virtual device splitting in the workers
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), coord],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=repo_root,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed smoke test timed out (coordinator hang?)")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        assert f"proc{pid} ok" in out
