"""Multi-device sharding: data-parallel block transcode over a device mesh.

The workload is purely data-parallel (SURVEY.md section 5: blocks and slices
are independent; no cross-device collectives are required by the math), so
the mesh is 1-D and inputs shard over the block axis.  Collectives appear
only in aggregation (global error counts), a psum inside shard_map that XLA
hands to the device interconnect (NCCL over NVLink on GPUs).

Two sharded paths:

  - `sharded_transcode` (production): host mode-partitioning + per-mode
    kernels inside shard_map.
    Each block runs exactly one mode's arithmetic — this is the reference's
    hot loop (src/uastc.rs:157-165) parallelized without redundancy.
  - `sharded_transcode_step` (all-modes): a single static graph computing all
    19 modes and selecting; kept for tiny batches and single-jit entry points.
"""

from __future__ import annotations

import warnings
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.dispatch import (
    _bucket,
    _mode_kernel,
    partitioned_transcode,
    transcode_all_modes_fn,
)
from ..ops.etc1s import KERNELS, pad_rows, selector_wire_words_np

BLOCK_AXIS = "blocks"


def make_mesh(n_devices: int | None = None, *, allow_cpu_fallback: bool = False) -> Mesh:
    """A 1-D block-axis mesh over the first n_devices default-backend devices
    (all of them if None).

    When the default backend has fewer than n_devices, this RAISES rather
    than silently running on virtual CPU devices — a CPU mesh is orders of
    magnitude slower than the chips the caller asked for.  Dry runs that
    really want the xla_force_host_platform_device_count CPU mesh opt in
    with allow_cpu_fallback=True, which still warns loudly."""
    devices = jax.devices()
    if n_devices is not None and len(devices) < n_devices:
        if not allow_cpu_fallback:
            raise ValueError(
                f"requested a {n_devices}-device mesh but the default backend "
                f"('{devices[0].platform}') has {len(devices)} device(s); for a "
                "sharding dry run on virtual CPU devices pass "
                "allow_cpu_fallback=True"
            )
        cpu = jax.devices("cpu")
        if len(cpu) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)} on the default "
                f"backend and {len(cpu)} cpu"
            )
        warnings.warn(
            f"make_mesh: default backend ('{devices[0].platform}') has only "
            f"{len(devices)} device(s); falling back to {n_devices} virtual CPU "
            "devices (dry-run performance, not chip performance)",
            stacklevel=2,
        )
        devices = cpu
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (BLOCK_AXIS,))


def sharded_transcode_step(target: str, mesh: Mesh):
    """A jitted, mesh-sharded transcode step.

    lanes uint32[N, 4] (N divisible by mesh size) -> (out lanes, global error
    count).  The per-shard compute is the all-modes kernel; the error count is
    a psum across the mesh.
    """
    fn = transcode_all_modes_fn(target)

    def step(lanes):
        out, err = fn(lanes)
        total_err = jax.lax.psum(jnp.sum(err.astype(jnp.int32)), BLOCK_AXIS)
        return out, total_err

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=P(BLOCK_AXIS, None),
        out_specs=(P(BLOCK_AXIS, None), P()),
    )
    return jax.jit(sharded)


def shard_blocks(lanes: np.ndarray, mesh: Mesh) -> jax.Array:
    """Place a [N,4] lane tensor onto the mesh, padding N to the mesh size."""
    n_dev = mesh.devices.size
    n = lanes.shape[0]
    pad = (-n) % n_dev
    if pad:
        lanes = np.concatenate([lanes, np.zeros((pad, lanes.shape[1]), lanes.dtype)], axis=0)
    sharding = NamedSharding(mesh, P(BLOCK_AXIS, None))
    return jax.device_put(jnp.asarray(lanes), sharding)


# ---------------------------------------------------------------------------
# Production path: per-mode kernels sharded over the mesh
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def sharded_mode_step(target: str, mode_id: int, mesh: Mesh):
    """A jitted, mesh-sharded *single-mode* transcode step.

    lanes uint32[N, 4] (N divisible by mesh size, all blocks of `mode_id`) ->
    (out lanes uint32[N, W], err bool[N], global error count).  Per-shard
    compute is the mode-specialized kernel, so there is no all-modes
    redundancy; the error count is a psum across the mesh.
    """
    kernel = _mode_kernel(target, mode_id)

    def step(lanes):
        out, err = kernel(lanes)
        total_err = jax.lax.psum(jnp.sum(err.astype(jnp.int32)), BLOCK_AXIS)
        return out, err, total_err

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=P(BLOCK_AXIS, None),
        out_specs=(P(BLOCK_AXIS, None), P(BLOCK_AXIS), P()),
    )
    return jax.jit(sharded)


def sharded_transcode(blocks_u8, target: str, mesh: Mesh):
    """Production multi-chip batch transcode: numpy uint8 [N,16] -> (out, err).

    The shared partition/pad/scatter orchestration lives in
    ops.dispatch.partitioned_transcode; here each mode group is padded to a
    power-of-two bucket *per shard*, placed onto the mesh block axis, and run
    through its mode-specialized kernel inside shard_map.  Output dtype rules
    match ops.dispatch.transcode_blocks.
    """
    n_dev = mesh.devices.size
    sharding = NamedSharding(mesh, P(BLOCK_AXIS, None))

    def run_group(mode_id, group):
        step = sharded_mode_step(target, mode_id, mesh)
        o, e, _ = step(jax.device_put(jnp.asarray(group), sharding))
        return o, e

    # the plain path's bucket, rounded up to whole shards: a 1-device mesh
    # runs the same per-shard shapes as transcode_blocks
    return partitioned_transcode(
        blocks_u8, target, lambda m: -(-_bucket(m) // n_dev) * n_dev, run_group
    )


# ---------------------------------------------------------------------------
# ETC1S: codebooks replicated, index streams sharded over the block axis
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _sharded_etc1s(kind: str, mesh: Mesh):
    fn, _ = KERNELS[kind]
    n_idx = 4 if kind == "rgba_alpha" else 2
    sharded = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P()) + (P(BLOCK_AXIS),) * n_idx,
        out_specs=P(BLOCK_AXIS, None),
    )
    return jax.jit(sharded)


def sharded_etc1s_transcode(
    kind: str, endpoints_np, selectors_np, ep_idx_np, sel_idx_np, mesh: Mesh,
    extra_idx=(),
):
    """Multi-device ETC1S back-end: codebooks are replicated over the mesh
    (they are shared by every block of a file, container/basis.py), the
    per-block (endpoint, selector) index streams shard over the block axis.
    No collectives are required by the math - like the UASTC path this is
    purely data-parallel (mod.rs:97-186 per-block closures).

    kind: 'rgba' (packed texels), 'alpha' (G-channel bytes), 'etc1'
    (block lanes), or 'rgba_alpha' (fused RGB+alpha slice pair; pass the
    alpha slice's index streams as extra_idx=(a_ep_idx, a_sel_idx)).
    endpoints_np: uint8 [E,4]; selectors_np: uint8 [S,4] row bytes.
    Returns uint32 [N, W] (W = 16/16/2/16).
    """
    n_dev = mesh.devices.size
    n = len(ep_idx_np)
    selectors_np = np.asarray(selectors_np, np.uint8)
    table = selector_wire_words_np(selectors_np) if kind == "etc1" else selectors_np
    # bucketed like the plain path, rounded up to whole shards, so shapes
    # hit a bounded set of compiled programs
    n_pad = -(-_bucket(n) // n_dev) * n_dev
    repl = NamedSharding(mesh, P())
    sharding = NamedSharding(mesh, P(BLOCK_AXIS))
    out = _sharded_etc1s(kind, mesh)(
        jax.device_put(pad_rows(endpoints_np, _bucket(len(endpoints_np)), np.uint8), repl),
        jax.device_put(pad_rows(table, _bucket(len(table)), table.dtype), repl),
        *[
            jax.device_put(pad_rows(a, n_pad, np.int32), sharding)
            for a in (ep_idx_np, sel_idx_np, *extra_idx)
        ],
    )
    return np.asarray(out)[:n]
