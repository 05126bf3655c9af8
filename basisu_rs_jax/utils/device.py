"""Naming the device a measurement ran on.

Every number this repository reports carries the device it came from: the
JAX platform, device kind and count, and for an NVIDIA card its name and
power limit as nvidia-smi reports them (a card set below its maximum power
runs slower under load).  A measurement path that finds no accelerator
fails; it never falls back to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess


class NoAcceleratorError(RuntimeError):
    """JAX's default device is the host CPU."""


def nvidia_smi_name_power() -> str | None:
    """`name, power.limit` of each card, one line per card, from a child
    process that does not import JAX; None where nvidia-smi is missing or
    fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        r = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def jax_device() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def require_accelerator() -> dict:
    """jax_device(), or NoAcceleratorError when the default device is the CPU."""
    dev = jax_device()
    if dev["platform"] == "cpu":
        raise NoAcceleratorError(
            "JAX found no accelerator (default platform 'cpu'); device "
            "measurements never fall back to the CPU"
        )
    return dev
