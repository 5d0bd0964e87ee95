"""The device a measurement ran on.

Every result a benchmark or the smoke check prints names its device:
JAX's platform, device kind and count, and the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum
power runs slower under load). ``nvidia-smi`` runs in a child process
that never touches JAX, so the parent stays the card's one JAX process.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


class NoGpuError(RuntimeError):
    """JAX found no GPU: a device measurement cannot be made."""


def card_line() -> str:
    """``name, power.limit`` of the first card, or why it is unknown."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else "nvidia-smi returned no card"


def device_info() -> dict:
    """platform, device_kind, count of JAX's devices plus the card line."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_line()}


def require_gpu(info: dict) -> None:
    """Raise :class:`NoGpuError` unless JAX's first device is a GPU."""
    if info["platform"] != "gpu":
        raise NoGpuError(f"no GPU: JAX's first device is on platform "
                         f"{info['platform']!r} ({info['device_kind']})")
