"""What a measurement names about the device it ran on.

Every speed figure pvot prints comes from a GPU run and carries the device
it came from: JAX's platform, device_kind and device count, and the card's
name and power limit as nvidia-smi reports them (a card set below its
maximum power runs slower under load).  Measurement entry points call
require_gpu() first: with no GPU they stop, they never fall back to the CPU.
"""

from __future__ import annotations

import subprocess


def device_fields() -> dict:
    """platform, device_kind and device count as JAX reports them."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def require_gpu(what: str) -> dict:
    """device_fields(), or SystemExit(2) when JAX finds no GPU."""
    fields = device_fields()
    if fields["platform"] != "gpu":
        raise SystemExit(
            f"{what} measures a GPU; JAX found platform "
            f"{fields['platform']!r}"
        )
    return fields


def card_name_and_power_limit() -> str:
    """`name, power.limit` of each card, one line each, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
