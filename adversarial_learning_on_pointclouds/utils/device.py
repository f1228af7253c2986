"""Which device a measurement ran on.

Every timing the repo prints names its device, and a measurement that
finds no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess
import sys


def require_gpu(tool: str):
    """The JAX devices, or exit nonzero when the first is not a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"{tool}: JAX found no GPU (platform "
              f"{devices[0].platform!r}); refusing to measure",
              file=sys.stderr)
        raise SystemExit(2)
    return devices


def device_record(devices) -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports them."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line
    (the clock a timing ran under depends on the limit)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
