"""What a measurement ran on: the device record and the peak-rate table.

Every benchmark number is printed beside the device it was taken on
(platform, ``device_kind``, device count, the card's power limit and
``XLA_FLAGS``). A measurement path that finds no GPU fails instead of
timing the CPU backend, and a roofline share is only computed against a
device whose published peaks are in ``DEVICE_PEAKS``: an unknown device is
an error, not a default.
"""

from __future__ import annotations

import os
import shutil
import subprocess

# Published peaks, keyed by jax ``device_kind``. NVIDIA H100 SXM data sheet
# (dense rates, no sparsity): 3.35 TB/s HBM3, 989 TFLOP/s bf16 — at the
# full 700 W power limit; a card set lower cannot hold its top clock.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flop_per_s": 989e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; raises KeyError for a device that is
    not in the table."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add them "
            "to heat_cf.utils.device.DEVICE_PEAKS with their source"
        ) from None


# XLA's deterministic GPU lowering: scatter-adds sum duplicate ids in a
# fixed (sorted) order instead of with atomics, so a program gives the same
# bits on every run. XLA reads the flag once, when JAX creates its backend.
# It is for tests that compare two programs: at full table sizes it makes
# the training scatters orders of magnitude slower.
DETERMINISTIC_OPS_FLAG = "--xla_gpu_deterministic_ops=true"


def deterministic_ops() -> bool:
    """Whether XLA_FLAGS asks for the deterministic GPU lowering."""
    return DETERMINISTIC_OPS_FLAG in os.environ.get("XLA_FLAGS", "").split()


def gpu_name_and_power_limit(index: str | None = None) -> str:
    """``name, power.limit`` of card ``index`` (an nvidia-smi index or
    UUID; default every card, one per line), as nvidia-smi prints them, or
    a note when nvidia-smi is absent."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    select = [] if index is None else ["-i", index]
    out = subprocess.run(
        [
            "nvidia-smi",
            *select,
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def require_gpu():
    """The first JAX device, which must be a GPU; raises SystemExit (code 2)
    otherwise, so a measurement never falls back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX found platform {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev


def device_record() -> dict:
    """The device a result was measured on, for every printed record."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "name_power_limit": gpu_name_and_power_limit(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "jax_version": jax.__version__,
    }
