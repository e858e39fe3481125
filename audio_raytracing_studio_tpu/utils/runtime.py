"""Runtime/backend bootstrapping shared by CLI and app entry points."""

from __future__ import annotations

import logging

log = logging.getLogger("ars_tpu.runtime")


def ensure_backend() -> str:
    """Initialize JAX for a product entry point and return its platform.

    JAX honours ``JAX_PLATFORMS`` itself (``cpu`` for a rehearsal without an
    accelerator); with it unset JAX picks the accelerator it finds.  This
    turns on the persistent compile cache, initializes the backend and logs
    the devices.  If the requested platform cannot start, JAX's error
    propagates: there is no fallback to another platform.
    """
    import os

    import jax

    from .profiling import enable_compilation_cache

    platforms = os.environ.get("JAX_PLATFORMS", "").strip()
    if platforms:  # also when set after jax was imported
        jax.config.update("jax_platforms", platforms)
    cache_dir = enable_compilation_cache()
    devices = jax.devices()
    log.info(
        "JAX platform %s: %d × %s (compile cache %s)",
        devices[0].platform, len(devices), devices[0].device_kind, cache_dir,
    )
    return jax.default_backend()


def require_gpu() -> list:
    """The JAX devices, if they are GPUs; otherwise exit with a message.

    For measurement paths (bench.py, chip_smoke.py, tools/): a number
    taken on another platform must never pass for a GPU number."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"needs a GPU, but JAX found {devices[0].platform!r} "
            f"({devices[0].device_kind}); refusing to measure"
        )
    return devices


def gpu_card_info() -> str:
    """``name, power.limit`` per card, as nvidia-smi reports them.

    Runs nvidia-smi as a child that never touches JAX, so the card stays
    with this process.  Returns "not available" where nvidia-smi is
    missing or fails."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not available ({type(e).__name__})"
    if proc.returncode != 0:
        return f"not available (nvidia-smi exit {proc.returncode})"
    return proc.stdout.strip()


def gpu_device_record() -> dict:
    """Backend up, GPU required: the device record a measurement prints
    beside its numbers (platform, device kind, count, card and power
    limit)."""
    ensure_backend()
    devices = require_gpu()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": gpu_card_info(),
    }


def enable_nan_checks() -> None:
    """Numeric sanitizer (SURVEY §5.2): raise on NaN escaping any jitted op.

    The functional model removes data races; NaN propagation is the remaining
    numeric hazard (the reference scrubs with np.nan_to_num at the very end,
    raytracer_studio.py:1083 — we keep that scrub AND offer eager detection).
    """
    import jax

    jax.config.update("jax_debug_nans", True)
