"""The one place that names the compute platform.

Every platform-dependent choice in the engine (default mesh width,
occ-table layout, on-path route, transfer profile) asks this module,
never `jax.default_backend()` or the environment. Two platforms are
supported: "gpu" (CUDA) and "cpu"; anything else raises.
"""

from __future__ import annotations

from typing import NamedTuple

SUPPORTED = ("gpu", "cpu")


class Device(NamedTuple):
    platform: str   # "gpu" | "cpu"
    kind: str       # jax device_kind, e.g. "NVIDIA H100 80GB HBM3"
    count: int      # local devices of that platform


def active() -> Device:
    """The platform JAX computes on: `jax.devices()[0]`."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {d.platform!r} "
            f"({d.device_kind}); supported: {', '.join(SUPPORTED)}"
        )
    return Device(d.platform, d.device_kind, len(devs))


def on_gpu() -> bool:
    return active().platform == "gpu"


def select(device: str) -> Device:
    """Pin JAX to `device` ("auto" | "gpu" | "cpu") before its first use
    and return what it resolved to. "gpu" selects CUDA and raises
    RuntimeError when no GPU is present; it never falls back to the
    CPU. "auto" keeps JAX's own default."""
    import jax

    if device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif device == "gpu":
        jax.config.update("jax_platforms", "cuda")
        try:
            dev = active()
        except Exception as exc:  # jax raises assorted types here
            raise RuntimeError(
                "--device gpu: JAX found no CUDA GPU "
                f"({type(exc).__name__}: {exc})"
            ) from exc
        if dev.platform != "gpu":
            raise RuntimeError(
                f"--device gpu: JAX resolved to {dev.platform!r}"
            )
        return dev
    elif device != "auto":
        raise ValueError(f"unknown device {device!r}")
    return active()


def describe(dev: Device | None = None) -> dict:
    """JSON-ready record of the device a result was taken on."""
    dev = dev or active()
    return {"platform": dev.platform, "kind": dev.kind, "count": dev.count}


def card_info() -> str:
    """`name, power.limit` of each GPU as nvidia-smi reports them (one
    line per card); raises when nvidia-smi is missing or fails."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
