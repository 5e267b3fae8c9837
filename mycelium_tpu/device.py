"""Backend facts the program depends on, kept in one place.

Nothing else in the package asks JAX which backend it runs on. No code
path differs by platform; measurement paths refuse anything but a GPU
(``require_gpu``) and name the device they measured (``device_info``).
"""

from __future__ import annotations

import jax


def platform() -> str:
    """The default backend's platform name: 'cpu' or 'gpu'."""
    return jax.default_backend()


def device_info() -> dict:
    """Platform, device kind and count of the default backend, as every
    benchmark row reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def require_gpu(found: str | None = None) -> None:
    """Raise unless the default backend (or ``found``) is a GPU.

    Measurement paths call this first: a timing taken on the CPU is not a
    device number, so a run that finds no GPU fails instead of falling
    back."""
    found = platform() if found is None else found
    if found != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {found!r}")

