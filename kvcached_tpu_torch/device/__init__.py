"""Device-side KV page pool on the card."""

from .pool import DevicePagePool, PoolSpec, resolve_device

__all__ = ["DevicePagePool", "PoolSpec", "resolve_device"]
