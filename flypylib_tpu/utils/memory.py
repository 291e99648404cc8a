"""The one device-memory budget every mode decision reads.

Staged-vs-streaming detection, the shared whole-volume forward, the
out-of-core band height and the on-device voxel-PR cutoff all compare a
modelled peak against :func:`device_bytes_limit`.  Each caller also takes
an explicit ``bytes_limit=`` so tests and callers can pin the budget.
"""

from __future__ import annotations

import os

__all__ = ["device_bytes_limit", "host_memory_bytes"]


def host_memory_bytes() -> int:
    """Physical memory of this host, in bytes."""
    return int(os.sysconf("SC_PAGE_SIZE")) * int(os.sysconf("SC_PHYS_PAGES"))


def device_bytes_limit(device=None) -> int:
    """Bytes this process may allocate on ``device`` (default: the first
    device).

    GPU backends report ``memory_stats()["bytes_limit"]`` (the
    allocator's pool, i.e. the preallocated fraction of the card).  The
    CPU backend reports no memory stats; its arrays live in host RAM, so
    the budget is the host's physical memory."""
    if device is None:
        import jax

        device = jax.devices()[0]
    try:
        stats = device.memory_stats()
    except Exception:  # backends without allocator stats
        stats = None
    limit = (stats or {}).get("bytes_limit")
    return int(limit) if limit else host_memory_bytes()
