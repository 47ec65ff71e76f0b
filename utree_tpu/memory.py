"""Device memory budget for the search tables.

The table builders cap their largest array (t1) at a byte budget derived
from the device the table is placed onto:

- an accelerator reports what its allocator may hand this process
  (`device.memory_stats()["bytes_limit"]`);
- the CPU backend's devices share the host's physical memory, so each of
  them gets an equal part of it.

t1 may take 1/TABLE_SHARE of that.  The rest is left for the spill tables,
the device vote's tables and the search step's workspace; chip_smoke.py
checks that the step's `compiled.memory_analysis()` at batch 65536 fits it.
A device that reports no memory size is an error: no size is assumed.
"""

from __future__ import annotations

import os

TABLE_SHARE = 2


def device_memory_bytes(device) -> int:
    """Bytes this process may place on `device`."""
    if device.platform == "cpu":
        import jax

        host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return host // len(jax.devices("cpu"))
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{device.device_kind} ({device.platform}) reports no memory "
            "limit; pass an explicit table_budget")
    return int(limit)


def table_budget(device) -> int:
    """Byte cap for one table's t1 on `device`."""
    return device_memory_bytes(device) // TABLE_SHARE
