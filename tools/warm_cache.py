"""Pre-compute bench tier tables on the host (JAX_PLATFORMS=cpu).

The 150M displaced placement costs 10-25 min of host CPU; warming the
checkout's .bench_cache lets a later bench.py run on the accelerator measure
the search, not the placement.  Usage:

    JAX_PLATFORMS=cpu python tools/warm_cache.py [num_kmers ...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench
import jax

from utree_tpu.memory import table_budget


def main():
    tiers = [int(x) for x in sys.argv[1:]] or [150_000_000]
    num_labels = int(os.environ.get("BENCH_LABELS", 4096))
    cache_dir = os.environ.get("BENCH_TABLE_CACHE", bench.CACHE_DIR)
    for nk in tiers:
        t0 = time.perf_counter()
        index, *_ = bench.make_tier_index(nk, num_labels)
        bench.log(f"warm: tier index {nk} built in {time.perf_counter()-t0:.1f}s "
                  f"({index.num_records} records)")
        if nk >= 80_000_000:
            bench.load_or_build_displaced(index, nk, num_labels, cache_dir,
                                          table_budget(jax.devices()[0]))
        else:
            bench.log(f"warm: tier {nk} uses the canonical ladder (no cache)")


if __name__ == "__main__":
    main()
