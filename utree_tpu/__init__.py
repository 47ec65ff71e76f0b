"""utree_tpu — a metagenomic k-mer profiler on JAX accelerators.

A from-scratch reimplementation of the capabilities of knights-lab/UTree
(reference: itree.c + xtree.c) with the search on a JAX device:

- Database build is sort-based (NumPy/host) instead of pointer-chasing BSTs
  (reference: itree.c:242-473), replaying the reference's rank-flexible
  label-fold semantics exactly (itree.c:268-307).
- The compressed search index is a flat, device-resident structure-of-arrays
  (prefix bin offsets + 40-bit suffixes split into int32 lanes + label ids),
  byte-compatible with the reference .ctr format (itree.c:1234-1315).
- Search runs as a jitted batched lookup (plain jax.numpy/lax) whose results
  are bit-identical to the reference's xtSuffixBS probe (itree.c:699-730).
- Scaling is jax.sharding over a device Mesh: data-parallel replicated-table
  mode and prefix-sharded table mode with collective routing, replacing the
  reference's single-node OpenMP (itree.c:1009, xtree.c:1012).
"""

import os as _os

# Persistent XLA compilation cache: the search step's first compile takes
# seconds to minutes per (batch, length-bucket) shape; caching it across
# processes makes later startups cache hits.  JAX_COMPILATION_CACHE_DIR, when
# set, is used as it is; otherwise the cache lives at a fixed path inside the
# checkout (CACHE_DIR, gitignored).  Disable with UTREE_TPU_NO_JIT_CACHE=1.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")
if (
    "JAX_COMPILATION_CACHE_DIR" not in _os.environ
    and not _os.environ.get("UTREE_TPU_NO_JIT_CACHE")
):
    _os.environ["JAX_COMPILATION_CACHE_DIR"] = CACHE_DIR
    _os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    import sys as _sys

    if "jax" in _sys.modules:  # jax read its env at import; set config directly
        _sys.modules["jax"].config.update("jax_compilation_cache_dir", CACHE_DIR)
        _sys.modules["jax"].config.update(
            "jax_persistent_cache_min_compile_time_secs", 1
        )

from utree_tpu.config import UTreeConfig
from utree_tpu.taxonomy import LabelTable

__version__ = "0.1.0"

__all__ = ["UTreeConfig", "LabelTable", "__version__"]
