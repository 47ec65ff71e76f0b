"""Device-resident search index.

The reference search holds the CTR dump as one flat byte array in RAM and
binary-searches 7-byte records (itree.c:673-730).  The device layout is a
structure-of-arrays with the same information, every word held in 32-bit
lanes:

  bin_ix   int32[2^24+1]  prefix-bin start offsets (as stored in the .ctr,
                           quirks included — see formats.compute_bin_ix)
  suf_hi   int32[N]       bits 39..32 of each 40-bit suffix
  suf_lo   uint32[N]      bits 31..0
  ix       int32[N]       label id per record

`probe_iters` is the static trip count for the binary-search loop: the probe
range shrinks by at least half per step, so ceil(log2(max_range+1)) steps
suffice; it is computed from the actual bin table at load time so jit sees a
constant.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from utree_tpu.config import UTreeConfig
from utree_tpu.formats import CtrData, compute_bin_ix, read_ctr
from utree_tpu.taxonomy import count_semicolons


@dataclasses.dataclass
class DeviceIndexArrays:
    """Host-side (NumPy) staging of the device index; shard/put separately."""

    bin_ix: np.ndarray  # int32 [2^24+1] (int64 if N >= 2^31)
    suf_hi: np.ndarray  # int32 [N]
    suf_lo: np.ndarray  # uint32 [N]
    ix: np.ndarray  # int32 [N]
    strings: list[bytes]
    semicolons: np.ndarray
    probe_iters: int
    config: UTreeConfig
    # PACKSIZE=64 only: full 104-bit suffix lanes (hi = bits 103..64,
    # lo = 63..0).  The 64-mer device path is the canonical hash
    # (hash_index64); these lanes feed its builder and the host fallback.
    s_hi64: np.ndarray | None = None
    s_lo64: np.ndarray | None = None

    @property
    def num_records(self) -> int:
        if self.s_hi64 is not None:
            return len(self.s_hi64)
        return len(self.suf_lo)

    @property
    def num_labels(self) -> int:
        return len(self.strings)

    @classmethod
    def from_ctr(cls, ctr: CtrData | str, config: UTreeConfig = UTreeConfig()) -> "DeviceIndexArrays":
        if isinstance(ctr, str):
            ctr = read_ctr(ctr, config)
        return cls._from_parts(ctr.bin_ix, ctr.suffixes, ctr.ixs, ctr.labels, config)

    @classmethod
    def from_build(cls, words: np.ndarray, ixs: np.ndarray, labels: list[bytes],
                   config: UTreeConfig = UTreeConfig()) -> "DeviceIndexArrays":
        """Straight from a BuildResult, skipping the .ubt/.ctr round-trip
        (bin table still uses the reference compressor's algorithm so lookups
        agree with a reference binary reading the equivalent .ctr)."""
        from utree_tpu.encode import W128

        bin_ix = compute_bin_ix(words, config.word_bits, config.ctr_prefix_bits)
        if words.dtype == W128:  # 104-bit suffix = (hi & 2^40-1, lo)
            suffixes = np.zeros(len(words), dtype=W128)
            suffixes["hi"] = words["hi"] & np.uint64((1 << 40) - 1)
            suffixes["lo"] = words["lo"]
        else:
            suffixes = np.asarray(words, dtype=np.uint64) & np.uint64(config.suffix_mask)
        return cls._from_parts(bin_ix, suffixes, np.asarray(ixs, np.int64), list(labels), config)

    @classmethod
    def _from_parts(cls, bin_ix, suffixes, ixs, labels, config) -> "DeviceIndexArrays":
        if suffixes.dtype.names:  # W128 (PACKSIZE=64)
            return cls._from_parts64(bin_ix, suffixes, ixs, labels, config)
        n = len(suffixes)
        # pad with one sentinel record so clamped probes stay in bounds
        suf_hi = np.zeros(n + 1, dtype=np.int32)
        suf_lo = np.zeros(n + 1, dtype=np.uint32)
        ix_arr = np.full(n + 1, config.bad_ix, dtype=np.int32)
        suf_hi[:n] = (suffixes >> np.uint64(32)).astype(np.int32)
        suf_lo[:n] = (suffixes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ix_arr[:n] = ixs.astype(np.int32)
        ranges = np.diff(bin_ix)
        max_range = int(ranges.max()) if len(ranges) else 0
        probe_iters = max(1, math.ceil(math.log2(max_range + 1))) if max_range > 0 else 1
        dtype = np.int32 if n < 2**31 else np.int64
        semis = np.array([count_semicolons(s) for s in labels], dtype=np.uint8)
        return cls(
            bin_ix=bin_ix.astype(dtype),
            suf_hi=suf_hi,
            suf_lo=suf_lo,
            ix=ix_arr,
            strings=list(labels),
            semicolons=semis,
            probe_iters=probe_iters,
            config=config,
        )

    @classmethod
    def _from_parts64(cls, bin_ix, suffixes, ixs, labels, config) -> "DeviceIndexArrays":
        n = len(suffixes)
        ranges = np.diff(bin_ix)
        max_range = int(ranges.max()) if len(ranges) else 0
        probe_iters = max(1, math.ceil(math.log2(max_range + 1))) if max_range > 0 else 1
        semis = np.array([count_semicolons(s) for s in labels], dtype=np.uint8)
        return cls(
            bin_ix=bin_ix.astype(np.int64),
            suf_hi=np.zeros(0, np.int32),  # 40-bit lanes do not apply at k=64
            suf_lo=np.zeros(0, np.uint32),
            ix=ixs.astype(np.int64),
            strings=list(labels),
            semicolons=semis,
            probe_iters=probe_iters,
            config=config,
            s_hi64=suffixes["hi"].astype(np.uint64),
            s_lo64=suffixes["lo"].astype(np.uint64),
        )

    def host_index(self):
        """HostIndex view over the same records (exact host fallback path)."""
        from utree_tpu.search_host import HostIndex

        if self.s_hi64 is not None:
            return HostIndex(self.bin_ix.astype(np.int64), self.s_hi64, self.s_lo64,
                             self.ix.astype(np.int64), self.strings, self.semicolons,
                             self.config)
        n = self.num_records
        return HostIndex(
            self.bin_ix.astype(np.int64),
            np.zeros(n, np.uint64),
            (self.suf_hi[:n].astype(np.uint64) << np.uint64(32))
            | self.suf_lo[:n].astype(np.uint64),
            self.ix[:n].astype(np.int64),
            self.strings,
            self.semicolons,
            self.config,
        )

    def device_put(self, sharding=None):
        """Move the table arrays to device; returns a dict pytree."""
        import jax

        arrs = {"bin_ix": self.bin_ix, "suf_hi": self.suf_hi, "suf_lo": self.suf_lo, "ix": self.ix}
        if sharding is None:
            return {k: jax.device_put(v) for k, v in arrs.items()}
        return {k: jax.device_put(v, sharding) for k, v in arrs.items()}
