"""Sharded search: the distributed modes of the framework.

The reference is one process on one node (SURVEY.md §2.3); these are the
device equivalents over a jax.sharding Mesh:

  replicated_search_step   DP: reads sharded over `data`, table replicated in
                           every device's memory (the L4 ~500MB regime).  XLA's
                           auto-SPMD partitions the elementwise/gather work;
                           no collectives needed until sample-level tallies.

  sharded_search_step      TP/EP: the table is partitioned by 24-bit prefix
                           range over `table` (k-mers -> prefix shards is the
                           same shape as tokens -> experts).  Every shard
                           probes its local slice for the whole row batch and
                           the per-query results merge with a psum over
                           `table` — exact, deterministic, ICI-friendly.
                           (An all_to_all capacity-routed variant is the perf
                           upgrade; this mode is the always-correct baseline.)

  long_read_histogram      SP: one long read's window positions sharded
                           across all devices with a (k-1)-base halo — the
                           context-parallel analog (SURVEY.md §5.7).  The
                           aufbau vote only needs the per-label histogram,
                           which is an exact associative psum merge.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.lookup import _suffix_le, window_lanes


# --------------------------------------------------------------------------
# Replicated-table DP mode
# --------------------------------------------------------------------------

def replicated_search_step(mesh: Mesh, index: DeviceIndexArrays, do_rc: bool = False):
    """Returns jitted (table, reads_u8, lengths) -> (B, W) ix, with reads
    sharded over the `data` axis and the table replicated."""
    from utree_tpu.lookup import search_step

    cfg = index.config
    repl = NamedSharding(mesh, P())
    data_sharding = NamedSharding(mesh, P("data"))

    fn = functools.partial(
        search_step, k=cfg.packsize, do_rc=do_rc,
        probe_iters=index.probe_iters, bad_ix=cfg.bad_ix,
        num_labels=index.num_labels,
    )
    # `repl` is a pytree prefix: it replicates whatever table dict the caller
    # passes (bsearch arrays OR canonical {c1,c2,c3} tables alike).
    return jax.jit(
        fn,
        in_shardings=(repl, data_sharding, data_sharding),
        out_shardings=data_sharding,
    )


# --------------------------------------------------------------------------
# Prefix-sharded table (TP/EP) mode
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedIndex:
    """Per-table-shard slices of the index, stacked on a leading shard axis.

    Shard s owns prefixes [s*2^24/S, (s+1)*2^24/S); its record slice is
    [bin_ix[lo], bin_ix[hi]) of the global arrays (bin offsets are global and
    nondecreasing, so every bin's probe range is contained in its shard —
    the compressor's quirky merged bins included)."""

    bin_ix: np.ndarray  # int32 (S, bins_per_shard+1), local offsets
    suf_hi: np.ndarray  # int32 (S, max_local+1)
    suf_lo: np.ndarray  # uint32 (S, max_local+1)
    ix: np.ndarray  # int32 (S, max_local+1)
    prefix_lo: np.ndarray  # int32 (S,), first owned prefix
    num_shards: int
    probe_iters: int
    config: UTreeConfig

    @classmethod
    def from_index(cls, index: DeviceIndexArrays, num_shards: int) -> "ShardedIndex":
        cfg = index.config
        num_prefixes = 1 << cfg.ctr_prefix_bits
        if num_prefixes % num_shards:
            raise ValueError("num_shards must divide 2^24")
        per = num_prefixes // num_shards
        gbin = index.bin_ix.astype(np.int64)
        lows = np.arange(num_shards) * per
        rec_lo = gbin[lows]
        rec_hi = gbin[lows + per]
        max_local = int((rec_hi - rec_lo).max()) if num_shards else 0
        s_bin = np.zeros((num_shards, per + 1), dtype=np.int32)
        s_hi = np.zeros((num_shards, max_local + 1), dtype=np.int32)
        s_lo = np.zeros((num_shards, max_local + 1), dtype=np.uint32)
        s_ix = np.full((num_shards, max_local + 1), cfg.bad_ix, dtype=np.int32)
        for s in range(num_shards):
            a, b = int(rec_lo[s]), int(rec_hi[s])
            s_bin[s] = (gbin[lows[s] : lows[s] + per + 1] - a).astype(np.int32)
            s_hi[s, : b - a] = index.suf_hi[a:b]
            s_lo[s, : b - a] = index.suf_lo[a:b]
            s_ix[s, : b - a] = index.ix[a:b]
        return cls(
            bin_ix=s_bin, suf_hi=s_hi, suf_lo=s_lo, ix=s_ix,
            prefix_lo=lows.astype(np.int32), num_shards=num_shards,
            probe_iters=index.probe_iters, config=cfg,
        )

    def device_put(self, mesh: Mesh):
        shard = NamedSharding(mesh, P("table"))
        return {
            "bin_ix": jax.device_put(self.bin_ix, shard),
            "suf_hi": jax.device_put(self.suf_hi, shard),
            "suf_lo": jax.device_put(self.suf_lo, shard),
            "ix": jax.device_put(self.ix, shard),
            "prefix_lo": jax.device_put(self.prefix_lo, shard),
        }


def _local_lookup(bin_ix, suf_hi, suf_lo, ix_arr, prefix_lo, num_local_bins,
                  qpre, qhi, qlo, valid, probe_iters, bad_ix):
    """xtSuffixBS probe replay against one table shard; out-of-range prefixes
    miss.  Identical probe sequence to lookup.lookup_kmers."""
    n = suf_hi.shape[0] - 1
    local_pre = qpre - prefix_lo
    in_range = (local_pre >= 0) & (local_pre < num_local_bins) & valid
    lp = jnp.where(in_range, local_pre, 0)
    start = bin_ix[lp].astype(jnp.int32)
    end = bin_ix[lp + 1].astype(jnp.int32)
    empty = (start >= end) | ~in_range
    p = jnp.where(empty, 0, start)
    size = jnp.where(empty, 0, end - start - 1)

    def body(_, carry):
        p, size = carry
        active = size > 0
        w = size >> 1
        probe = jnp.minimum(p + w + 1, n)
        le = active & _suffix_le(suf_hi[probe], suf_lo[probe], qhi, qlo)
        p = jnp.where(le, p + w + 1, p)
        size = jnp.where(active, jnp.where(le, size - w - 1, w), size)
        return p, size

    p, _ = jax.lax.fori_loop(0, probe_iters, body, (p, size))
    p = jnp.minimum(p, n)
    found = (~empty) & (suf_hi[p] == qhi) & (suf_lo[p] == qlo)
    return jnp.where(found, ix_arr[p], bad_ix), found


def sharded_search_step(mesh: Mesh, sharded: ShardedIndex, do_rc: bool = False):
    """Returns jitted (table, reads_u8, lengths) -> (B, W) ix.

    reads are sharded over `data`; each table shard probes the whole row
    batch against its prefix range and the one-hot results merge with psum
    over `table` (every k-mer is found on at most one shard)."""
    cfg = sharded.config
    k = cfg.packsize
    probe_iters = sharded.probe_iters
    bad_ix = cfg.bad_ix
    num_local_bins = sharded.bin_ix.shape[1] - 1

    def step(table, reads_u8, lengths):
        def shard_fn(t_bin, t_hi, t_lo, t_ix, t_plo, reads, lens):
            qpre, qhi, qlo, valid = window_lanes(reads, lens, k, do_rc)
            ix, found = _local_lookup(
                t_bin[0], t_hi[0], t_lo[0], t_ix[0], t_plo[0], num_local_bins,
                qpre, qhi, qlo, valid, probe_iters, bad_ix,
            )
            ix_sum = jax.lax.psum(jnp.where(found, ix, 0), "table")
            found_any = jax.lax.psum(found.astype(jnp.int32), "table") > 0
            return jnp.where(found_any, ix_sum, bad_ix)

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("table"), P("table"), P("table"), P("table"), P("table"),
                      P("data"), P("data")),
            out_specs=P("data"),
        )(table["bin_ix"], table["suf_hi"], table["suf_lo"], table["ix"],
          table["prefix_lo"], reads_u8, lengths)

    return jax.jit(step)


# --------------------------------------------------------------------------
# Sequence-parallel long reads (SP)
# --------------------------------------------------------------------------

def long_read_histogram(mesh: Mesh, index: DeviceIndexArrays, num_labels: int,
                        do_rc: bool = False):
    """Returns (table, chunks_u8, chunk_lens) -> per-label hit histogram.

    The caller splits one long read (up to 16Mb, itree.c:836) into D
    overlapping chunks of equal size with a (k-1)-base halo (position
    sharding; the halo replaces a ring exchange).  Each device extracts and
    looks up its windows; the per-label histogram psum-merges — exactly the
    data the aufbau vote consumes, so sequence parallelism is exact."""
    cfg = index.config
    k = cfg.packsize
    probe_iters = index.probe_iters
    bad_ix = cfg.bad_ix

    def step(table, chunks_u8, chunk_lens):
        def shard_fn(reads, lens):
            qpre, qhi, qlo, valid = window_lanes(reads, lens, k, do_rc)
            from utree_tpu.lookup import lookup_kmers

            ix = lookup_kmers(table, qpre, qhi, qlo, valid, probe_iters, bad_ix)
            hit = ix < num_labels
            slot = jnp.where(hit, ix, num_labels)
            hist = jnp.zeros((num_labels + 1,), jnp.int32).at[slot.reshape(-1)].add(1)
            return jax.lax.psum(hist[:num_labels], ("data", "table"))

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(("data", "table")), P(("data", "table"))),
            out_specs=P(),
        )(chunks_u8, chunk_lens)

    return jax.jit(step)


def split_long_read(seq: bytes, num_chunks: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side position sharding of one read into overlapping chunks.

    Chunk d covers window starts [d*C, (d+1)*C) so it needs bases
    [d*C, (d+1)*C + k - 1).  Returns (chunks (D, C+k-1) uint8, lens (D,))."""
    n = len(seq)
    w = max(0, n - k + 1)
    c = -(-max(w, 1) // num_chunks)
    width = c + k - 1
    chunks = np.zeros((num_chunks, width), dtype=np.uint8)
    lens = np.zeros(num_chunks, dtype=np.int32)
    arr = np.frombuffer(seq, dtype=np.uint8)
    for d in range(num_chunks):
        a = d * c
        b = min(n, a + width)
        if a < n:
            chunks[d, : b - a] = arr[a:b]
            lens[d] = b - a
    return chunks, lens
