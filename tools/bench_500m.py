"""Reference-flagship-scale demonstration: a 500M-entry index served by
routed displaced shards (the reference loads its ~1.2G-record
8.5GB CTR into one node's RAM, itree.c:733-828 / README.md:10).

Run on the virtual CPU mesh (no accelerator needed):

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/bench_500m.py [--kmers 500000000] [--shards 8]

Phases (each timed and printed):
  1. synthesize a 500M-kmer genome index (same generator as bench.py)
  2. ShardedDisplacedIndex.build — the sharded placement at full scale
  3. routed_displaced_search_step on the 8-device mesh for a read batch,
     asserted EQUAL to the single-table bsearch replay step (the always-
     correct path) on the same batch
  4. spill + memory accounting per shard

The per-shard device speed can be measured on an accelerator with
`BENCH_KMERS=62500000 BENCH_LOOKUP=displaced python bench.py` — one shard
of the 500M/8 layout is exactly that table geometry.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _host_packed_rows(index, cfg, reads_mat, lens, cap: int = 8) -> np.ndarray:
    """search_step_hist_packed's (B, cap+1) rows computed on host: per window
    the literal xtSuffixBS over the index's stored (suf_hi, suf_lo) lanes
    (itree.c:699-730), then the ascending-label packed histogram exactly as
    lookup.pack_hist lays it out (col j = (label+1)|count<<16, tail =
    min(nuniq, cap+1)|found<<5)."""
    from utree_tpu.encode import search_window_words

    suf_hi, suf_lo, ixarr, bix = (index.suf_hi, index.suf_lo, index.ix,
                                  index.bin_ix)
    nl = index.num_labels
    B = len(lens)
    rows = np.zeros((B, cap + 1), np.int32)
    for i in range(B):
        seq = reads_mat[i, : int(lens[i])].tobytes()
        words = search_window_words(seq, cfg.packsize, True)
        hits = []
        for wv in words.tolist():
            pre = wv >> cfg.ctr_suffix_bits
            q = wv & cfg.suffix_mask
            a, b = int(bix[pre]), int(bix[pre + 1])
            if a >= b:
                continue
            p, size = a, b - a - 1
            while size:
                h = size >> 1
                sv = (int(suf_hi[p + h + 1]) << 32) | int(suf_lo[p + h + 1])
                if sv <= q:
                    p += h + 1
                    size -= h + 1
                else:
                    size = h
            if ((int(suf_hi[p]) << 32) | int(suf_lo[p])) == q:
                v = int(np.uint32(ixarr[p]))
                if v < nl:
                    hits.append(v)
        if hits:
            cnt = np.bincount(np.asarray(hits, np.int64))
            nz = np.flatnonzero(cnt)
            found = len(hits)
            nuniq = len(nz)
            for j, lab in enumerate(nz[:cap]):
                rows[i, j] = np.int32((int(lab) + 1) | (int(cnt[lab]) << 16))
            rows[i, cap] = np.int32(min(nuniq, cap + 1) | (found << 5))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kmers", type=int, default=500_000_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--fast-lambda", action="store_true",
                    help="place at seed-bucket lambda ~2.2 instead of the "
                         "32MB-capped default ~4.5: ~2x faster placement, "
                         "bigger per-shard seed tables (both exact — the "
                         "probe reads the stored seeds)")
    ap.add_argument("--lam", type=float, default=None,
                    help="explicit seed-bucket lambda target (nseed = next "
                         "pow2 of kmers/lam); lower = sparser buckets = "
                         "faster placement + less spill, bigger seed table")
    ap.add_argument("--spill-budget", type=int, default=None,
                    help="override the cached-t3 spill budget (exactness is "
                         "unaffected; a big spill tail only costs probe "
                         "speed on a real device)")
    a = ap.parse_args()

    import jax

    from utree_tpu.config import UTreeConfig
    from utree_tpu.encode import sample_build_kmers
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.lookup import pack_reads_host
    from utree_tpu.memory import table_budget
    from utree_tpu.parallel import make_mesh
    from utree_tpu.parallel.routed import (ShardedDisplacedIndex,
                                           routed_displaced_search_step)

    cfg = UTreeConfig()
    rng = np.random.default_rng(0)
    num_labels = 4096

    t0 = time.perf_counter()
    genome_len = a.kmers + 31
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=genome_len).astype(np.uint8)
    words = sample_build_kmers(genome.tobytes(), cfg.packsize, 0)
    pos_labels = (np.arange(len(words), dtype=np.int64) * num_labels) // len(words)
    order = np.argsort(words, kind="stable")
    sw = words[order]
    keep = np.empty(len(sw), bool)
    keep[0] = True
    keep[1:] = sw[1:] != sw[:-1]
    sw = sw[keep]
    ixs = pos_labels[order][keep]
    del order, keep, words, pos_labels
    labels = [b"k__a;p__b;c__c;o__d;f__e;g__f;s__g%d" % i for i in range(num_labels)]
    index = DeviceIndexArrays.from_build(sw, ixs, labels, cfg)
    t_index = time.perf_counter() - t0
    nk = len(sw)
    del sw, ixs  # ~19GB at 1.2G; the index keeps its own narrow lanes
    print(f"index: {nk:,} kmers in {t_index:.1f}s", flush=True)

    t0 = time.perf_counter()
    nseed = None
    if a.lam is not None:
        nseed = max(4, 1 << int(np.ceil(np.log2(max(1, nk / a.lam)))))
    elif a.fast_lambda:
        nseed = max(4, 1 << int(np.ceil(np.log2(max(1, nk / 4)))))
    kw = {}
    if a.spill_budget is not None:
        kw["spill_budget"] = a.spill_budget
    sharded = ShardedDisplacedIndex.build(index, a.shards, nseed=nseed,
                                          t1_cap=table_budget(jax.devices()[0]), **kw)
    t_place = time.perf_counter() - t0
    spill = 0
    if sharded.t3.shape[0] > 8:
        cps = 4 if sharded.wide else 3
        spill = int(np.count_nonzero(
            sharded.t3.reshape(sharded.t3.shape[0], -1, cps)[:, :, 2]))
    t1_gb = sharded.t1.nbytes / (1 << 30)
    print(f"sharded displaced build: {t_place:.1f}s; t1 {t1_gb:.2f}GB total "
          f"({t1_gb / a.shards:.2f}GB/shard), seeds "
          f"{sharded.seeds.nbytes / (1 << 20) / a.shards:.1f}MB/shard, "
          f"spill {spill} ({100 * spill / sharded.num_entries:.4f}%)", flush=True)

    # reads sampled from the genome so probes really hit
    read_len = 150
    starts = rng.integers(0, genome_len - read_len, size=a.batch)
    gather = starts[:, None] + np.arange(read_len)[None, :]
    reads = genome[gather]
    lens = np.full(a.batch, read_len, np.int32)
    lmax = (read_len + 63) & ~63
    mat = np.zeros((a.batch, lmax), np.uint8)
    mat[:, :read_len] = reads
    packed, vbits, plens = pack_reads_host(mat, lens)

    mesh = make_mesh(data=1, table=a.shards)
    t0 = time.perf_counter()
    table = sharded.device_put(mesh)
    step = routed_displaced_search_step(
        mesh, sharded, do_rc=True, num_labels=index.num_labels, cap=8,
        bad_ix=cfg.bad_ix)
    n_entries = sharded.num_entries
    sharded.t1 = sharded.seeds = None  # free the host copies (~34GB at 1.2G)
    out = np.asarray(step(table, packed, vbits, plens))
    t_step = time.perf_counter() - t0
    assert (out[:, -1] == 0).all(), "capacity overflow at default factor"
    print(f"routed step on {a.shards}-device mesh: {t_step:.1f}s "
          "(incl. device_put + compile)", flush=True)

    # ground truth: the literal xtSuffixBS replay ON HOST over the index's
    # stored lanes, packed exactly like search_step_hist_packed's rows —
    # the device replay would copy the whole raw index onto the cpu backend
    # (another ~15GB at 1.2G), and the probe-replay equivalence of the two
    # forms is property-tested at small scale (tests/test_displaced.py)
    t0 = time.perf_counter()
    ref = _host_packed_rows(index, cfg, mat, lens, cap=8)
    print(f"host replay reference: {time.perf_counter() - t0:.1f}s", flush=True)
    assert np.array_equal(out[:, :-1], ref), "routed != replay"
    print(f"EQUAL: routed displaced ({a.shards} shards, "
          f"{n_entries:,} entries) == bsearch replay", flush=True)


if __name__ == "__main__":
    main()
