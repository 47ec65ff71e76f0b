"""Routed (all_to_all) sharded canonical-hash search — BASELINE config 5.

The reference keeps the whole CTR in one node's RAM (itree.c:733-828); a real
L2 database (~1G k-mers) exceeds one chip's HBM once hashed, so the big table
must shard.  `parallel.sharded.sharded_search_step` is the always-correct
baseline (every shard probes the whole batch, psum merge) but does S× the
probe work and only shards the slow bsearch layout.  This module shards the
FAST layout and routes, MoE-style (k-mers -> bucket shards is the same shape
as tokens -> experts, SURVEY.md §2.3):

  - t1 (the big table) is partitioned by bucket range over the mesh axis:
    owner = bucket >> log2(b1/S), local row = bucket & (b1/S - 1).
  - t2 (the spill table, <= ~3MB by construction) is replicated: it is
    cache-resident and sharding it would route traffic worth more than it.
  - Each chip encodes its own read shard, routes (local_bucket, key_lo,
    key_hi) to owners with all_to_all over fixed-capacity slots, probes its
    local t1 slice for what it receives, and routes the packed dual values
    back.  The t2 probe, value decode, and per-read histogram stay local to
    the data shard, so the output is data-sharded exactly like the
    single-chip step's.

EXACTNESS: routing only moves WHERE a bucket row is gathered; the probe math
and the histogram are the single-device functions (lookup.canonical_keys /
probe_rows / decode_canonical_vals / pack_hist).  Capacity overflow (a batch
whose k-mers hash so unevenly that one (sender, owner) pair exceeds its
slots) is detected and reported as a flag in the output's last column; the
caller redispatches such batches through the broadcast fallback
(`routed_fallback_step`, also exact).  At capacity factor 1.3 over the
uniform hash the flag fires with negligible probability — but the contract
stays exact, never "probably fits".
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from utree_tpu.hash_index import CanonicalHashArrays
from utree_tpu.lookup import (
    base_codes_packed,
    canonical_bucket3,
    canonical_buckets,
    canonical_keys,
    decode_canonical_vals,
    decode_canonical_wide,
    extract_windows,
    pack_hist,
    probe_rows,
    probe_rows_wide,
)


@dataclasses.dataclass
class ShardedCanonicalIndex:
    """Canonical hash table split for the routed mode: t1 stacked on a
    leading shard axis (bucket-range partition), t2 whole (replicated)."""

    t1: np.ndarray  # int32 (S, b1/S, slots*cps)
    t2: np.ndarray  # int32 (b2, slots2*cps)
    t3: np.ndarray  # int32 (b3, slots3*cps); 8-row sentinel = absent
    num_shards: int
    b1: int  # global t1 bucket count
    slots: int
    slots2: int
    slots3: int
    wide: bool = False  # IXTYPE=u32 layout: 4-col slots, (va, vb) value pair

    @classmethod
    def from_canonical(cls, c: CanonicalHashArrays, num_shards: int) -> "ShardedCanonicalIndex":
        wide = c.t1.shape[1] == c.slots * 4
        b1 = c.t1.shape[0]
        if b1 % num_shards:
            raise ValueError("num_shards must divide the t1 bucket count")
        per = b1 // num_shards
        return cls(
            t1=np.ascontiguousarray(c.t1.reshape(num_shards, per, c.t1.shape[1])),
            t2=c.t2, t3=c.t3, num_shards=num_shards, b1=b1,
            slots=c.slots, slots2=c.slots2, slots3=c.slots3, wide=wide,
        )

    def device_put(self, mesh: Mesh, axis: str = "table"):
        return {
            "t1": jax.device_put(self.t1, NamedSharding(mesh, P(axis))),
            "t2": jax.device_put(self.t2, NamedSharding(mesh, P())),
            "t3": jax.device_put(self.t3, NamedSharding(mesh, P())),
        }


def _tail_probe(val, t2, t3, bkt2, key_lo, key_hi, valid, slots2, slots3):
    """Replicated (local) t2/t3 probes shared by both sharded steps."""
    if t2.shape[0] > 8:
        val = jnp.where(val != 0, val, probe_rows(t2[bkt2], key_lo, key_hi, slots2))
    if t3.shape[0] > 8:
        bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
        val = jnp.where(val != 0, val, probe_rows(t3[bkt3], key_lo, key_hi, slots3))
    return val


def _tail_probe_wide(va, vb, t2, t3, bkt2, key_lo, key_hi, valid, slots2, slots3):
    """Wide-entry twin of _tail_probe: a miss is both orientation lanes 0."""
    if t2.shape[0] > 8:
        va2, vb2 = probe_rows_wide(t2[bkt2], key_lo, key_hi, slots2)
        miss = (va | vb) == 0
        va = jnp.where(miss, va2, va)
        vb = jnp.where(miss, vb2, vb)
    if t3.shape[0] > 8:
        bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
        va3, vb3 = probe_rows_wide(t3[bkt3], key_lo, key_hi, slots3)
        miss = (va | vb) == 0
        va = jnp.where(miss, va3, va)
        vb = jnp.where(miss, vb3, vb)
    return va, vb


def _routed_probe_t1(t1_local, bkt1, valid, key_lo, key_hi, *, axis: str,
                     num_shards: int, per_shard: int, slots: int,
                     capacity: int, wide: bool = False):
    """Route (bucket, keys) to owners over `axis`, probe, route values back.

    All inputs are flattened (P,) position lanes on the local data shard.
    Returns (val (P,) int32 [narrow] or (va, vb) pair [wide], overflow bool
    scalar) — the reply lanes just widen by one for IXTYPE=u32 entries."""
    owner = bkt1 // per_shard  # bucket ranges are contiguous row blocks
    local_bkt = bkt1 - owner * per_shard

    # rank of each position within its destination (valid positions only:
    # invalid windows never route — their value is 0 by construction)
    rank = jnp.zeros_like(bkt1)
    for s in range(num_shards):
        m = valid & (owner == s)
        r = jnp.cumsum(m.astype(jnp.int32)) - 1
        rank = jnp.where(m, r, rank)
    routable = valid & (rank < capacity)
    overflow = jnp.any(valid & (rank >= capacity))

    # scatter payloads into fixed (S, C) slots.  Non-routable positions are
    # aimed at slot `capacity` (out of bounds) so mode="drop" discards them
    # and every surviving (owner, rank) pair is unique — a deterministic
    # scatter.  Unwritten slots keep bucket 0 / key 0; their replies are
    # never read back.
    r = jnp.where(routable, rank, capacity)
    send = jnp.zeros((num_shards, capacity, 3), jnp.int32)
    payload = jnp.stack([local_bkt, key_lo, key_hi], axis=-1)
    send = send.at[owner, r].set(payload, mode="drop", unique_indices=True)

    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0, tiled=False)
    rows = t1_local[recv[:, :, 0]]
    o = jnp.where(routable, owner, 0)
    rr = jnp.where(routable, rank, 0)
    if wide:
        va, vb = probe_rows_wide(rows, recv[:, :, 1], recv[:, :, 2], slots)
        vals = jnp.stack([va, vb], axis=-1)
        reply = jax.lax.all_to_all(vals, axis, split_axis=0, concat_axis=0,
                                   tiled=False)
        got = reply[o, rr]
        return (jnp.where(routable, got[..., 0], 0),
                jnp.where(routable, got[..., 1], 0)), overflow
    vals = probe_rows(rows, recv[:, :, 1], recv[:, :, 2], slots)
    reply = jax.lax.all_to_all(vals, axis, split_axis=0, concat_axis=0, tiled=False)
    val = jnp.where(routable, reply[o, rr], 0)
    return val, overflow


def routed_canonical_search_step(mesh: Mesh, sharded: ShardedCanonicalIndex, *,
                                 do_rc: bool, num_labels: int, cap: int,
                                 bad_ix: int, capacity_factor: float = 1.3,
                                 capacity: int | None = None,
                                 axis: str = "table", data_axis: str = "data"):
    """jitted (table, packed, vbits, lens) -> (B, cap+2) int32: the packed
    histograms of search_step_hist_packed plus a final `overflow` column
    (identical across rows; nonzero means redispatch via the fallback)."""
    S = sharded.num_shards
    per_shard = sharded.b1 // S
    b2 = sharded.t2.shape[0]
    slots, slots2 = sharded.slots, sharded.slots2
    bad_ix = min(bad_ix, 0x7FFFFFFF)

    def step(table, packed, vbits, lens):
        def shard_fn(t1_local, t2, t3, packed, vbits, lens):
            codes = base_codes_packed(packed, vbits, lens)
            qpre, qhi, qlo, valid = extract_windows(codes, 32)
            b_loc, w = qpre.shape
            key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
            bkt1, bkt2 = canonical_buckets(key_lo, key_hi, valid, sharded.b1, b2)

            p = b_loc * w
            c = capacity if capacity is not None else max(
                128, int(np.ceil(p / S * capacity_factor / 128)) * 128)
            val, overflow = _routed_probe_t1(
                t1_local[0], bkt1.reshape(p), valid.reshape(p),
                key_lo.reshape(p), key_hi.reshape(p),
                axis=axis, num_shards=S, per_shard=per_shard, slots=slots,
                capacity=c, wide=sharded.wide,
            )
            if sharded.wide:
                va = val[0].reshape(b_loc, w)
                vb = val[1].reshape(b_loc, w)
                va, vb = _tail_probe_wide(va, vb, t2, t3, bkt2, key_lo, key_hi,
                                          valid, slots2, sharded.slots3)
                r = decode_canonical_wide(va, vb, valid, fwd_le, bad_ix, do_rc)
            else:
                val = val.reshape(b_loc, w)
                val = _tail_probe(val, t2, t3, bkt2, key_lo, key_hi, valid,
                                  slots2, sharded.slots3)
                r = decode_canonical_vals(val, valid, fwd_le, bad_ix, do_rc)
            ix = jnp.concatenate(r, axis=1) if do_rc else r
            out = pack_hist(ix, num_labels, cap)
            # overflow is identical on every chip after this psum
            oflo = jax.lax.psum(overflow.astype(jnp.int32), (data_axis, axis))
            return jnp.concatenate(
                [out, jnp.broadcast_to(oflo, (b_loc, 1))], axis=1)

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis), P(), P(), P((data_axis, axis)),
                      P((data_axis, axis)), P((data_axis, axis))),
            out_specs=P((data_axis, axis)),
        )(table["t1"], table["t2"], table["t3"], packed, vbits, lens)

    return jax.jit(step)


def routed_fallback_step(mesh: Mesh, sharded: ShardedCanonicalIndex, *,
                         do_rc: bool, num_labels: int, cap: int, bad_ix: int,
                         axis: str = "table", data_axis: str = "data"):
    """Exact fallback for capacity-overflow batches: every chip all_gathers
    the batch, probes its own t1 range for everything (out-of-range buckets
    clamp to a single cached row), and the values psum-merge (each bucket has
    exactly one owner, misses contribute 0).  Output identical to the routed
    step minus the overflow column."""
    S = sharded.num_shards
    per_shard = sharded.b1 // S
    b2 = sharded.t2.shape[0]
    slots, slots2 = sharded.slots, sharded.slots2
    bad_ix = min(bad_ix, 0x7FFFFFFF)

    def step(table, packed, vbits, lens):
        def shard_fn(t1_local, t2, t3, packed, vbits, lens):
            codes = base_codes_packed(packed, vbits, lens)
            qpre, qhi, qlo, valid = extract_windows(codes, 32)
            key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
            bkt1, bkt2 = canonical_buckets(key_lo, key_hi, valid, sharded.b1, b2)
            my = jax.lax.axis_index(axis)
            owner = bkt1 // per_shard
            mine = owner == my
            local = jnp.where(mine, bkt1 - my * per_shard, 0)
            rows = t1_local[0][local]
            if sharded.wide:
                va, vb = probe_rows_wide(rows, key_lo, key_hi, slots)
                va = jax.lax.psum(jnp.where(mine, va, 0), axis)
                vb = jax.lax.psum(jnp.where(mine, vb, 0), axis)
                va, vb = _tail_probe_wide(va, vb, t2, t3, bkt2, key_lo, key_hi,
                                          valid, slots2, sharded.slots3)
                r = decode_canonical_wide(va, vb, valid, fwd_le, bad_ix, do_rc)
            else:
                v = probe_rows(rows, key_lo, key_hi, slots)
                v = jnp.where(mine, v, 0)
                val = jax.lax.psum(v, axis)
                val = _tail_probe(val, t2, t3, bkt2, key_lo, key_hi, valid,
                                  slots2, sharded.slots3)
                r = decode_canonical_vals(val, valid, fwd_le, bad_ix, do_rc)
            ix = jnp.concatenate(r, axis=1) if do_rc else r
            return pack_hist(ix, num_labels, cap)

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis), P(), P(), P(data_axis), P(data_axis), P(data_axis)),
            out_specs=P(data_axis),
        )(table["t1"], table["t2"], table["t3"], packed, vbits, lens)

    return jax.jit(step)


# --------------------------------------------------------------------------
# Routed SEEDED-DISPLACEMENT shards: the bigger-than-one-device regime.
#
# One device's displaced table is bounded by its 64MB seed-table cap (~322M
# entries) and by the device memory budget for t1; the reference's real L2
# CTR is ~1.2G records in one node's RAM (itree.c:733-828).  Sharding the
# displaced layout by seed-bucket range keeps every shard's seed table small
# and its t1 rows 24B, so the routed probe costs one all_to_all round-trip
# plus the local row gather.  Spill merges into ONE small replicated t3
# probed on the data side (like the canonical mode's t2/t3), so shard t1 /
# seed arrays stack cleanly on the mesh axis.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedDisplacedIndex:
    t1: np.ndarray      # int32 (S, rows_local, 2*cps)
    seeds: np.ndarray   # int32 (S, per_seed//4) packed u8 seed words
    t3: np.ndarray      # int32 (b3, slots3*cps): merged global spill, replicated
    num_shards: int
    nseed: int          # GLOBAL seed count (pow2, = S * per-shard count)
    slots3: int
    wide: bool
    num_entries: int

    @classmethod
    def build(cls, index, num_shards: int, *, load: float | None = None,
              spill_budget: int | None = None,
              t1_cap: int,
              workers: int | None = None,
              nseed: int | None = None) -> "ShardedDisplacedIndex":
        from utree_tpu.hash_index import (_DISP_LOAD, _DISP_SPILL_BUDGET,
                                          _canonical_groups,
                                          build_spill_t3, displaced_buckets_np,
                                          displaced_nseed, place_displaced_core)

        load = _DISP_LOAD if load is None else load
        spill_budget = _DISP_SPILL_BUDGET if spill_budget is None else spill_budget
        key_lo, key_hi, vals, cpre, chi, clo, ng = _canonical_groups(index)
        S = num_shards
        # nseed override: any pow2 is exact (the probe reads the stored
        # seeds), so callers may trade seed-table bytes for placement speed
        # (lambda ~2.2 places ~2x faster than the 32MB-capped default's ~4.5)
        if nseed is None:
            nseed = displaced_nseed(ng)
        while nseed % S:  # S must divide the pow2 seed count
            nseed *= 2
        bucket = displaced_buckets_np(cpre, chi, clo, nseed)
        per_seed = nseed // S
        owner = bucket // per_seed
        order = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=S)
        del owner  # ~10GB at the 1.2G tier; the partition is (order, bounds)
        bounds = np.zeros(S + 1, np.int64)
        np.cumsum(counts, out=bounds[1:])
        nslots = max(int(int(counts.max()) / load) & ~1, 64)

        # shards place CONCURRENTLY: the radix partition is the parallel
        # surface (serial placement of 8x150M shards is ~8x10min of host
        # CPU).  Threads, not processes: the placement is dominated by
        # large vectorized numpy kernels (sorts, bincounts, mixes) that
        # release the GIL, and threads share the key arrays zero-copy where
        # worker processes would pickle multi-GB t1 slabs back through pipes.
        # Each shard's placement touches only its own idx_s slice, so the
        # only shared state is read-only input.
        def place_shard(s: int):
            idx_s = order[bounds[s] : bounds[s + 1]]
            t1_s, seeds_s, spilled_s = place_displaced_core(
                key_lo[idx_s], key_hi[idx_s], vals[idx_s],
                cpre[idx_s], chi[idx_s], clo[idx_s], len(idx_s),
                load=load, spill_budget=spill_budget,
                bucket=bucket[idx_s] - s * per_seed, nseed=per_seed,
                t1_cap=t1_cap, nslots_force=nslots)
            return t1_s, seeds_s, idx_s[spilled_s]

        if workers is None:
            workers = min(S, os.cpu_count() or 1)
        # assemble incrementally instead of np.stack-ing a list at the end:
        # holding every per-shard slab AND the stacked copy doubles t1's
        # footprint (~68GB at the 1.2G flagship tier)
        t1_all = seeds_all = None
        spills: list = [None] * S

        def consume(s: int, res) -> None:
            nonlocal t1_all, seeds_all
            t1_s, seeds_s, spilled_s = res
            if t1_all is None:
                t1_all = np.empty((S,) + t1_s.shape, t1_s.dtype)
                seeds_all = np.empty((S,) + seeds_s.shape, seeds_s.dtype)
            t1_all[s] = t1_s
            seeds_all[s] = seeds_s
            spills[s] = spilled_s

        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor, as_completed

            with ThreadPoolExecutor(max_workers=workers) as pool:
                futs = {pool.submit(place_shard, s): s for s in range(S)}
                for f in as_completed(futs):
                    consume(futs[f], f.result())
        else:
            for s in range(S):
                consume(s, place_shard(s))
        spilled = np.concatenate(spills) if spills else np.zeros(0, np.int64)
        if len(spilled) > spill_budget:
            raise ValueError(
                f"sharded displaced spill {len(spilled)} exceeds the cached budget")
        t3 = build_spill_t3(spilled, key_lo, key_hi, vals, cpre, chi, clo,
                            t1_cap=t1_cap)
        return cls(t1=t1_all, seeds=seeds_all, t3=t3,
                   num_shards=S, nseed=nseed,
                   slots3=t3.shape[1] // (2 + vals.shape[1]),
                   wide=vals.shape[1] == 2, num_entries=ng)

    def device_put(self, mesh: Mesh, axis: str = "table"):
        return {
            "t1": jax.device_put(self.t1, NamedSharding(mesh, P(axis))),
            "ds": jax.device_put(self.seeds, NamedSharding(mesh, P(axis))),
            "t3": jax.device_put(self.t3, NamedSharding(mesh, P())),
        }


def _displaced_local_probe(t1_local, seeds_local, local_bkt, key_lo, key_hi,
                           wide: bool):
    """Owner-side displaced probe on routed lanes: seed gather -> slot mix ->
    one 2-slot row compare.  Lanes aimed at unwritten capacity slots probe
    bucket 0 / key 0 harmlessly (their replies are never read back)."""
    from utree_tpu.lookup import displaced_seed_jnp, displaced_slot_jnp

    nslots = 2 * t1_local.shape[0]
    seed = displaced_seed_jnp(seeds_local, local_bkt)
    ones = jnp.ones_like(local_bkt, bool)
    slot = displaced_slot_jnp(key_lo, key_hi, seed, ones, nslots)
    rows = t1_local[slot >> 1]
    if wide:
        return probe_rows_wide(rows, key_lo, key_hi, 2)
    return probe_rows(rows, key_lo, key_hi, 2)


def _routed_probe_displaced(t1_local, seeds_local, gbkt, valid, key_lo, key_hi,
                            *, axis: str, num_shards: int, per_seed: int,
                            capacity: int, wide: bool):
    """Displaced twin of _routed_probe_t1: route (local seed-bucket, keys) to
    the owner shard, probe its t1 slice there, route values back."""
    owner = gbkt // per_seed
    local_bkt = gbkt - owner * per_seed

    rank = jnp.zeros_like(gbkt)
    for s in range(num_shards):
        m = valid & (owner == s)
        r = jnp.cumsum(m.astype(jnp.int32)) - 1
        rank = jnp.where(m, r, rank)
    routable = valid & (rank < capacity)
    overflow = jnp.any(valid & (rank >= capacity))

    r = jnp.where(routable, rank, capacity)
    send = jnp.zeros((num_shards, capacity, 3), jnp.int32)
    payload = jnp.stack([local_bkt, key_lo, key_hi], axis=-1)
    send = send.at[owner, r].set(payload, mode="drop", unique_indices=True)

    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0, tiled=False)
    o = jnp.where(routable, owner, 0)
    rr = jnp.where(routable, rank, 0)
    if wide:
        va, vb = _displaced_local_probe(t1_local, seeds_local, recv[:, :, 0],
                                        recv[:, :, 1], recv[:, :, 2], True)
        vals = jnp.stack([va, vb], axis=-1)
        reply = jax.lax.all_to_all(vals, axis, split_axis=0, concat_axis=0,
                                   tiled=False)
        got = reply[o, rr]
        return (jnp.where(routable, got[..., 0], 0),
                jnp.where(routable, got[..., 1], 0)), overflow
    vals = _displaced_local_probe(t1_local, seeds_local, recv[:, :, 0],
                                  recv[:, :, 1], recv[:, :, 2], False)
    reply = jax.lax.all_to_all(vals, axis, split_axis=0, concat_axis=0, tiled=False)
    val = jnp.where(routable, reply[o, rr], 0)
    return val, overflow


def _displaced_t3_tail(val_or_pair, t3, key_lo, key_hi, valid, slots3: int,
                       wide: bool):
    """Data-side replicated spill-tail probe (cache-resident by budget)."""
    if t3.shape[0] <= 8:
        return val_or_pair
    bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
    if wide:
        va, vb = val_or_pair
        va3, vb3 = probe_rows_wide(t3[bkt3], key_lo, key_hi, slots3)
        miss = (va | vb) == 0
        return jnp.where(miss, va3, va), jnp.where(miss, vb3, vb)
    va3 = probe_rows(t3[bkt3], key_lo, key_hi, slots3)
    return jnp.where(val_or_pair != 0, val_or_pair, va3)


def routed_displaced_search_step(mesh: Mesh, sharded: ShardedDisplacedIndex, *,
                                 do_rc: bool, num_labels: int, cap: int,
                                 bad_ix: int, capacity_factor: float = 1.3,
                                 capacity: int | None = None,
                                 axis: str = "table", data_axis: str = "data"):
    """jitted (table, packed, vbits, lens) -> (B, cap+2) int32 packed
    histograms + overflow column, displaced-shard edition."""
    from utree_tpu.lookup import displaced_bucket_jnp

    S = sharded.num_shards
    per_seed = sharded.nseed // S
    bad_ix = min(bad_ix, 0x7FFFFFFF)

    def step(table, packed, vbits, lens):
        def shard_fn(t1_local, seeds_local, t3, packed, vbits, lens):
            codes = base_codes_packed(packed, vbits, lens)
            qpre, qhi, qlo, valid = extract_windows(codes, 32)
            b_loc, w = qpre.shape
            key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
            gbkt = displaced_bucket_jnp(key_lo, key_hi, valid, sharded.nseed)

            p = b_loc * w
            c = capacity if capacity is not None else max(
                128, int(np.ceil(p / S * capacity_factor / 128)) * 128)
            val, overflow = _routed_probe_displaced(
                t1_local[0], seeds_local[0], gbkt.reshape(p), valid.reshape(p),
                key_lo.reshape(p), key_hi.reshape(p),
                axis=axis, num_shards=S, per_seed=per_seed, capacity=c,
                wide=sharded.wide,
            )
            if sharded.wide:
                val = (val[0].reshape(b_loc, w), val[1].reshape(b_loc, w))
            else:
                val = val.reshape(b_loc, w)
            val = _displaced_t3_tail(val, t3, key_lo, key_hi, valid,
                                     sharded.slots3, sharded.wide)
            if sharded.wide:
                r = decode_canonical_wide(val[0], val[1], valid, fwd_le,
                                          bad_ix, do_rc)
            else:
                r = decode_canonical_vals(val, valid, fwd_le, bad_ix, do_rc)
            ix = jnp.concatenate(r, axis=1) if do_rc else r
            out = pack_hist(ix, num_labels, cap)
            oflo = jax.lax.psum(overflow.astype(jnp.int32), (data_axis, axis))
            return jnp.concatenate(
                [out, jnp.broadcast_to(oflo, (b_loc, 1))], axis=1)

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(), P((data_axis, axis)),
                      P((data_axis, axis)), P((data_axis, axis))),
            out_specs=P((data_axis, axis)),
        )(table["t1"], table["ds"], table["t3"], packed, vbits, lens)

    return jax.jit(step)


def routed_displaced_fallback_step(mesh: Mesh, sharded: ShardedDisplacedIndex,
                                   *, do_rc: bool, num_labels: int, cap: int,
                                   bad_ix: int, axis: str = "table",
                                   data_axis: str = "data"):
    """Exact broadcast fallback for displaced shards: every chip probes its
    own seed-bucket range for the whole batch, values psum-merge (one owner
    per bucket, misses contribute 0)."""
    from utree_tpu.lookup import displaced_bucket_jnp

    S = sharded.num_shards
    per_seed = sharded.nseed // S
    bad_ix = min(bad_ix, 0x7FFFFFFF)

    def step(table, packed, vbits, lens):
        def shard_fn(t1_local, seeds_local, t3, packed, vbits, lens):
            codes = base_codes_packed(packed, vbits, lens)
            qpre, qhi, qlo, valid = extract_windows(codes, 32)
            key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
            gbkt = displaced_bucket_jnp(key_lo, key_hi, valid, sharded.nseed)
            my = jax.lax.axis_index(axis)
            owner = gbkt // per_seed
            mine = owner == my
            local = jnp.where(mine, gbkt - my * per_seed, 0)
            if sharded.wide:
                va, vb = _displaced_local_probe(
                    t1_local[0], seeds_local[0], local, key_lo, key_hi, True)
                va = jax.lax.psum(jnp.where(mine, va, 0), axis)
                vb = jax.lax.psum(jnp.where(mine, vb, 0), axis)
                val = _displaced_t3_tail((va, vb), t3, key_lo, key_hi, valid,
                                         sharded.slots3, True)
                r = decode_canonical_wide(val[0], val[1], valid, fwd_le,
                                          bad_ix, do_rc)
            else:
                v = _displaced_local_probe(
                    t1_local[0], seeds_local[0], local, key_lo, key_hi, False)
                val = jax.lax.psum(jnp.where(mine, v, 0), axis)
                val = _displaced_t3_tail(val, t3, key_lo, key_hi, valid,
                                         sharded.slots3, False)
                r = decode_canonical_vals(val, valid, fwd_le, bad_ix, do_rc)
            ix = jnp.concatenate(r, axis=1) if do_rc else r
            return pack_hist(ix, num_labels, cap)

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(), P(data_axis), P(data_axis),
                      P(data_axis)),
            out_specs=P(data_axis),
        )(table["t1"], table["ds"], table["t3"], packed, vbits, lens)

    return jax.jit(step)
