"""Routed (all_to_all) sharded canonical search: identical to single-device.

BASELINE config 5's exactness contract on the virtual 8-CPU mesh: routing
only changes WHERE bucket rows are gathered, never the result.
"""

import functools

import jax
import numpy as np

from utree_tpu.config import UTreeConfig
from utree_tpu.hash_index import build_canonical_hash_index
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.lookup import pack_reads_host, search_step_hist_packed
from utree_tpu.memory import table_budget
from utree_tpu.parallel import make_mesh
from utree_tpu.parallel.routed import (
    ShardedCanonicalIndex,
    routed_canonical_search_step,
    routed_fallback_step,
)

# byte cap for the tables, from the device they are placed onto
CAP = table_budget(jax.devices()[0])


def _setup(spec, batch=64, length=150, seed=21):
    cfg = UTreeConfig()
    idx = DeviceIndexArrays.from_ctr(str(spec["ctr"]), cfg)
    canon = build_canonical_hash_index(idx, t1_cap=CAP)
    rng = np.random.default_rng(seed)
    reads = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(batch, length),
                       p=[0.24, 0.24, 0.24, 0.24, 0.04]).astype(np.uint8)
    lens = rng.integers(40, length + 1, size=batch).astype(np.int32)
    lmax = (length + 63) & ~63
    mat = np.zeros((batch, lmax), np.uint8)
    mat[:, :length] = reads
    packed, vbits, lens = pack_reads_host(mat, lens)
    return cfg, idx, canon, packed, vbits, lens


def _single(cfg, idx, canon, packed, vbits, lens, do_rc, cap):
    table = canon.device_put()
    step = functools.partial(
        search_step_hist_packed, k=32, do_rc=do_rc, probe_iters=idx.probe_iters,
        bad_ix=min(cfg.bad_ix, 0x7FFFFFFF), num_labels=idx.num_labels, cap=cap)
    return np.asarray(jax.jit(step)(table, packed, vbits, lens))


def test_routed_identical_8way(spec):
    cfg, idx, canon, packed, vbits, lens = _setup(spec)
    mesh = make_mesh(data=1, table=8)
    sharded = ShardedCanonicalIndex.from_canonical(canon, 8)
    step = routed_canonical_search_step(
        mesh, sharded, do_rc=True, num_labels=idx.num_labels, cap=8,
        bad_ix=cfg.bad_ix)
    out = np.asarray(step(sharded.device_put(mesh), packed, vbits, lens))
    assert (out[:, -1] == 0).all()  # no capacity overflow
    ref = _single(cfg, idx, canon, packed, vbits, lens, True, 8)
    assert np.array_equal(out[:, :-1], ref)


def test_routed_identical_2x4_no_rc(spec):
    cfg, idx, canon, packed, vbits, lens = _setup(spec, batch=32, seed=5)
    mesh = make_mesh(data=2, table=4)
    sharded = ShardedCanonicalIndex.from_canonical(canon, 4)
    step = routed_canonical_search_step(
        mesh, sharded, do_rc=False, num_labels=idx.num_labels, cap=16,
        bad_ix=cfg.bad_ix)
    out = np.asarray(step(sharded.device_put(mesh), packed, vbits, lens))
    assert (out[:, -1] == 0).all()
    ref = _single(cfg, idx, canon, packed, vbits, lens, False, 16)
    assert np.array_equal(out[:, :-1], ref)


def test_routed_wide_labels_identical():
    """IXTYPE=u32 (>64K labels) canonical tables shard + route too: the
    payload/reply just grows one value lane (BASELINE configs 4x5)."""
    rng = np.random.default_rng(31)
    words = np.unique(rng.integers(0, 1 << 64, size=60_000, dtype=np.uint64))
    nlab = 70_000
    ixs = rng.integers(0, nlab, size=len(words)).astype(np.int64)
    cfg = UTreeConfig(ixtype_bytes=4)
    idx = DeviceIndexArrays.from_build(
        words, ixs, [b"l%d" % i for i in range(nlab)], cfg)
    canon = build_canonical_hash_index(idx, t1_cap=CAP)
    assert canon.t1.shape[1] == canon.slots * 4  # actually wide

    # reads with a stored word spliced in so routed probes really hit
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(64, 150)).astype(np.uint8)
    dec = np.frombuffer(b"ACGT", np.uint8)
    picks = rng.choice(words, size=64)
    shifts = 2 * (31 - np.arange(32))
    bases = ((picks[:, None] >> shifts[None, :].astype(np.uint64)) & np.uint64(3)).astype(np.int64)
    reads[:, 10:42] = dec[bases]
    lens = np.full(64, 150, np.int32)
    lmax = (150 + 63) & ~63
    mat = np.zeros((64, lmax), np.uint8)
    mat[:, :150] = reads
    packed, vbits, lens = pack_reads_host(mat, lens)

    ref = _single(cfg, idx, canon, packed, vbits, lens, True, 8)
    mesh = make_mesh(data=1, table=8)
    sharded = ShardedCanonicalIndex.from_canonical(canon, 8)
    assert sharded.wide
    step = routed_canonical_search_step(
        mesh, sharded, do_rc=True, num_labels=idx.num_labels, cap=8,
        bad_ix=cfg.bad_ix)
    out = np.asarray(step(sharded.device_put(mesh), packed, vbits, lens))
    assert (out[:, -1] == 0).all()
    assert np.array_equal(out[:, :-1], ref)

    fb = routed_fallback_step(
        mesh, sharded, do_rc=True, num_labels=idx.num_labels, cap=8,
        bad_ix=cfg.bad_ix)
    got = np.asarray(fb(sharded.device_put(mesh), packed, vbits, lens))
    assert np.array_equal(got, ref)


def test_routed_overflow_flag_and_fallback(spec):
    """A tiny capacity factor forces overflow; the flag must fire and the
    fallback must produce the exact single-device result."""
    cfg, idx, canon, packed, vbits, lens = _setup(spec, seed=77)
    mesh = make_mesh(data=1, table=8)
    sharded = ShardedCanonicalIndex.from_canonical(canon, 8)
    step = routed_canonical_search_step(
        mesh, sharded, do_rc=True, num_labels=idx.num_labels, cap=8,
        bad_ix=cfg.bad_ix, capacity=8)
    out = np.asarray(step(sharded.device_put(mesh), packed, vbits, lens))
    assert (out[:, -1] > 0).all()  # overflow reported on every row

    fb = routed_fallback_step(
        mesh, sharded, do_rc=True, num_labels=idx.num_labels, cap=8,
        bad_ix=cfg.bad_ix)
    got = np.asarray(fb(sharded.device_put(mesh), packed, vbits, lens))
    ref = _single(cfg, idx, canon, packed, vbits, lens, True, 8)
    assert np.array_equal(got, ref)


# ---- displaced shards (the >HBM flagship regime) --------------------------


def _single_displaced(cfg, idx, packed, vbits, lens, do_rc, cap):
    from utree_tpu.hash_index import build_displaced_index

    table = build_displaced_index(idx, t1_cap=CAP).device_put()
    step = functools.partial(
        search_step_hist_packed, k=32, do_rc=do_rc, probe_iters=idx.probe_iters,
        bad_ix=min(cfg.bad_ix, 0x7FFFFFFF), num_labels=idx.num_labels, cap=cap)
    return np.asarray(jax.jit(step)(table, packed, vbits, lens))


def test_routed_displaced_identical_8way(spec):
    from utree_tpu.parallel.routed import (ShardedDisplacedIndex,
                                           routed_displaced_search_step)

    cfg, idx, _, packed, vbits, lens = _setup(spec)
    mesh = make_mesh(data=1, table=8)
    sharded = ShardedDisplacedIndex.build(idx, 8, t1_cap=CAP)
    step = routed_displaced_search_step(
        mesh, sharded, do_rc=True, num_labels=idx.num_labels, cap=8,
        bad_ix=cfg.bad_ix)
    out = np.asarray(step(sharded.device_put(mesh), packed, vbits, lens))
    assert (out[:, -1] == 0).all()  # no capacity overflow
    ref = _single_displaced(cfg, idx, packed, vbits, lens, True, 8)
    assert np.array_equal(out[:, :-1], ref)


def test_routed_displaced_2x4_fallback_and_overflow(spec):
    from utree_tpu.parallel.routed import (ShardedDisplacedIndex,
                                           routed_displaced_fallback_step,
                                           routed_displaced_search_step)

    cfg, idx, _, packed, vbits, lens = _setup(spec, batch=32, seed=9)
    mesh = make_mesh(data=2, table=4)
    sharded = ShardedDisplacedIndex.build(idx, 4, t1_cap=CAP)
    ref = _single_displaced(cfg, idx, packed, vbits, lens, False, 16)

    fb = routed_displaced_fallback_step(
        mesh, sharded, do_rc=False, num_labels=idx.num_labels, cap=16,
        bad_ix=cfg.bad_ix)
    got = np.asarray(fb(sharded.device_put(mesh), packed, vbits, lens))
    assert np.array_equal(got, ref)

    tiny = routed_displaced_search_step(
        mesh, sharded, do_rc=False, num_labels=idx.num_labels, cap=16,
        bad_ix=cfg.bad_ix, capacity=8)
    out = np.asarray(tiny(sharded.device_put(mesh), packed, vbits, lens))
    assert (out[:, -1] > 0).all()  # overflow flag fires at capacity 8


def test_routed_displaced_wide_labels():
    from utree_tpu.parallel.routed import (ShardedDisplacedIndex,
                                           routed_displaced_search_step)

    rng = np.random.default_rng(41)
    words = np.unique(rng.integers(0, 1 << 64, size=60_000, dtype=np.uint64))
    nlab = 70_000
    ixs = rng.integers(0, nlab, size=len(words)).astype(np.int64)
    cfg = UTreeConfig(ixtype_bytes=4)
    idx = DeviceIndexArrays.from_build(
        words, ixs, [b"l%d" % i for i in range(nlab)], cfg)

    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(64, 150)).astype(np.uint8)
    dec = np.frombuffer(b"ACGT", np.uint8)
    picks = rng.choice(words, size=64)
    shifts = 2 * (31 - np.arange(32))
    bases = ((picks[:, None] >> shifts[None, :].astype(np.uint64)) & np.uint64(3)).astype(np.int64)
    reads[:, 10:42] = dec[bases]
    lens = np.full(64, 150, np.int32)
    lmax = (150 + 63) & ~63
    mat = np.zeros((64, lmax), np.uint8)
    mat[:, :150] = reads
    packed, vbits, lens = pack_reads_host(mat, lens)

    ref = _single_displaced(cfg, idx, packed, vbits, lens, True, 8)
    mesh = make_mesh(data=1, table=8)
    sharded = ShardedDisplacedIndex.build(idx, 8, t1_cap=CAP)
    assert sharded.wide
    step = routed_displaced_search_step(
        mesh, sharded, do_rc=True, num_labels=idx.num_labels, cap=8,
        bad_ix=cfg.bad_ix)
    out = np.asarray(step(sharded.device_put(mesh), packed, vbits, lens))
    assert (out[:, -1] == 0).all()
    assert np.array_equal(out[:, :-1], ref)
