"""Seeded-displacement canonical index ("tier S"): exact equality with the
probe-replay path on both strands, e2e pipeline equality with the host spec,
and the placement invariants (every entry findable, spill bounded)."""

import jax
import numpy as np
import pytest

from utree_tpu.config import UTreeConfig
from utree_tpu.hash_index import (
    _rc64,
    build_canonical_hash_index,
    build_displaced_index,
)
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.lookup import lookup_kmers, lookup_kmers_canonical, lookup_kmers_displaced
from utree_tpu.memory import table_budget

# byte cap for the tables, from the device they are placed onto
CAP = table_budget(jax.devices()[0])


def _lanes(words):
    qpre = (words >> np.uint64(40)).astype(np.int32)
    qhi = ((words >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    qlo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return qpre, qhi, qlo


def _displaced_case(words, ixs, nlab, queries, valid=None, wide=False):
    cfg = UTreeConfig(ixtype_bytes=4 if wide else 2)
    index = DeviceIndexArrays.from_build(
        words, ixs, [b"l%d" % i for i in range(nlab)], cfg)
    bs = index.device_put()
    bad = min(cfg.bad_ix, 0x7FFFFFFF)
    qpre, qhi, qlo = _lanes(queries)
    if valid is None:
        valid = np.ones(len(queries), bool)
    ref_f = np.asarray(lookup_kmers(bs, qpre, qhi, qlo, valid, index.probe_iters, bad))
    rc = _rc64(queries)
    rpre, rhi, rlo = _lanes(rc)
    ref_r = np.asarray(lookup_kmers(bs, rpre, rhi, rlo, valid, index.probe_iters, bad))
    built = build_displaced_index(index, t1_cap=CAP)
    assert built.wide == wide
    dt = built.device_put()
    ixa, ixb = lookup_kmers_displaced(dt, qpre, qhi, qlo, valid,
                                      bad_ix=bad, do_rc=True, wide=wide)
    got = np.sort(np.stack([np.asarray(ixa), np.asarray(ixb)]), axis=0)
    want = np.sort(np.stack([ref_f, ref_r]), axis=0)
    assert np.array_equal(got, want)
    fwd = np.asarray(lookup_kmers_displaced(dt, qpre, qhi, qlo, valid,
                                            bad_ix=bad, do_rc=False, wide=wide))
    assert np.array_equal(fwd, ref_f)
    return built, ref_f, ref_r


def test_displaced_equals_bsearch_random():
    rng = np.random.default_rng(11)
    words = np.unique(rng.integers(0, 1 << 64, size=80_000, dtype=np.uint64))
    ixs = rng.integers(0, 900, size=len(words)).astype(np.int64)
    q = np.concatenate([
        rng.choice(words, 2000),
        _rc64(rng.choice(words, 2000)),
        rng.integers(0, 1 << 64, size=3000, dtype=np.uint64),
    ])
    built, ref_f, ref_r = _displaced_case(words, ixs, 900, q)
    assert (ref_f != UTreeConfig().bad_ix).sum() >= 2000
    assert (ref_r != UTreeConfig().bad_ix).sum() >= 2000


def test_displaced_every_entry_findable():
    """Every stored canonical entry must be reachable (t1 or spill t3)."""
    rng = np.random.default_rng(12)
    words = np.unique(rng.integers(0, 1 << 64, size=120_000, dtype=np.uint64))
    ixs = rng.integers(0, 500, size=len(words)).astype(np.int64)
    _displaced_case(words, ixs, 500, words)  # query = every word


def test_displaced_wide_labels():
    """IXTYPE=u32 (>=64K labels) uses 2-slot 32B rows."""
    rng = np.random.default_rng(13)
    words = np.unique(rng.integers(0, 1 << 64, size=40_000, dtype=np.uint64))
    nlab = 70_000
    ixs = rng.integers(0, nlab, size=len(words)).astype(np.int64)
    q = np.concatenate([rng.choice(words, 1500),
                        rng.integers(0, 1 << 64, size=1500, dtype=np.uint64)])
    _displaced_case(words, ixs, nlab, q, wide=True)


def test_displaced_invalid_windows_masked():
    rng = np.random.default_rng(14)
    words = np.unique(rng.integers(0, 1 << 64, size=5_000, dtype=np.uint64))
    ixs = rng.integers(0, 40, size=len(words)).astype(np.int64)
    q = rng.choice(words, 600)
    valid = rng.random(600) < 0.5
    cfg = UTreeConfig()
    index = DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(40)], cfg)
    built = build_displaced_index(index, t1_cap=CAP)
    qpre, qhi, qlo = _lanes(q)
    ixa, ixb = lookup_kmers_displaced(built.device_put(), qpre, qhi, qlo, valid,
                                      bad_ix=cfg.bad_ix, do_rc=True)
    assert (np.asarray(ixa)[~valid] == cfg.bad_ix).all()
    assert (np.asarray(ixb)[~valid] == cfg.bad_ix).all()


def test_displaced_matches_canonical_on_built_db(spec):
    """On a real built DB (quirky bins included) displaced == canonical."""
    index = DeviceIndexArrays.from_ctr(str(spec["ctr"]), UTreeConfig())
    cfg = index.config
    rng = np.random.default_rng(15)
    q = rng.integers(0, 1 << 64, size=4000, dtype=np.uint64)
    qpre, qhi, qlo = _lanes(q)
    valid = np.ones(len(q), bool)
    canon = build_canonical_hash_index(index, t1_cap=CAP)
    ca, cb = lookup_kmers_canonical(canon.device_put(), qpre, qhi, qlo, valid,
                                    slots=canon.slots, slots2=canon.slots2,
                                    bad_ix=cfg.bad_ix, do_rc=True)
    disp = build_displaced_index(index, t1_cap=CAP)
    da, db = lookup_kmers_displaced(disp.device_put(), qpre, qhi, qlo, valid,
                                    bad_ix=cfg.bad_ix, do_rc=True)
    assert np.array_equal(np.sort(np.stack([np.asarray(ca), np.asarray(cb)]), 0),
                          np.sort(np.stack([np.asarray(da), np.asarray(db)]), 0))


def test_pipeline_displaced_golden(spec, tmp_path):
    """Full pipeline with lookup_mode='displaced' == host spec classifications."""
    from utree_tpu.pipeline import SearchPipeline

    index = DeviceIndexArrays.from_ctr(str(spec["ctr"]), UTreeConfig())
    out = tmp_path / "cls.txt"
    pipe = SearchPipeline(index, do_rc=True, batch_size=128,
                          lookup_mode="displaced")
    assert pipe.table_kind == "displaced"
    pipe.search_file(spec["reads"], str(out))
    assert out.read_bytes() == spec["cls_rc"].read_bytes()


def test_pipeline_displaced_mesh_golden(spec, tmp_path):
    """Displaced table through the multi-device product path."""
    from utree_tpu.pipeline import SearchPipeline

    index = DeviceIndexArrays.from_ctr(str(spec["ctr"]), UTreeConfig())
    out = tmp_path / "cls.txt"
    SearchPipeline(index, do_rc=True, batch_size=128, lookup_mode="displaced",
                   devices=8).search_file(spec["reads"], str(out))
    assert out.read_bytes() == spec["cls_rc"].read_bytes()


def test_straggler_pass_consistency_under_contention():
    """Force the band loop to fail (huge buckets + high load) so placement
    falls through to the vectorized best-seed straggler passes, then assert
    the core invariant: every PLACED key sits exactly where the probe's
    (stored seed, slot mix) will look for it.  Regression for the round-3
    name-shadowing bug where pass>=1 indexed the unique-bucket array as the
    second key-mix lane (only reachable at scale; crashes or corrupts)."""
    from utree_tpu.hash_index import (_DISP_SEED_SALT, _DISP_SEED_SALT2,
                                      _disp_slot_np, _mix_np,
                                      displaced_buckets_np,
                                      place_displaced_core)

    rng = np.random.default_rng(5)
    ng = 60_000
    clo = rng.choice(1 << 31, size=ng, replace=False).astype(np.int64)
    cpre = rng.integers(0, 1 << 24, ng).astype(np.int64)
    chi = rng.integers(0, 256, ng).astype(np.int64)
    key_lo = clo.astype(np.int32)
    key_hi = (((cpre << 8) | chi) & 0x7FFFFFFF).astype(np.int32)
    vals = np.arange(ng, dtype=np.int32).reshape(-1, 1) | 1
    nseed = 2048  # lambda ~= 29 keys/bucket: band loop cannot seat these
    t1, seeds32, spilled = place_displaced_core(
        key_lo, key_hi, vals, cpre, chi, clo, ng,
        load=0.9, spill_budget=ng, nseed=nseed, t1_cap=CAP)
    assert 0 < len(spilled) < ng  # contention actually happened, not total loss

    seed_of = np.frombuffer(seeds32.tobytes(), np.uint8)[:nseed]
    bucket = displaced_buckets_np(cpre, chi, clo, nseed)
    u2 = _mix_np(cpre, chi, clo ^ _DISP_SEED_SALT)
    u3 = _mix_np(cpre, chi ^ np.int64(0xA5), clo ^ _DISP_SEED_SALT2)
    nslots = 2 * t1.shape[0]
    slot = _disp_slot_np(u2, u3, seed_of[bucket].astype(np.uint32), nslots)
    placed = np.ones(ng, bool)
    placed[spilled] = False
    rows = (slot[placed] >> 1).astype(np.int64)
    cols = (slot[placed] & 1).astype(np.int64)
    assert np.array_equal(t1[rows, cols * 3], key_lo[placed])
    assert np.array_equal(t1[rows, cols * 3 + 1], key_hi[placed])
    assert np.array_equal(t1[rows, cols * 3 + 2], vals[placed, 0])


def test_respill_t3_migration_equal():
    """respill_displaced_t3 re-buckets an existing tail into the narrow row
    geometry; probes must answer identically (cache-migration helper)."""
    from utree_tpu.hash_index import respill_displaced_t3

    rng = np.random.default_rng(17)
    words = np.sort(rng.choice(1 << 40, size=40_000, replace=False).astype(np.uint64))
    ixs = rng.integers(0, 50, len(words)).astype(np.int64)
    queries = np.concatenate([words[::7], rng.integers(0, 1 << 40, 300, dtype=np.uint64)])
    cfg = UTreeConfig()
    index = DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(50)], cfg)
    built = build_displaced_index(index, load=0.98, spill_budget=len(words),
                                  t1_cap=CAP)
    assert built.t3.shape[0] > 8
    qpre, qhi, qlo = _lanes(queries)
    valid = np.ones(len(queries), bool)
    a = np.asarray(lookup_kmers_displaced(built.device_put(), qpre, qhi, qlo,
                                          valid, bad_ix=65535, do_rc=False))
    t3b = respill_displaced_t3(built.t3, built.wide, t1_cap=CAP)
    import dataclasses as dc
    moved = dc.replace(built, t3=t3b, slots3=t3b.shape[1] // 3)
    b = np.asarray(lookup_kmers_displaced(moved.device_put(), qpre, qhi, qlo,
                                          valid, bad_ix=65535, do_rc=False))
    assert np.array_equal(a, b)
