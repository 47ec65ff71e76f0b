"""PACKSIZE=64 + IXTYPE=uint32_t configuration (BASELINE config 4): device
paths vs the host spec, and goldens vs the reference binaries."""

import jax
import pytest

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import write_ctr_from_ubt, write_ubt
from utree_tpu.memory import table_budget
from utree_tpu.oracle import run_oracle_pipeline
from utree_tpu.search_host import HostIndex, search_file
from utree_tpu.testdata import build_spec_db, make_toy_db, make_toy_reads

# byte cap for the tables, from the device they are placed onto
CAP = table_budget(jax.devices()[0])

CFG64 = UTreeConfig(packsize=64, ixtype_bytes=4)
DEFS = ("PACKSIZE=64", "IXTYPE=uint32_t")


@pytest.fixture(scope="module")
def spec64(tmp_path_factory):
    """64-mer toy DB built in-repo, with the host spec's classifications."""
    wd = tmp_path_factory.mktemp("toy64")
    records = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), num_refs=8, ref_len=3000, seed=77)
    make_toy_reads(str(wd / "reads.fa"), records, num_reads=300, read_len=150, seed=78)
    out = build_spec_db(wd / "refs.fa", wd / "tax.map", wd, CFG64, reads=wd / "reads.fa")
    return {"dir": wd, **out}


@pytest.fixture(scope="module")
def toy64(reference_sources, spec64):
    """The same inputs through the reference binaries built for k=64."""
    wd = spec64["dir"]
    golden = run_oracle_pipeline(
        str(wd / "refs.fa"), str(wd / "tax.map"), str(wd / "reads.fa"),
        str(wd / "oracle"), complevel=1, extra_defs=DEFS, suffix="-64",
    )
    return {"dir": wd, "golden": golden}


def test_ubt64_bytes_identical(toy64, tmp_path):
    wd = toy64["dir"]
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), CFG64)
    ours = tmp_path / "ours.ubt"
    write_ubt(str(ours), res.words, res.ixs, res.labels.strings, CFG64)
    assert ours.read_bytes() == toy64["golden"]["ubt"].read_bytes()


def test_ctr64_bytes_identical(toy64, tmp_path):
    ours = tmp_path / "ours.ctr"
    write_ctr_from_ubt(str(toy64["golden"]["ubt"]), str(ours), CFG64)
    assert ours.read_bytes() == toy64["golden"]["ctr"].read_bytes()


def test_search64_classifications_identical(toy64, tmp_path):
    idx = HostIndex.from_ctr(str(toy64["golden"]["ctr"]), CFG64)
    out = tmp_path / "cls.txt"
    search_file(idx, str(toy64["dir"] / "reads.fa"), str(out), do_rc=False)
    assert out.read_bytes() == toy64["golden"]["classifications"].read_bytes()


def test_search64_rc_identical(toy64, tmp_path):
    wd = toy64["dir"]
    golden = run_oracle_pipeline(
        str(wd / "refs.fa"), str(wd / "tax.map"), str(wd / "reads.fa"),
        str(tmp_path / "oracle_rc"), complevel=1, do_rc=True,
        extra_defs=DEFS, suffix="-64",
    )
    idx = HostIndex.from_ctr(str(golden["ctr"]), CFG64)
    out = tmp_path / "cls_rc.txt"
    search_file(idx, str(wd / "reads.fa"), str(out), do_rc=True)
    assert out.read_bytes() == golden["classifications"].read_bytes()


def test_device_canonical64_equals_host_lookup(spec64):
    """Canonical64 hash: per-position {ix(f), ix(rc f)} must equal the host
    probe replay on both strands, on the real built index."""
    import numpy as np

    from utree_tpu.hash_index64 import (
        _rc128,
        build_canonical_hash_index64,
    )
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.lookup import lookup_kmers_canonical64
    from utree_tpu.search_host import HostIndex as HI, lookup_words

    wd = spec64["dir"]
    index = DeviceIndexArrays.from_ctr(str(spec64["ctr"]), CFG64)
    hidx = HI.from_ctr(str(spec64["ctr"]), CFG64)
    built = build_canonical_hash_index64(index, t1_cap=CAP)
    tables = built.device_put()

    rng = np.random.default_rng(79)
    from utree_tpu.encode import W128, search_window_words

    reads = spec64["dir"] / "reads.fa"
    seqs = [l for l in reads.read_bytes().splitlines() if l and not l.startswith(b">")]
    words_list = [search_window_words(s, 64, False) for s in seqs[:50]]
    words = np.concatenate([w for w in words_list if len(w)])
    rand = np.zeros(500, dtype=W128)
    rand["hi"] = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    rand["lo"] = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    words = np.concatenate([words, rand])

    ref_f = lookup_words(hidx, words)
    rc = np.zeros(len(words), dtype=W128)
    rc["hi"], rc["lo"] = _rc128(words["hi"], words["lo"])
    ref_r = lookup_words(hidx, rc)

    k0 = ((words["hi"] >> np.uint64(32)).astype(np.uint32)).view(np.int32)
    k1 = ((words["hi"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)
    k2 = ((words["lo"] >> np.uint64(32)).astype(np.uint32)).view(np.int32)
    k3 = ((words["lo"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)
    valid = np.ones(len(words), bool)
    miss = CFG64.bad_ix if CFG64.bad_ix < 2**31 else 2**31 - 1
    ixa, ixb = lookup_kmers_canonical64(
        tables, k0, k1, k2, k3, valid, slots=built.slots, slots2=built.slots2,
        miss=miss, do_rc=True)
    nl = index.num_labels
    fa = np.where(np.asarray(ixa) < nl, np.asarray(ixa), -1)
    fb = np.where(np.asarray(ixb) < nl, np.asarray(ixb), -1)
    wf = np.where(ref_f < nl, ref_f, -1)
    wr = np.where(ref_r < nl, ref_r, -1)
    got = np.sort(np.stack([fa, fb]), axis=0)
    want = np.sort(np.stack([wf, wr]), axis=0)
    assert np.array_equal(got, want)
    # non-RC orientation select
    fwd = np.asarray(lookup_kmers_canonical64(
        tables, k0, k1, k2, k3, valid, slots=built.slots, slots2=built.slots2,
        miss=miss, do_rc=False))
    assert np.array_equal(np.where(fwd < nl, fwd, -1), wf)


def test_device_pipeline64_matches_oracle(spec64, tmp_path):
    """Full 64-mer device pipeline vs the host spec (forward)."""
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.pipeline import SearchPipeline

    wd = spec64["dir"]
    idx = DeviceIndexArrays.from_ctr(str(spec64["ctr"]), CFG64)
    for rc, gold_key in ((False, "cls"),):
        pipe = SearchPipeline(idx, do_rc=rc, batch_size=64)
        assert "c64_1" in pipe._table
        out = tmp_path / f"cls64_{rc}.txt"
        pipe.search_file(str(wd / "reads.fa"), str(out))
        assert out.read_bytes() == spec64[gold_key].read_bytes()


def test_device_pipeline64_rc_matches_oracle(spec64, tmp_path):
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.pipeline import SearchPipeline

    wd = spec64["dir"]
    idx = DeviceIndexArrays.from_ctr(str(spec64["ctr"]), CFG64)
    pipe = SearchPipeline(idx, do_rc=True, batch_size=64)
    out = tmp_path / "cls64_rc.txt"
    pipe.search_file(str(wd / "reads.fa"), str(out))
    assert out.read_bytes() == spec64["cls_rc"].read_bytes()


def test_canonical64_three_level_tier_exact(spec64):
    """The 64-mer 3-level ladder tier (narrow t2 + cached t3) answers
    identically to the default geometry on the real built index."""
    import numpy as np

    from utree_tpu.hash_index64 import (_place64, _reference_hits64, _rc128,
                                        build_canonical_hash_index64)
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.lookup import lookup_kmers_canonical64
    from utree_tpu.encode import W128

    index = DeviceIndexArrays.from_ctr(str(spec64["ctr"]), CFG64)
    base = build_canonical_hash_index64(index, t1_cap=CAP)

    # rebuild with a forced-overloaded 3-level geometry (t3 exercised)
    w_hi, w_lo, ix = _reference_hits64(index)
    r_hi, r_lo = _rc128(w_hi, w_lo)
    fwd_le = (w_hi < r_hi) | ((w_hi == r_hi) & (w_lo <= r_lo))
    c_hi = np.where(fwd_le, w_hi, r_hi)
    c_lo = np.where(fwd_le, w_lo, r_lo)
    order = np.lexsort((c_lo, c_hi))
    chs, cls = c_hi[order], c_lo[order]
    isf = fwd_le[order]
    ixs = ix[order]
    new = np.ones(len(chs), bool)
    new[1:] = (chs[1:] != chs[:-1]) | (cls[1:] != cls[:-1])
    gid = np.cumsum(new) - 1
    ng = int(gid[-1]) + 1
    va = np.zeros(ng, np.int64); vb = np.zeros(ng, np.int64)
    va[gid[isf]] = ixs[isf] + 1
    vb[gid[~isf]] = ixs[~isf] + 1
    ck_hi, ck_lo = chs[new], cls[new]
    p_hi, p_lo = _rc128(ck_hi, ck_lo)
    pal = (ck_hi == p_hi) & (ck_lo == p_lo)
    vb[pal] = va[pal]
    k0 = (ck_hi >> np.uint64(32)).astype(np.uint32)
    k1 = (ck_hi & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    k2 = (ck_lo >> np.uint64(32)).astype(np.uint32)
    k3 = (ck_lo & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lanes = [k0.view(np.int32), k1.view(np.int32), k2.view(np.int32),
             k3.view(np.int32), va.astype(np.int32), vb.astype(np.int32)]
    forced = _place64(lanes, k0, k1, k2, k3, ng, 2, 16.0, 1, 1 << 26, slots3=8,
                     t1_cap=CAP)
    assert forced.t3.shape[0] > 8, "t3 tail not exercised"

    rng = np.random.default_rng(83)
    qs = np.zeros(3000, dtype=W128)
    pick = rng.integers(0, len(ck_hi), size=2000)
    qs["hi"][:2000] = ck_hi[pick]
    qs["lo"][:2000] = ck_lo[pick]
    qs["hi"][2000:] = rng.integers(0, 1 << 64, size=1000, dtype=np.uint64)
    qs["lo"][2000:] = rng.integers(0, 1 << 64, size=1000, dtype=np.uint64)
    q0 = ((qs["hi"] >> np.uint64(32)).astype(np.uint32)).view(np.int32)
    q1 = ((qs["hi"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)
    q2 = ((qs["lo"] >> np.uint64(32)).astype(np.uint32)).view(np.int32)
    q3 = ((qs["lo"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)
    valid = np.ones(len(qs), bool)
    miss = min(CFG64.bad_ix, 2**31 - 1)
    a0, b0 = lookup_kmers_canonical64(base.device_put(), q0, q1, q2, q3, valid,
                                      slots=base.slots, slots2=base.slots2,
                                      miss=miss, do_rc=True)
    a1, b1 = lookup_kmers_canonical64(forced.device_put(), q0, q1, q2, q3, valid,
                                      slots=forced.slots, slots2=forced.slots2,
                                      miss=miss, do_rc=True)
    assert np.array_equal(np.asarray(a0), np.asarray(a1))
    assert np.array_equal(np.asarray(b0), np.asarray(b1))


def test_device_displaced64_equals_host_lookup(spec64):
    """Displaced64 (seed + one 48B row gather): per-position {ix(f), ix(rc)}
    must equal the host probe replay on both strands, on the real index."""
    import numpy as np

    from utree_tpu.encode import W128, search_window_words
    from utree_tpu.hash_index64 import _rc128, build_displaced_index64
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.lookup import lookup_kmers_displaced64
    from utree_tpu.search_host import HostIndex as HI, lookup_words

    wd = spec64["dir"]
    index = DeviceIndexArrays.from_ctr(str(spec64["ctr"]), CFG64)
    hidx = HI.from_ctr(str(spec64["ctr"]), CFG64)
    built = build_displaced_index64(index, t1_cap=CAP)
    tables = built.device_put()

    rng = np.random.default_rng(80)
    reads = wd / "reads.fa"
    seqs = [l for l in reads.read_bytes().splitlines() if l and not l.startswith(b">")]
    words_list = [search_window_words(s, 64, False) for s in seqs[:50]]
    words = np.concatenate([w for w in words_list if len(w)])
    rand = np.zeros(500, dtype=W128)
    rand["hi"] = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    rand["lo"] = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    words = np.concatenate([words, rand])

    ref_f = lookup_words(hidx, words)
    rc = np.zeros(len(words), dtype=W128)
    rc["hi"], rc["lo"] = _rc128(words["hi"], words["lo"])
    ref_r = lookup_words(hidx, rc)

    k0 = ((words["hi"] >> np.uint64(32)).astype(np.uint32)).view(np.int32)
    k1 = ((words["hi"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)
    k2 = ((words["lo"] >> np.uint64(32)).astype(np.uint32)).view(np.int32)
    k3 = ((words["lo"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)
    valid = np.ones(len(words), bool)
    miss = CFG64.bad_ix if CFG64.bad_ix < 2**31 else 2**31 - 1
    ixa, ixb = lookup_kmers_displaced64(
        tables, k0, k1, k2, k3, valid, miss=miss, do_rc=True)
    nl = index.num_labels
    fa = np.where(np.asarray(ixa) < nl, np.asarray(ixa), -1)
    fb = np.where(np.asarray(ixb) < nl, np.asarray(ixb), -1)
    wf = np.where(ref_f < nl, ref_f, -1)
    wr = np.where(ref_r < nl, ref_r, -1)
    got = np.sort(np.stack([fa, fb]), axis=0)
    want = np.sort(np.stack([wf, wr]), axis=0)
    assert np.array_equal(got, want)
    fwd = np.asarray(lookup_kmers_displaced64(
        tables, k0, k1, k2, k3, valid, miss=miss, do_rc=False))
    assert np.array_equal(np.where(fwd < nl, fwd, -1), wf)


def test_displaced64_spill_tail_exact(spec64):
    """Overloaded displaced64 placement (load ~1) pushes entries to the t3
    tail; the probe must still answer identically."""
    import numpy as np

    from utree_tpu.encode import search_window_words
    from utree_tpu.hash_index64 import build_displaced_index64
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.lookup import lookup_kmers_displaced64
    from utree_tpu.search_host import HostIndex as HI, lookup_words

    index = DeviceIndexArrays.from_ctr(str(spec64["ctr"]), CFG64)
    hidx = HI.from_ctr(str(spec64["ctr"]), CFG64)
    built = build_displaced_index64(index, load=0.98,
                                    spill_budget=index.num_records, t1_cap=CAP)
    assert built.t3.shape[0] > 8  # spill actually happened
    tables = built.device_put()

    reads = spec64["dir"] / "reads.fa"
    seqs = [l for l in reads.read_bytes().splitlines() if l and not l.startswith(b">")]
    words = np.concatenate([w for w in (search_window_words(s, 64, False)
                                        for s in seqs[:50]) if len(w)])
    ref_f = lookup_words(hidx, words)
    k0 = ((words["hi"] >> np.uint64(32)).astype(np.uint32)).view(np.int32)
    k1 = ((words["hi"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)
    k2 = ((words["lo"] >> np.uint64(32)).astype(np.uint32)).view(np.int32)
    k3 = ((words["lo"] & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)
    valid = np.ones(len(words), bool)
    miss = 2**31 - 1
    fwd = np.asarray(lookup_kmers_displaced64(
        tables, k0, k1, k2, k3, valid, miss=miss, do_rc=False))
    nl = index.num_labels
    assert np.array_equal(np.where(fwd < nl, fwd, -1),
                          np.where(ref_f < nl, ref_f, -1))


def test_device_pipeline64_displaced_matches_oracle(spec64, tmp_path):
    """Full 64-mer device pipeline on the displaced table vs the host spec."""
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.pipeline import SearchPipeline

    wd = spec64["dir"]
    idx = DeviceIndexArrays.from_ctr(str(spec64["ctr"]), CFG64)
    pipe = SearchPipeline(idx, do_rc=False, batch_size=64,
                          lookup_mode="displaced")
    assert "d64_1" in pipe._table
    assert pipe.table_kind == "displaced64"
    out = tmp_path / "cls64_disp.txt"
    pipe.search_file(str(wd / "reads.fa"), str(out))
    assert out.read_bytes() == spec64["cls"].read_bytes()
