"""Device (jit) pipeline tests: identical to the host spec, on the CPU mesh."""

import jax
import numpy as np

from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline
from utree_tpu.search_host import HostIndex, lookup_words


def test_devices_are_virtual_cpu():
    devs = jax.devices()
    assert len(devs) == 8 and devs[0].platform == "cpu"


def test_device_lookup_matches_host(spec):
    """Random words (hits and misses) look up identically on host and device."""
    cfg = UTreeConfig()
    hidx = HostIndex.from_ctr(str(spec["ctr"]), cfg)
    didx = DeviceIndexArrays.from_ctr(str(spec["ctr"]), cfg)

    rng = np.random.default_rng(5)
    # half random words, half actual DB words (guaranteed hits)
    from utree_tpu.formats import read_ubt

    ubt = read_ubt(str(spec["ubt"]))
    sample = rng.choice(ubt.words, size=500)
    randoms = rng.integers(0, 1 << 63, size=500, dtype=np.uint64)
    words = np.concatenate([sample, randoms])

    host_ix = lookup_words(hidx, words)

    from utree_tpu.lookup import lookup_kmers

    qpre = (words >> np.uint64(40)).astype(np.int32)
    qhi = ((words >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    qlo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    table = didx.device_put()
    dev_ix = np.asarray(
        lookup_kmers(table, qpre, qhi, qlo, np.ones(len(words), bool),
                     didx.probe_iters, cfg.bad_ix)
    )
    assert np.array_equal(host_ix, dev_ix)


def test_device_pipeline_classifications_identical(spec, tmp_path):
    idx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    pipe = SearchPipeline(idx, do_rc=False, batch_size=333)  # odd batch on purpose
    out = tmp_path / "dev.txt"
    n = pipe.search_file(spec["reads"], str(out))
    assert n == 1000
    assert out.read_bytes() == spec["cls"].read_bytes()


def test_device_pipeline_rc_identical(spec, tmp_path):
    idx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    pipe = SearchPipeline(idx, do_rc=True, batch_size=256)
    out = tmp_path / "dev_rc.txt"
    pipe.search_file(spec["reads"], str(out))
    assert out.read_bytes() == spec["cls_rc"].read_bytes()


def test_index_from_build_equals_from_ctr(spec):
    """from_build (skipping the ubt/ctr round trip) builds the same index."""
    from utree_tpu.build import build_database

    cfg = UTreeConfig()
    res = build_database(spec["refs"], spec["map"], cfg)
    a = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    b = DeviceIndexArrays.from_ctr(str(spec["ctr"]), cfg)
    assert np.array_equal(a.bin_ix, b.bin_ix)
    assert np.array_equal(a.suf_hi, b.suf_hi)
    assert np.array_equal(a.suf_lo, b.suf_lo)
    assert np.array_equal(a.ix, b.ix)
    assert a.strings == b.strings


def test_all_lookup_modes_identical(spec, tmp_path):
    """canonical / hash / bsearch device tables must classify identically
    (the hash modes are exact reproductions of the probe replay)."""
    cfg = UTreeConfig()
    didx = DeviceIndexArrays.from_ctr(str(spec["ctr"]), cfg)
    outs = []
    for mode in ("canonical", "hash", "bsearch"):
        pipe = SearchPipeline(didx, do_rc=True, batch_size=64, lookup_mode=mode)
        if mode == "canonical":
            assert "c1" in pipe._table
        elif mode == "hash":
            assert "t1" in pipe._table
        else:
            assert "bin_ix" in pipe._table
        out = tmp_path / f"cls_{mode}.txt"
        pipe.search_file(str(spec["reads"]), str(out))
        outs.append(out.read_bytes())
    assert outs[0] == spec["cls_rc"].read_bytes()
    assert outs[0] == outs[1] == outs[2]


def test_ixtype4_packsize32_device_path(spec):
    """IXTYPE=u32 with PACKSIZE=32: the miss sentinel (2^32-1) must be clamped
    to int32 range in the device paths (ADVICE r1) instead of overflowing."""
    from utree_tpu.build import build_database

    cfg = UTreeConfig(ixtype_bytes=4)
    res = build_database(spec["refs"], spec["map"], cfg)
    idx = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    # reference vote via the ixtype=2 pipeline on the same reads
    idx16 = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    from utree_tpu.io.fasta import iter_fasta_records

    names, seqs = [], []
    for h, s in iter_fasta_records(spec["reads"]):
        names.append(h.split(b" ")[0])
        seqs.append(s)
        if len(seqs) == 64:
            break
    for mode in ("bsearch", "hash"):
        pipe32 = SearchPipeline(idx, do_rc=True, batch_size=32, lookup_mode=mode)
        pipe16 = SearchPipeline(idx16, do_rc=True, batch_size=32, lookup_mode=mode)
        got = pipe32.classify_batch(names, seqs)
        want = pipe16.classify_batch(names, seqs)
        assert got == want


def test_explicit_lookup_mode_never_degrades(spec):
    """An explicit --lookup-mode that cannot be honored raises (ADVICE r1)
    instead of silently falling back to a different table layout."""
    import pytest

    from utree_tpu.build import build_database

    # PACKSIZE=64 has exactly one device path; explicit bsearch must raise
    cfg64 = UTreeConfig(packsize=64, ixtype_bytes=4)
    res64 = build_database(spec["refs"], spec["map"], cfg64)
    idx64 = DeviceIndexArrays.from_build(res64.words, res64.ixs, res64.labels.strings, cfg64)
    with pytest.raises(ValueError):
        SearchPipeline(idx64, lookup_mode="bsearch", batch_size=8)


def test_auto_mode_never_silently_degrades(spec, monkeypatch):
    """Auto lookup-mode must not quietly serve a huge DB through the slower
    bsearch replay: when no single-device table fits, it raises pointing at
    the routed multi-device remedy."""
    import pytest

    from utree_tpu.build import build_database

    cfg = UTreeConfig()
    res = build_database(spec["refs"], spec["map"], cfg)
    idx = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)

    # beyond the device tables' ceiling entirely (auto skips them): must raise
    monkeypatch.setattr(DeviceIndexArrays, "num_records",
                        property(lambda self: 500_000_000))
    with pytest.raises(RuntimeError, match="routed"):
        SearchPipeline(idx, lookup_mode="auto", batch_size=8)

    # in the displaced/canonical band but both builders fail (the 268M-400M
    # cliff): must raise, not fall back to replay
    monkeypatch.setattr(DeviceIndexArrays, "num_records",
                        property(lambda self: 300_000_000))
    import utree_tpu.hash_index as hi

    monkeypatch.setattr(hi, "build_displaced_index",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError("too big")))
    monkeypatch.setattr(hi, "build_canonical_hash_index",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError("too big")))
    with pytest.raises(RuntimeError, match="routed"):
        SearchPipeline(idx, lookup_mode="auto", batch_size=8)

    # explicit bsearch stays available at any size
    pipe = SearchPipeline(idx, lookup_mode="bsearch", batch_size=8)
    assert pipe.table_kind == "bsearch"


def test_hist_cap_validated(spec):
    """hist_cap outside the packed 5-bit nuniq range raises (ADVICE r3)."""
    import pytest

    from utree_tpu.build import build_database

    cfg = UTreeConfig()
    res = build_database(spec["refs"], spec["map"], cfg)
    idx = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    for bad in (0, 31, -1, 64):
        with pytest.raises(ValueError, match="hist_cap"):
            SearchPipeline(idx, hist_cap=bad, batch_size=8)


def test_compact_readback_identical(spec, tmp_path):
    """The compact d2h layout (8B/read + overflow block) must reproduce the
    full-layout output byte-for-byte, including its host-replay rows."""
    didx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    outs = {}
    for compact in (True, False):
        pipe = SearchPipeline(didx, do_rc=True, batch_size=128,
                              compact_readback=compact, device_vote=False)
        assert pipe._compact is compact
        out = tmp_path / f"cls_compact_{compact}.txt"
        pipe.search_file(str(spec["reads"]), str(out))
        outs[compact] = out.read_bytes()
    assert outs[True] == outs[False]
    assert outs[True] == spec["cls_rc"].read_bytes()


def test_device_vote_identical(spec, tmp_path):
    """The on-device aufbau (12B/read readback, host formats only) must
    reproduce the full-layout output byte-for-byte, including over-cap
    host replays and chimeric >= 2-label reads."""
    didx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    from utree_tpu.io.fasta import iter_fasta_records

    refs = [seq for _, seq in iter_fasta_records(spec["refs"])]
    rng = np.random.default_rng(7)
    chimeric = []
    for i in range(48):
        a, b = rng.choice(len(refs), size=2, replace=False)
        pa = rng.integers(0, len(refs[a]) - 80)
        pb = rng.integers(0, len(refs[b]) - 80)
        chimeric.append(b">c%d\n%s\n" % (
            i, refs[a][pa : pa + 80] + refs[b][pb : pb + 80]))
    reads2 = tmp_path / "reads_chim.fa"
    reads2.write_bytes(
        open(spec["reads"], "rb").read() + b"".join(chimeric))
    outs = {}
    for dv in (True, False):
        pipe = SearchPipeline(didx, do_rc=True, batch_size=128,
                              device_vote=dv, compact_readback=False)
        assert pipe._devvote is dv
        out = tmp_path / f"cls_devvote_{dv}.txt"
        pipe.search_file(str(reads2), str(out))
        outs[dv] = out.read_bytes()
    assert outs[True] == outs[False]


def test_device_vote_cap_overflow_replay(spec, tmp_path):
    """Reads with nuniq > hist_cap must be flagged by the device vote and
    replayed exactly on host (the override CSR path)."""
    didx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    from utree_tpu.io.fasta import iter_fasta_records

    refs = [seq for _, seq in iter_fasta_records(spec["refs"])]
    rng = np.random.default_rng(11)
    seqs, names = [], []
    for i in range(16):  # splice many refs -> nuniq > cap=2
        parts = []
        for r in rng.choice(len(refs), size=6, replace=False):
            p = rng.integers(0, len(refs[r]) - 60)
            parts.append(refs[r][p : p + 60])
        seqs.append(b"".join(parts))
        names.append(b"m%d" % i)
    pipe = SearchPipeline(didx, do_rc=True, batch_size=16, hist_cap=2)
    assert pipe._devvote
    h = pipe.dispatch(seqs)
    rows = pipe._devvote_rows(h, len(seqs))
    assert ((rows[:, 0] >> 24) & 1).any(), "no read overflowed the cap"
    got = pipe.finalize(names, seqs, pipe.dispatch(seqs))
    ref = SearchPipeline(didx, do_rc=True, batch_size=16, hist_cap=2,
                         device_vote=False)
    want = ref.finalize(names, seqs, ref.dispatch(seqs))
    assert got == want


def test_compact_overflow_redispatches_full(spec, tmp_path):
    """A batch with more >=2-label reads than the overflow block holds must
    be redispatched through the full layout — same bytes, never truncated."""
    didx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    pipe = SearchPipeline(didx, do_rc=True, batch_size=128,
                          compact_over_cap=1, device_vote=False)
    # the toy reads all hit one label; chimeric reads spliced from two
    # references hit >= 2, overflowing the 1-row block and forcing the
    # full-layout redispatch
    from utree_tpu.io.fasta import iter_fasta_records

    refs = [seq for _, seq in iter_fasta_records(spec["refs"])]
    rng = np.random.default_rng(3)
    seqs = []
    for i in range(64):
        a, b = rng.choice(len(refs), size=2, replace=False)
        pa = rng.integers(0, len(refs[a]) - 80)
        pb = rng.integers(0, len(refs[b]) - 80)
        seqs.append(refs[a][pa : pa + 80] + refs[b][pb : pb + 80])
    h = pipe.dispatch(seqs)
    arr = np.asarray(h)
    over_n = int(arr[2 * len(seqs):].reshape(-1, pipe.hist_cap + 1)[0, 0])
    assert over_n > 1, "chimeric batch no longer exercises the overflow block"
    mat = pipe._to_host(h)
    assert mat.shape == (len(seqs), pipe.hist_cap + 1)
    # byte-identical to the full layout over the chimeric batch
    ref_pipe = SearchPipeline(didx, do_rc=True, batch_size=128,
                              compact_readback=False)
    names = [b"c%d" % i for i in range(len(seqs))]
    got = pipe.finalize_bytes(names, seqs, pipe.dispatch(seqs))
    want = ref_pipe.finalize_bytes(names, seqs, ref_pipe.dispatch(seqs))
    assert got == want
    out = tmp_path / "cls_overflow.txt"
    pipe.search_file(str(spec["reads"]), str(out))
    assert out.read_bytes() == spec["cls_rc"].read_bytes()
