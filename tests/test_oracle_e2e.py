"""Golden end-to-end equivalence vs the reference C binaries (toy config),
plus the spec-side checks of the same artifacts that need no reference."""

import pathlib

import numpy as np

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import read_ctr, read_ubt, write_ctr_from_ubt, write_ubt
from utree_tpu.search_host import HostIndex, search_file


def test_ubt_bytes_identical(golden, tmp_path):
    cfg = UTreeConfig()
    res = build_database(golden["refs"], golden["map"], cfg)
    ours = tmp_path / "ours.ubt"
    write_ubt(str(ours), res.words, res.ixs, res.labels.strings, cfg)
    assert ours.read_bytes() == golden["golden"]["ubt"].read_bytes()


def test_ctr_bytes_identical(golden, tmp_path):
    cfg = UTreeConfig()
    ours = tmp_path / "ours.ctr"
    write_ctr_from_ubt(str(golden["golden"]["ubt"]), str(ours), cfg)
    assert ours.read_bytes() == golden["golden"]["ctr"].read_bytes()


def test_build_log_labels_match(golden):
    """Our label table + counts equal the oracle's .gg.log lines."""
    res = build_database(golden["refs"], golden["map"])
    log = golden["golden"]["log"].read_bytes()
    lines = [ln for ln in log.split(b"\n") if ln]
    assert len(lines) == len(res.labels)
    counts = res.label_counts
    for i, ln in enumerate(lines):
        name, _, cnt = ln.partition(b"\t")
        assert name == res.labels.strings[i]
        assert int(cnt) == int(counts[i])


def test_search_classifications_identical(golden, tmp_path):
    idx = HostIndex.from_ctr(str(golden["golden"]["ctr"]))
    out = tmp_path / "cls.txt"
    n = search_file(idx, golden["reads"], str(out), do_rc=False)
    assert n == 1000
    assert out.read_bytes() == golden["golden"]["classifications"].read_bytes()


def test_search_rc_classifications_identical(golden, tmp_path):
    idx = HostIndex.from_ctr(str(golden["golden_rc"]["ctr"]))
    out = tmp_path / "cls_rc.txt"
    search_file(idx, golden["reads"], str(out), do_rc=True)
    assert out.read_bytes() == golden["golden_rc"]["classifications"].read_bytes()


def test_roundtrip_formats(spec, tmp_path):
    cfg = UTreeConfig()
    ubt = read_ubt(str(spec["ubt"]))
    assert ubt.wtype_bytes == 8 and ubt.ixtype_bytes == 2
    assert np.all(np.diff(ubt.words.astype(np.uint64)) > 0)  # strictly ascending
    ctr = read_ctr(str(spec["ctr"]), cfg)
    assert ctr.num_nodes == len(ubt.words)
    assert ctr.labels == ubt.labels
    # suffixes are the low 40 bits of the ubt words, in the same order
    assert np.array_equal(ctr.suffixes, ubt.words & np.uint64((1 << 40) - 1))
    assert np.array_equal(ctr.ixs, ubt.ixs)


def test_odd_reads_match_oracle(spec, tmp_path):
    """Reads shorter than k, all-N reads, and normal reads in one file:
    device output line-for-line identical to the host spec (short/N reads
    silently absent, itree.c:928-932 foundUniq==0)."""
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.pipeline import SearchPipeline

    reads = tmp_path / "odd.fa"
    normal = [l for l in pathlib.Path(spec["reads"]).read_bytes().splitlines() if l][:20]
    body = b">tiny\nACGT\n>alln\n" + b"N" * 200 + b"\n" + b"\n".join(normal) + b"\n"
    reads.write_bytes(body)
    want = tmp_path / "spec.out"
    search_file(HostIndex.from_ctr(str(spec["ctr"])), str(reads), str(want), do_rc=True)
    didx = DeviceIndexArrays.from_ctr(str(spec["ctr"]), UTreeConfig())
    pipe = SearchPipeline(didx, do_rc=True, batch_size=8)
    out = tmp_path / "odd.out"
    pipe.search_file(str(reads), str(out))
    got = out.read_bytes()
    assert got == want.read_bytes()
    assert b"tiny" not in got and b"alln" not in got and got.count(b"\n") > 0
