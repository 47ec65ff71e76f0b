"""PACKSIZE=16 (small-k) goldens — the reference compiles k in {4,8,16,32,64}
(itree.c:41-43,55-70); k=16 is the smallest with a coherent CTR (3-byte
records: 1 suffix byte + u16 ix).  k=4/8 words are narrower than the 24-bit
CTR prefix, so (like the reference) only BUILD is supported for them."""

import numpy as np
import pytest

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import read_ubt, write_ctr_from_ubt, write_ubt
from utree_tpu.oracle import run_oracle_pipeline
from utree_tpu.search_host import HostIndex, search_file
from utree_tpu.testdata import make_toy_db, make_toy_reads

CFG16 = UTreeConfig(packsize=16)
DEFS = ("PACKSIZE=16",)


@pytest.fixture(scope="module")
def toy16(reference_sources, tmp_path_factory):
    wd = tmp_path_factory.mktemp("toy16")
    records = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"),
                          num_refs=6, ref_len=2000, seed=55)
    make_toy_reads(str(wd / "reads.fa"), records, num_reads=250,
                   read_len=120, seed=56)
    golden = run_oracle_pipeline(
        str(wd / "refs.fa"), str(wd / "tax.map"), str(wd / "reads.fa"),
        str(wd / "oracle"), complevel=1, extra_defs=DEFS, suffix="-16",
    )
    return {"dir": wd, "golden": golden}


def test_ubt16_bytes_identical(toy16, tmp_path):
    wd = toy16["dir"]
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), CFG16)
    ours = tmp_path / "ours.ubt"
    write_ubt(str(ours), res.words, res.ixs, res.labels.strings, CFG16)
    assert ours.read_bytes() == toy16["golden"]["ubt"].read_bytes()


def test_ctr16_bytes_identical(toy16, tmp_path):
    ours = tmp_path / "ours.ctr"
    write_ctr_from_ubt(str(toy16["golden"]["ubt"]), str(ours), CFG16)
    assert ours.read_bytes() == toy16["golden"]["ctr"].read_bytes()


def test_search16_classifications_identical(toy16, tmp_path):
    idx = HostIndex.from_ctr(str(toy16["golden"]["ctr"]), CFG16)
    out = tmp_path / "cls.txt"
    search_file(idx, str(toy16["dir"] / "reads.fa"), str(out), do_rc=False)
    assert out.read_bytes() == toy16["golden"]["classifications"].read_bytes()


def test_search16_rc_identical(toy16, tmp_path):
    wd = toy16["dir"]
    golden = run_oracle_pipeline(
        str(wd / "refs.fa"), str(wd / "tax.map"), str(wd / "reads.fa"),
        str(tmp_path / "oracle_rc"), complevel=1, do_rc=True,
        extra_defs=DEFS, suffix="-16",
    )
    idx = HostIndex.from_ctr(str(golden["ctr"]), CFG16)
    out = tmp_path / "cls_rc.txt"
    search_file(idx, str(wd / "reads.fa"), str(out), do_rc=True)
    assert out.read_bytes() == golden["classifications"].read_bytes()


@pytest.mark.parametrize("k", [4, 8])
def test_tiny_k_build_roundtrip(k, tmp_path):
    """k=4/8 .ubt write/read round-trips (words are 1/2 bytes); compression
    is rejected with a clear error, matching the reference's k>=16 CTR."""
    # PFBITS must fit the word (the reference would need -D PFBITS too)
    cfg = UTreeConfig(packsize=k, pfbits=k)
    records = make_toy_db(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"),
                          num_refs=3, ref_len=400, seed=60 + k)
    res = build_database(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"), cfg)
    ubt = tmp_path / "db.ubt"
    write_ubt(str(ubt), res.words, res.ixs, res.labels.strings, cfg)
    back = read_ubt(str(ubt))
    assert back.wtype_bytes == cfg.wtype_bytes
    assert np.array_equal(back.words.astype(np.uint64),
                          np.asarray(res.words, np.uint64))
    assert np.array_equal(back.ixs, np.asarray(res.ixs, np.int64))
    with pytest.raises(ValueError, match="cannot be compressed"):
        write_ctr_from_ubt(str(ubt), str(tmp_path / "db.ctr"), cfg)
