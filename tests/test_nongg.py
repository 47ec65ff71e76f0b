"""Non-GG (rank-specific) build + search golden tests vs the reference."""

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import write_ctr_from_ubt, write_ubt
from utree_tpu.oracle import run_oracle_pipeline
from utree_tpu.search_host import HostIndex, search_file_shallow


def test_nongg_pipeline_identical(reference_sources, spec, tmp_path):
    gold = run_oracle_pipeline(
        spec["refs"], spec["map"], spec["reads"], str(tmp_path / "oracle"),
        complevel=1, gg=False,
    )
    cfg = UTreeConfig()
    res = build_database(spec["refs"], spec["map"], cfg, do_gg=False)
    ours_ubt = tmp_path / "ours.ubt"
    write_ubt(str(ours_ubt), res.words, res.ixs, res.labels.strings, cfg)
    assert ours_ubt.read_bytes() == gold["ubt"].read_bytes()

    ours_ctr = tmp_path / "ours.ctr"
    write_ctr_from_ubt(str(ours_ubt), str(ours_ctr), cfg)
    assert ours_ctr.read_bytes() == gold["ctr"].read_bytes()

    idx = HostIndex.from_ctr(str(ours_ctr), cfg)
    out = tmp_path / "cls.txt"
    search_file_shallow(idx, spec["reads"], str(out), do_rc=False)
    assert out.read_bytes() == gold["classifications"].read_bytes()


def test_nongg_rc_identical(reference_sources, spec, tmp_path):
    gold = run_oracle_pipeline(
        spec["refs"], spec["map"], spec["reads"], str(tmp_path / "oracle_rc"),
        complevel=1, gg=False, do_rc=True,
    )
    idx = HostIndex.from_ctr(str(gold["ctr"]), UTreeConfig())
    out = tmp_path / "cls_rc.txt"
    search_file_shallow(idx, spec["reads"], str(out), do_rc=True)
    assert out.read_bytes() == gold["classifications"].read_bytes()


def test_shallow_fast_matches_literal_all_sparsities(spec, tmp_path):
    """scan_shallow_fast (batched lookups + divergence fallback) must equal
    the literal word-state-machine replay for every SPARSITY, including the
    skip-after-hit over-shift corruption paths and reads with Ns."""
    import dataclasses

    import numpy as np

    from utree_tpu.io.fasta import iter_fasta_records
    from utree_tpu.search_host import scan_shallow_fast, scan_shallow_literal

    cfg = UTreeConfig()
    res = build_database(spec["refs"], spec["map"], cfg, do_gg=False)
    write_ubt(str(tmp_path / "s.ubt"), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(tmp_path / "s.ubt"), str(tmp_path / "s.ctr"), cfg)
    reads = [s for _, s in iter_fasta_records(spec["reads"])][:120]
    rng = np.random.default_rng(5)
    # splice Ns into some reads to exercise the invalid-char resets
    reads += [r[:40] + b"N" + r[41:] for r in reads[:20]]
    checked_corrupt = 0
    for sparsity in (1, 2, 4, 8):
        c2 = dataclasses.replace(cfg, sparsity=sparsity)
        idx = HostIndex.from_ctr(str(tmp_path / "s.ctr"), c2)
        for r in reads:
            for rc in (False, True):
                a = scan_shallow_literal(idx, r, rc)
                b = scan_shallow_fast(idx, r, rc)
                assert a == b, (sparsity, rc, r[:40])
                if sparsity > 1 and len(a) > 1:
                    checked_corrupt += 1
    assert checked_corrupt > 50  # the corruption path was actually exercised


def test_native_shallow_matches_literal(spec, tmp_path):
    """native/shallow.cpp (the C word state machine, OpenMP batch) must equal
    scan_shallow_literal hit-for-hit on every read, sparsity, and strand."""
    import dataclasses

    import pytest

    from utree_tpu.encode import encode_bases, revcomp_text
    from utree_tpu.io.fasta import iter_fasta_records
    from utree_tpu.native import shallow_lib, shallow_scan_batch
    from utree_tpu.search_host import scan_shallow_literal

    if shallow_lib() is None:
        pytest.skip("no native toolchain")
    cfg = UTreeConfig()
    res = build_database(spec["refs"], spec["map"], cfg, do_gg=False)
    write_ubt(str(tmp_path / "n.ubt"), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(tmp_path / "n.ubt"), str(tmp_path / "n.ctr"), cfg)
    reads = [s for _, s in iter_fasta_records(spec["reads"])][:120]
    reads += [r[:40] + b"N" + r[41:] for r in reads[:20]]
    reads += [b"", b"ACGT", b"N" * 40]  # shorter than a window / all-invalid
    for sparsity in (1, 2, 4, 8):
        c2 = dataclasses.replace(cfg, sparsity=sparsity)
        idx = HostIndex.from_ctr(str(tmp_path / "n.ctr"), c2)
        for rc in (False, True):
            ext = [encode_bases(r + b"N" + revcomp_text(r) if rc else r)
                   for r in reads]
            got = shallow_scan_batch(idx, ext)
            want = [scan_shallow_literal(idx, r, rc) for r in reads]
            assert got == want, (sparsity, rc)
