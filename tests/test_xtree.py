"""XTree capability layer: device-vs-host equality on the in-repo build, and
golden tests vs the reference xtree binary where its sources exist."""

import pytest

from utree_tpu.oracle import run_xtree_oracle
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu.xtree.align import AlignOptions, XtreeAligner
from utree_tpu.xtree.build import build_xtree_db, read_xtr, write_xtr


@pytest.fixture(scope="module")
def xtoy(tmp_path_factory):
    """Toy refs/reads with a 3-column map, and spec.xtr built in-repo."""
    wd = tmp_path_factory.mktemp("xtoy")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), num_refs=8, ref_len=3000, seed=21)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=300, read_len=120, seed=31)
    rows = [l.split(b"\t") for l in (wd / "tax.map").read_bytes().split(b"\n") if l]
    with open(wd / "tax3.map", "wb") as f:
        for i, (k, v) in enumerate(rows):
            f.write(k + b"\t" + v + b"\tfunc__" + str(i % 3).encode() + b"\n")
    write_xtr(build_xtree_db(str(wd / "refs.fa"), str(wd / "tax3.map"), k=29, comp=0),
              str(wd / "spec.xtr"))
    return wd


@pytest.fixture(scope="module")
def xgold(reference_sources, xtoy):
    """gold.xtr: the same inputs through the reference BUILD."""
    run_xtree_oracle([
        "BUILD", "--seqs", str(xtoy / "refs.fa"), "--map", str(xtoy / "tax3.map"),
        "--db-out", str(xtoy / "gold.xtr"), "--k", "29", "--comp", "0",
    ])
    return xtoy


def test_xtr_build_bytes_identical(xgold, tmp_path):
    xtoy = xgold
    db = build_xtree_db(str(xtoy / "refs.fa"), str(xtoy / "tax3.map"), k=29, comp=0)
    ours = tmp_path / "ours.xtr"
    write_xtr(db, str(ours))
    assert ours.read_bytes() == (xtoy / "gold.xtr").read_bytes()


def test_xtr_build_comp2_identical(reference_sources, xtoy, tmp_path):
    run_xtree_oracle([
        "BUILD", "--seqs", str(xtoy / "refs.fa"), "--map", str(xtoy / "tax3.map"),
        "--db-out", str(tmp_path / "gold2.xtr"), "--k", "29", "--comp", "2",
    ])
    db = build_xtree_db(str(xtoy / "refs.fa"), str(xtoy / "tax3.map"), k=29, comp=2)
    write_xtr(db, str(tmp_path / "ours2.xtr"))
    assert (tmp_path / "ours2.xtr").read_bytes() == (tmp_path / "gold2.xtr").read_bytes()


def test_align_outputs_identical(xgold, tmp_path):
    xtoy = xgold
    run_xtree_oracle([
        "ALIGN", "--db", str(xtoy / "gold.xtr"), "--seqs", str(xtoy / "reads.fa"),
        "--perq-out", str(tmp_path / "g_perq.tsv"), "--ref-out", str(tmp_path / "g_ref.tsv"),
        "--tax-out", str(tmp_path / "g_tax.tsv"), "--cov-out", str(tmp_path / "g_cov.tsv"),
    ])
    al = XtreeAligner(read_xtr(str(xtoy / "gold.xtr")))
    al.align_file(str(xtoy / "reads.fa"), AlignOptions(
        perq_out=str(tmp_path / "o_perq.tsv"), ref_out=str(tmp_path / "o_ref.tsv"),
        tax_out=str(tmp_path / "o_tax.tsv"), cov_out=str(tmp_path / "o_cov.tsv"),
    ))
    for name in ["perq", "ref", "tax", "cov"]:
        assert (tmp_path / f"o_{name}.tsv").read_bytes() == (tmp_path / f"g_{name}.tsv").read_bytes(), name


def test_align_redistribute_identical(xgold, tmp_path):
    xtoy = xgold
    run_xtree_oracle([
        "ALIGN", "--db", str(xtoy / "gold.xtr"), "--seqs", str(xtoy / "reads.fa"),
        "--perq-out", str(tmp_path / "g_perq.tsv"), "--ref-out", str(tmp_path / "g_ref.tsv"),
        "--tax-out", str(tmp_path / "g_tax.tsv"), "--redistribute",
    ])
    al = XtreeAligner(read_xtr(str(xtoy / "gold.xtr")))
    al.align_file(str(xtoy / "reads.fa"), AlignOptions(
        perq_out=str(tmp_path / "o_perq.tsv"), ref_out=str(tmp_path / "o_ref.tsv"),
        tax_out=str(tmp_path / "o_tax.tsv"), do_redist=True,
    ))
    for name in ["perq", "ref", "tax"]:
        assert (tmp_path / f"o_{name}.tsv").read_bytes() == (tmp_path / f"g_{name}.tsv").read_bytes(), name


def test_orthog_writer_works(xtoy, tmp_path):
    """The reference v0.92i orthog writer segfaults unconditionally (OOB read
    at xtree.c:1508 on singleton hash buckets) — no golden comparison is
    possible.  We implement the documented intent: (H1,H2) cross-tab counts."""
    al = XtreeAligner(read_xtr(str(xtoy / "spec.xtr")))
    al.align_file(str(xtoy / "reads.fa"), AlignOptions(
        tax_out=str(tmp_path / "o_tax.tsv"), orthog_out=str(tmp_path / "o_orthog.tsv"),
    ))
    lines = [l for l in (tmp_path / "o_orthog.tsv").read_bytes().split(b"\n") if l]
    assert lines, "orthog output should be non-empty"
    for ln in lines:
        cols = ln.split(b"\t")
        assert len(cols) == 3 and int(cols[2]) >= 0


def test_fastq_gz_queries(xtoy, tmp_path):
    """gz FASTQ ingestion (get_queries, xtree.c:180-204)."""
    import gzip

    reads = (xtoy / "reads.fa").read_bytes().strip().split(b"\n")
    with gzip.open(tmp_path / "reads.fq.gz", "wb") as f:
        for i in range(0, len(reads), 2):
            name, seq = reads[i][1:], reads[i + 1]
            f.write(b"@" + name + b"\n" + seq + b"\n+\n" + b"I" * len(seq) + b"\n")
    al = XtreeAligner(read_xtr(str(xtoy / "spec.xtr")))
    al.align_file(str(tmp_path / "reads.fq.gz"), AlignOptions(perq_out=str(tmp_path / "fq_perq.tsv")))
    al.align_file(str(xtoy / "reads.fa"), AlignOptions(perq_out=str(tmp_path / "fa_perq.tsv")))
    assert (tmp_path / "fq_perq.tsv").read_bytes() == (tmp_path / "fa_perq.tsv").read_bytes()


@pytest.mark.parametrize("conf,full_lca,redist", [
    (0.33, True, False),
    (0.95, True, True),   # high confidence forces the deep/aufbau paths
    (0.95, True, False),  # aufbau + the native formatting tail (lv>0 cuts)
    (0.95, False, False),  # shallow early-exit branch
    (0.0, True, True),     # ag_thres = 0 edge (loop runs to the level cap)
    (0.0, True, False),    # ag_thres = 0 through the fused native deep call
])
def test_batch_engine_matches_scalar(tmp_path, conf, full_lca, redist):
    """Property test: the vectorized chunk engine's output bytes equal the
    literal per-query replay on randomized data that exercises conflicted
    hits, mutations, random reads, and chunk boundaries."""
    recs = make_toy_db(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"),
                       num_refs=12, ref_len=2500, seed=61, num_lineages=2)
    make_toy_reads(str(tmp_path / "reads.fa"), recs, num_reads=700,
                   read_len=100, seed=71, mutate_prob=0.08, random_frac=0.15)
    rows = [l.split(b"\t") for l in (tmp_path / "tax.map").read_bytes().split(b"\n") if l]
    with open(tmp_path / "tax3.map", "wb") as f:
        for i, (k, v) in enumerate(rows):
            f.write(k + b"\t" + v + b"\tfunc__" + str(i % 4).encode() + b"\n")
    db = build_xtree_db(str(tmp_path / "refs.fa"), str(tmp_path / "tax3.map"),
                        k=29, comp=0)
    al = XtreeAligner(db)
    al.chunk_queries = 97  # prime -> many ragged chunk boundaries

    def opts(tag):
        return AlignOptions(
            confidence=conf, do_full_lca=full_lca, do_redist=redist,
            perq_out=str(tmp_path / f"{tag}_perq.tsv"),
            ref_out=str(tmp_path / f"{tag}_ref.tsv"),
            tax_out=str(tmp_path / f"{tag}_tax.tsv"),
            cov_out=str(tmp_path / f"{tag}_cov.tsv"))

    al.align_file(str(tmp_path / "reads.fa"), opts("b"))
    al.align_file_scalar(str(tmp_path / "reads.fa"), opts("s"))
    for name in ["perq", "ref", "tax", "cov"]:
        b = (tmp_path / f"b_{name}.tsv").read_bytes()
        s = (tmp_path / f"s_{name}.tsv").read_bytes()
        assert b == s, name


def test_onepast_hardstop_vs_oracle(reference_sources, tmp_path):
    """LBS_k can 'hit' one pod PAST the probed bin (the C checks KP[L] at
    L == bin size); the vote expansion then clamps at the probed bin's
    hardstop (xtree.c:1108), so such entries count toward tix but tally no
    refs.  Seeds 307/1307 deterministically produce such a hit."""
    recs = make_toy_db(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"),
                       num_refs=9, ref_len=2800, seed=307)
    make_toy_reads(str(tmp_path / "reads.fa"), recs, num_reads=400,
                   read_len=110, seed=1307, mutate_prob=0.05)
    run_xtree_oracle([
        "BUILD", "--seqs", str(tmp_path / "refs.fa"), "--map", str(tmp_path / "tax.map"),
        "--db-out", str(tmp_path / "g.xtr"), "--k", "29", "--comp", "0",
    ])
    db = read_xtr(str(tmp_path / "g.xtr"))
    al = XtreeAligner(db)
    # precondition: the quirk actually triggers on this input
    from utree_tpu.xtree.io import iter_queries
    seqs = [s for _, s in iter_queries(str(tmp_path / "reads.fa"))]
    qid, pres, seeds = al._batch_hits(seqs)
    assert (seeds >= al.bins[pres + 1]).any(), "fixture no longer triggers one-past"
    run_xtree_oracle([
        "ALIGN", "--db", str(tmp_path / "g.xtr"), "--seqs", str(tmp_path / "reads.fa"),
        "--perq-out", str(tmp_path / "g_perq.tsv"), "--tax-out", str(tmp_path / "g_tax.tsv"),
    ])
    al.align_file(str(tmp_path / "reads.fa"), AlignOptions(
        perq_out=str(tmp_path / "o_perq.tsv"), tax_out=str(tmp_path / "o_tax.tsv")))
    for name in ["perq", "tax"]:
        assert (tmp_path / f"o_{name}.tsv").read_bytes() == (tmp_path / f"g_{name}.tsv").read_bytes(), name


def test_device_hits_equal_host(xtoy):
    """Device displaced-hash front end produces the identical (qid, prefix,
    seed) hit arrays as the host LBS_k replay — one-past quirk included."""
    import numpy as np

    from utree_tpu.xtree.io import iter_queries

    db = read_xtr(str(xtoy / "spec.xtr"))
    host = XtreeAligner(db)
    dev = XtreeAligner(db, use_device=True)
    heads, seqs = [], []
    for h, s in iter_queries(str(xtoy / "reads.fa")):
        heads.append(h)
        seqs.append(s)
    # add adversarial queries: Ns, short, all-A, and a long stitched one
    seqs += [b"ACGTN" * 30, b"ACG", b"A" * 64, seqs[0] + b"N" + seqs[1]]
    qh, ph, sh = host._batch_hits(seqs)
    qd, pd, sd = dev._batch_hits_device(seqs)
    assert np.array_equal(qh, qd)
    assert np.array_equal(ph, pd)
    assert np.array_equal(sh, sd)


def test_device_align_outputs_identical(xtoy, tmp_path):
    """Full ALIGN with the device front end == the host engine."""
    db = read_xtr(str(xtoy / "spec.xtr"))
    for tag, use_device in (("g", False), ("o", True)):
        XtreeAligner(db, use_device=use_device).align_file(
            str(xtoy / "reads.fa"), AlignOptions(
                perq_out=str(tmp_path / f"{tag}_perq.tsv"),
                ref_out=str(tmp_path / f"{tag}_ref.tsv"),
                tax_out=str(tmp_path / f"{tag}_tax.tsv"),
                cov_out=str(tmp_path / f"{tag}_cov.tsv"),
            ))
    for name in ["perq", "ref", "tax", "cov"]:
        assert (tmp_path / f"o_{name}.tsv").read_bytes() == (tmp_path / f"g_{name}.tsv").read_bytes(), name


def test_build_log_identical(reference_sources, xtoy, tmp_path):
    """X11 golden: per-ref TotalKmers/UniqKmers build log byte-identical to
    the reference's --log-out tally (xtree.c:476-529), both comp levels."""
    from utree_tpu.xtree.build import write_build_log

    for comp in (0, 2):
        run_xtree_oracle([
            "BUILD", "--seqs", str(xtoy / "refs.fa"), "--map", str(xtoy / "tax3.map"),
            "--db-out", str(tmp_path / f"g{comp}.xtr"), "--k", "29",
            "--comp", str(comp), "--log-out", str(tmp_path / f"gold{comp}.log"),
        ])
        db = build_xtree_db(str(xtoy / "refs.fa"), str(xtoy / "tax3.map"),
                            k=29, comp=comp)
        write_build_log(db, str(tmp_path / f"ours{comp}.log"))
        assert (tmp_path / f"ours{comp}.log").read_bytes() == \
            (tmp_path / f"gold{comp}.log").read_bytes(), f"comp={comp}"


def test_native_scan_equals_numpy_spec():
    """The C++ scan engine (native/xtree.cpp) must emit exactly the NumPy
    spec twin's (qid, prefix, seed) triples — random queries with ambiguous
    bases, short reads, and empty queries included."""
    import numpy as np

    from utree_tpu.native import xt_scan_hits, xtree_lib

    lib = xtree_lib()
    assert lib is not None, "native xtree engine failed to compile"
    import os
    import tempfile

    from utree_tpu.testdata import make_toy_db
    from utree_tpu.xtree.align import XtreeAligner
    from utree_tpu.xtree.build import build_xtree_db

    wd = tempfile.mkdtemp(prefix="xt_native_")
    refs, taxmap = os.path.join(wd, "r.fa"), os.path.join(wd, "t.map")
    make_toy_db(refs, taxmap, num_refs=8, ref_len=4000, seed=31)
    db = build_xtree_db(refs, taxmap, k=29, comp=0)
    al = XtreeAligner(db)
    rng = np.random.default_rng(32)
    ref_seqs = []
    with open(refs, "rb") as f:
        for line in f:
            if not line.startswith(b">"):
                ref_seqs.append(line.strip())
    seqs = []
    for i in range(300):
        src = ref_seqs[int(rng.integers(len(ref_seqs)))]
        ln = int(rng.integers(5, 200))
        p = int(rng.integers(0, max(1, len(src) - ln)))
        s = bytearray(src[p : p + ln])
        for j in range(len(s)):
            if rng.random() < 0.03:
                s[j] = int(rng.choice(np.frombuffer(b"ACGTNnacgt@", np.uint8)))
        seqs.append(bytes(s))
    seqs += [b"", b"A" * 28, b"N" * 50]
    want = al._batch_hits(seqs)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    got = xt_scan_hits(lib, b"".join(seqs), offsets[:-1], offsets[1:],
                       al.k, al.pl, al.bins, al.sfx)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_native_tallies_equal_numpy_spec(tmp_path):
    """xt_ref_tally / xt_h_tally (C++) must reproduce the NumPy spec twins'
    CSRs, insertion keys, and max/max2/argmax exactly."""
    import os
    import tempfile

    import numpy as np

    from utree_tpu.native import xtree_lib
    from utree_tpu.testdata import make_toy_db, make_toy_reads
    from utree_tpu.xtree.align import XtreeAligner
    from utree_tpu.xtree.build import build_xtree_db

    lib = xtree_lib()
    assert lib is not None
    wd = tempfile.mkdtemp(prefix="xt_tally_")
    refs, taxmap, reads = [os.path.join(wd, f) for f in
                           ("r.fa", "t.map", "q.fa")]
    recs = make_toy_db(refs, taxmap, num_refs=10, ref_len=3000, seed=41,
                       num_lineages=3)
    make_toy_reads(reads, recs, num_reads=400, read_len=90, seed=42,
                   mutate_prob=0.05, random_frac=0.2)
    db = build_xtree_db(refs, taxmap, k=29, comp=0)
    al = XtreeAligner(db)
    from utree_tpu.io.fasta import iter_fasta_records

    seqs = [s for _, s in iter_fasta_records(reads)]
    Q = len(seqs)
    qid_h, pres_h, seeds_h = al._batch_hits(seqs)
    nat_lib, al._xt_lib = al._xt_lib, None  # numpy spec
    mxn, mx2n, mixn, rtn = al._batch_ref_tally(qid_h, pres_h, seeds_h, Q)
    hn = [al._batch_h_tally(qid_h, pres_h, seeds_h, al.h_pairs[0],
                            al.n_uniq_h[0], Q, lbin=lb)
          for lb in [None] + list(al.lbins[0][:3])]
    al._xt_lib = nat_lib
    mxc, mx2c, mixc, rtc = al._batch_ref_tally_native(qid_h, pres_h, seeds_h, Q)
    hc = [al._batch_h_tally(qid_h, pres_h, seeds_h, al.h_pairs[0],
                            al.n_uniq_h[0], Q, lbin=lb)
          for lb in [None] + list(al.lbins[0][:3])]
    assert np.array_equal(mxn, mxc) and np.array_equal(mx2n, mx2c)
    assert np.array_equal(mixn, mixc)
    for f in ("qu", "rxu", "counts", "first", "uniq"):
        assert np.array_equal(getattr(rtn, f), getattr(rtc, f)), f
    for a, b in zip(hn, hc):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
