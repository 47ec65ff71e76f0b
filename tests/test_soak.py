"""Mid-scale randomized soak vs the compiled reference oracle.

The quirky paths (merged bins, fold erosion, hist-cap overflow, long reads,
resume) each have targeted tests; this soak makes them CO-OCCUR at a scale
where spill tables, conflicted reads, and mixed lengths interact: ~2K
refs/labels, 100K reads (RC on), byte-compared against the single-threaded
reference binary end-to-end (SURVEY.md §4 test-strategy gap); it skips when
the reference sources are absent.

Run explicitly with:  pytest tests/test_soak.py -m soak --no-header -q
(deselected by default via the `soak` marker to keep CI under minutes).
"""

import numpy as np
import pytest

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import write_ctr_from_ubt, write_ubt
from utree_tpu.oracle import run_oracle_pipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads


@pytest.mark.soak
def test_midscale_soak_vs_oracle(reference_sources, tmp_path):
    wd = tmp_path
    # ~2K refs sharing lineages (conflict folds), 10MB of genome
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"),
                       num_refs=2000, ref_len=5000, seed=9001,
                       num_lineages=240, n_prob=0.001)
    # 100K reads, mixed lengths: 80% 150bp, 15% 400bp, 5% long (80Kb)
    rng = np.random.default_rng(9002)
    make_toy_reads(str(wd / "r150.fa"), recs, num_reads=80_000, read_len=150,
                   seed=9003, mutate_prob=0.02, random_frac=0.08)
    make_toy_reads(str(wd / "r400.fa"), recs, num_reads=15_000, read_len=400,
                   seed=9004, mutate_prob=0.02, random_frac=0.08)
    # conflicted reads: chimeras stitched from many refs -> hist-cap overflow
    with open(wd / "rmix.fa", "wb") as f:
        for i in range(4_000):
            parts = []
            for _ in range(12):
                _, _, ref = recs[rng.integers(0, len(recs))]
                st = int(rng.integers(0, len(ref) - 60))
                parts.append(ref[st:st + 60])
            f.write(b">chim%d\n" % i + b"".join(parts) + b"\n")
        for i in range(1_000):  # long reads through the chunked path
            _, _, ref = recs[rng.integers(0, len(recs))]
            reps = b"".join(ref[int(rng.integers(0, 2000)):][:4000]
                            for _ in range(20))
            f.write(b">long%d\n" % i + reps + b"\n")
    # one interleaved file, record order preserved
    with open(wd / "reads.fa", "wb") as out:
        for name in ("r150.fa", "r400.fa", "rmix.fa"):
            out.write((wd / name).read_bytes())

    cfg = UTreeConfig(complevel=2)
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    write_ubt(str(wd / "db.ubt"), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(wd / "db.ubt"), str(wd / "db.ctr"), cfg)

    gold = run_oracle_pipeline(str(wd / "refs.fa"), str(wd / "tax.map"),
                               str(wd / "reads.fa"), str(wd / "oracle"),
                               complevel=2, do_rc=True)
    assert (wd / "db.ubt").read_bytes() == gold["ubt"].read_bytes()
    assert (wd / "db.ctr").read_bytes() == gold["ctr"].read_bytes()

    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.pipeline import SearchPipeline

    idx = DeviceIndexArrays.from_ctr(str(wd / "db.ctr"), cfg)
    pipe = SearchPipeline(idx, do_rc=True, batch_size=4096)
    pipe.stream_chunk_bytes = 4 << 20  # many pieces
    pipe.search_file(str(wd / "reads.fa"), str(wd / "out.txt"))
    assert (wd / "out.txt").read_bytes() == gold["classifications"].read_bytes()
