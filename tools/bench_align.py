"""xtree ALIGN throughput bench (queries/s) — the xtree.c:1002-1081 hot loop.

Builds a synthetic xtree DB, generates reads, and times align_file (batch
engine) vs align_file_scalar (literal replay) on the same input.

  python tools/bench_align.py [--refs 64] [--ref-len 200000] [--reads 20000]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refs", type=int, default=64)
    ap.add_argument("--ref-len", type=int, default=200_000)
    ap.add_argument("--reads", type=int, default=20_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--scalar", action="store_true", help="also time the scalar replay")
    ap.add_argument("--device", action="store_true",
                    help="use the device displaced-hash k-mer front end")
    ap.add_argument("--ref", action="store_true",
                    help="also time the compiled reference xtree ALIGN "
                         "(OMP_NUM_THREADS=1) on the same DB/reads and "
                         "byte-compare the outputs")
    a = ap.parse_args()

    from utree_tpu.testdata import make_toy_db, make_toy_reads
    from utree_tpu.xtree.align import AlignOptions, XtreeAligner
    from utree_tpu.xtree.build import build_xtree_db

    wd = tempfile.mkdtemp(prefix="xalign_bench_")
    refs = os.path.join(wd, "refs.fa")
    taxmap = os.path.join(wd, "tax.map")
    reads = os.path.join(wd, "reads.fa")
    recs = make_toy_db(refs, taxmap, num_refs=a.refs, ref_len=a.ref_len,
                       seed=5, num_lineages=max(2, a.refs // 6))
    make_toy_reads(reads, recs, num_reads=a.reads, read_len=a.read_len,
                   seed=6, mutate_prob=0.02, random_frac=0.1)

    t0 = time.perf_counter()
    db = build_xtree_db(refs, taxmap, k=29, comp=0)
    print(f"build: {time.perf_counter() - t0:.2f}s ({db.num_kmers} kpods, "
          f"{db.num_refs} refs)")

    t0 = time.perf_counter()
    al = XtreeAligner(db, use_device=a.device)
    if a.device:
        print(f"device index: {time.perf_counter() - t0:.2f}s")
    opts = AlignOptions(perq_out=os.path.join(wd, "perq.tsv"),
                        ref_out=os.path.join(wd, "ref.tsv"),
                        tax_out=os.path.join(wd, "tax.tsv"))
    if a.device:  # exclude the one-time jit compile from the steady rate
        al._batch_hits_device([b"A" * a.read_len] * 256)
    t0 = time.perf_counter()
    al.align_file(reads, opts)
    dt = time.perf_counter() - t0
    mode = "device" if a.device else "batch "
    print(f"{mode}: {a.reads / dt:,.0f} queries/s  ({dt:.2f}s)")

    if a.scalar:
        t0 = time.perf_counter()
        al.align_file_scalar(reads, opts)
        ds = time.perf_counter() - t0
        print(f"scalar: {a.reads / ds:,.0f} queries/s  ({ds:.2f}s)  "
              f"speedup {ds / dt:,.1f}x")

    if a.ref:
        import subprocess

        from utree_tpu.oracle import build_xtree_oracle
        from utree_tpu.xtree.build import write_xtr

        xtr = os.path.join(wd, "db.xtr")
        write_xtr(db, xtr)  # byte-identical to the reference BUILD (golden)
        exe = build_xtree_oracle()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        g_perq = os.path.join(wd, "g_perq.tsv")
        g_ref = os.path.join(wd, "g_ref.tsv")
        g_tax = os.path.join(wd, "g_tax.tsv")
        t0 = time.perf_counter()
        subprocess.run(
            [str(exe), "ALIGN", "--db", xtr, "--seqs", reads,
             "--perq-out", g_perq, "--ref-out", g_ref, "--tax-out", g_tax,
             "--threads", "1"],
            check=True, capture_output=True, env=env)
        dr = time.perf_counter() - t0
        print(f"reference xtree ALIGN (1 thread): {a.reads / dr:,.0f} "
              f"queries/s  ({dr:.2f}s)  ours/ref = {dr / dt:.2f}x")
        for ours, ref_f in ((opts.perq_out, g_perq), (opts.ref_out, g_ref),
                            (opts.tax_out, g_tax)):
            same = open(ours, "rb").read() == open(ref_f, "rb").read()
            print(f"  {os.path.basename(ref_f)}: byte-identical = {same}")
            if not same:
                raise SystemExit(1)


if __name__ == "__main__":
    main()
