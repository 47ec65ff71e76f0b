"""Command-line interface mirroring both reference tools.

utree family (itree.c:1351-1413 positional argv):
  utree-tpu build    <in.fa> <map> <out.ubt> [--complevel N] [--rank-specific]
  utree-tpu compress <in.ubt> <out.ctr>
  utree-tpu search   <db.ctr> <reads.fa> <out.txt> [--rc] [--rank-specific]
                     [--host] [--batch N]

xtree family (xtree.c:206-256 flag parser):
  utree-tpu xtree-build --seqs fa --db-out db [--map m --comp c --k k]
  utree-tpu xtree-align --db db --seqs q [--confidence f --perq-out ...
                     --ref-out --tax-out --cov-out --orthog-out
                     --redistribute --fast-redistribute --shallow-lca]
"""

from __future__ import annotations

import argparse
import sys


def _cmd_build(a):
    from utree_tpu.build import build_database
    from utree_tpu.config import UTreeConfig
    from utree_tpu.formats import write_ubt

    cfg = UTreeConfig(complevel=a.complevel)
    res = build_database(a.fasta, a.map, cfg, do_gg=not a.rank_specific)
    write_ubt(a.out, res.words, res.ixs, res.labels.strings, cfg)
    log = a.out + (".gg.log" if not a.rank_specific else ".log")
    with open(log, "wb") as f:
        for s, c in zip(res.labels.strings, res.label_counts):
            f.write(s + b"\t" + str(int(c)).encode() + b"\n")
    print(f"Built {len(res.words)} k-mers, {len(res.labels)} labels -> {a.out}")


def _cmd_compress(a):
    from utree_tpu.formats import sniff_config, write_ctr_from_ubt

    write_ctr_from_ubt(a.input, a.out, sniff_config(a.input))
    print(f"Compressed {a.input} -> {a.out}")


def _cmd_search(a):
    from utree_tpu.formats import sniff_config
    from utree_tpu.utils.trace import PhaseTimer, Tracer

    tm = PhaseTimer(quiet=True) if a.trace else None
    pipe = None
    cfg = sniff_config(a.db)
    if cfg.packsize not in (32, 64) and not a.host and not a.rank_specific:
        # the device window extractor implements the 32/64-mer geometries;
        # small-k DBs (PACKSIZE=16) run the exact host path instead of
        # crashing at first dispatch
        print(f"note: PACKSIZE={cfg.packsize} DB -> host search path "
              "(device path implements k=32/64)")
        a.host = True
    if a.rank_specific:
        if a.support_ranges != 1:
            raise SystemExit("--support-ranges applies to the GG vote only "
                             "(the rank-specific output has no SUPPORT;RANGE columns)")
        from utree_tpu.search_host import HostIndex, search_file_shallow

        idx = HostIndex.from_ctr(a.db, cfg)
        n = search_file_shallow(idx, a.reads, a.out, do_rc=a.rc)
    elif a.host:
        from utree_tpu.search_host import HostIndex, search_file

        if tm:
            with tm.phase("load-db"):
                idx = HostIndex.from_ctr(a.db, cfg)
            with tm.phase("search"):
                n = search_file(idx, a.reads, a.out, do_rc=a.rc,
                                support_ranges=a.support_ranges)
            tm.count("reads", n)
        else:
            idx = HostIndex.from_ctr(a.db, cfg)
            n = search_file(idx, a.reads, a.out, do_rc=a.rc,
                            support_ranges=a.support_ranges)
    elif a.num_hosts:
        from utree_tpu.index import DeviceIndexArrays
        from utree_tpu.parallel.distributed import (init_distributed,
                                                    search_file_multihost)
        from utree_tpu.pipeline import SearchPipeline

        if a.num_hosts > 1 and (a.host_id is None or not a.coordinator):
            raise SystemExit(
                "search --num-hosts N (N>1) requires --host-id and --coordinator")
        if a.num_hosts > 1:
            init_distributed(a.coordinator, a.num_hosts, a.host_id)
        # --num-hosts 1: run the same multihost driver single-process without
        # jax.distributed (which needs a coordinator)
        idx = DeviceIndexArrays.from_ctr(a.db, cfg)
        pipe = SearchPipeline(idx, do_rc=a.rc, batch_size=a.batch,
                              support_ranges=a.support_ranges,
                              lookup_mode=a.lookup_mode, tracer=tm,
                              devices=a.devices or None)
        n = search_file_multihost(pipe, a.reads, a.out, resume=a.resume)
    else:
        from utree_tpu.index import DeviceIndexArrays
        from utree_tpu.pipeline import SearchPipeline

        if tm:
            with tm.phase("load-db"):
                idx = DeviceIndexArrays.from_ctr(a.db, cfg)
            with tm.phase("build-table"):
                pipe = SearchPipeline(idx, do_rc=a.rc, batch_size=a.batch,
                                      support_ranges=a.support_ranges,
                                      lookup_mode=a.lookup_mode, tracer=tm,
                                      devices=a.devices or None)
            with Tracer(a.profile_dir), tm.phase("search"):
                n = pipe.search_file(a.reads, a.out, resume=a.resume)
        else:
            idx = DeviceIndexArrays.from_ctr(a.db, cfg)
            pipe = SearchPipeline(idx, do_rc=a.rc, batch_size=a.batch,
                                  support_ranges=a.support_ranges,
                                  lookup_mode=a.lookup_mode,
                                  devices=a.devices or None)
            with Tracer(a.profile_dir):
                n = pipe.search_file(a.reads, a.out, resume=a.resume)
    if tm:
        if pipe is not None:
            print("search path: " + " ".join(
                f"{k}={v}" for k, v in pipe.describe().items()))
        for name, dt in tm.phases.items():
            print(f"{name} [{dt:.3f}s]")
        rps = tm.rate("reads", "search")
        if rps:
            print(f"throughput: {rps:,.0f} reads/s")
    print(f"Searched {n} queries -> {a.out}")
    return pipe


def _cmd_xtree_build(a):
    from utree_tpu.xtree.build import build_xtree_db, write_xtr

    db = build_xtree_db(a.seqs, a.map, k=a.k, comp=a.comp)
    write_xtr(db, a.db_out)
    print(f"Built xtree DB: {db.num_refs} refs, {db.num_kmers} k-mers -> {a.db_out}")


def _cmd_xtree_align(a):
    from utree_tpu.xtree.align import AlignOptions, XtreeAligner
    from utree_tpu.xtree.build import read_xtr

    conf, n_uniq = 0.33, 0
    if a.confidence is not None:
        if a.confidence <= 1:
            conf = a.confidence
        else:
            n_uniq = int(a.confidence)
    al = XtreeAligner(read_xtr(a.db), use_device=a.device)
    al.align_file(a.seqs, AlignOptions(
        confidence=conf, n_uniq_matches=n_uniq,
        do_full_lca=not a.shallow_lca,
        do_redist=a.redistribute or a.fast_redistribute,
        do_fast_redist=a.fast_redistribute,
        perq_out=a.perq_out, ref_out=a.ref_out, tax_out=a.tax_out,
        cov_out=a.cov_out, orthog_out=a.orthog_out,
    ))
    print("All outputs written.")


def main(argv=None):
    p = argparse.ArgumentParser(prog="utree-tpu", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="utree-buildGG equivalent")
    b.add_argument("fasta"); b.add_argument("map"); b.add_argument("out")
    b.add_argument("--complevel", type=int, default=1)
    b.add_argument("--rank-specific", action="store_true",
                   help="utree-build (non-GG): conflicts poison k-mers")
    b.set_defaults(fn=_cmd_build)

    c = sub.add_parser("compress", help="utree-compress equivalent")
    c.add_argument("input"); c.add_argument("out")
    c.set_defaults(fn=_cmd_compress)

    s = sub.add_parser("search", help="utree-searchGG equivalent")
    s.add_argument("db"); s.add_argument("reads"); s.add_argument("out")
    s.add_argument("--rc", action="store_true", help="also scan reverse complement")
    s.add_argument("--rank-specific", action="store_true", help="utree-search (non-GG) vote")
    s.add_argument("--host", action="store_true", help="host (NumPy) path instead of device")
    s.add_argument("--support-ranges", dest="support_ranges", type=int, choices=(1, 8),
                   default=1, help="SUPPORT;RANGE pairs per line: 1 = the reference "
                   "binary's output (itree.c:1096), 8 = the README-documented "
                   "per-rank variant (host vote)")
    s.add_argument("--batch", type=int, default=8192)
    s.add_argument("--devices", type=int, default=0,
                   help="single-host multi-chip: replicate the table into N "
                        "chips' HBM and shard read batches over them "
                        "(output bytes identical at any N)")
    s.add_argument("--lookup-mode", dest="lookup_mode", default="auto",
                   choices=("auto", "canonical", "displaced", "routed", "hash", "bsearch"),
                   help="device table layout (auto picks by DB size; routed = "
                        "table sharded across --devices N chips for >HBM DBs)")
    s.add_argument("--resume", action="store_true",
                   help="resume an interrupted search from its .ckpt sidecar")
    s.add_argument("--num-hosts", dest="num_hosts", type=int, default=0,
                   help="multi-host mode: total process count (one per host); "
                   "requires --host-id and --coordinator, shared filesystem")
    s.add_argument("--host-id", dest="host_id", type=int, default=None)
    s.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (jax.distributed)")
    s.add_argument("--trace", action="store_true",
                   help="print the resolved search path, per-phase timings "
                   "and reads/s (the "
                   "reference's omp_get_wtime narration, xtree.c:289-473)")
    s.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="capture a jax.profiler device trace to this dir")
    s.set_defaults(fn=_cmd_search)

    xb = sub.add_parser("xtree-build", help="xtree BUILD equivalent")
    xb.add_argument("--seqs", required=True); xb.add_argument("--map")
    xb.add_argument("--db-out", dest="db_out", required=True)
    xb.add_argument("--k", type=int, default=29); xb.add_argument("--comp", type=int, default=0)
    xb.set_defaults(fn=_cmd_xtree_build)

    xa = sub.add_parser("xtree-align", help="xtree ALIGN equivalent")
    xa.add_argument("--db", required=True); xa.add_argument("--seqs", required=True)
    xa.add_argument("--confidence", type=float)
    xa.add_argument("--perq-out", dest="perq_out")
    xa.add_argument("--ref-out", dest="ref_out")
    xa.add_argument("--tax-out", dest="tax_out")
    xa.add_argument("--cov-out", dest="cov_out")
    xa.add_argument("--orthog-out", dest="orthog_out")
    xa.add_argument("--device", action="store_true",
                    help="device displaced-hash k-mer probe (host voting): "
                         "identical outputs, device-speed matching")
    xa.add_argument("--redistribute", action="store_true")
    xa.add_argument("--fast-redistribute", dest="fast_redistribute", action="store_true")
    xa.add_argument("--shallow-lca", dest="shallow_lca", action="store_true")
    xa.set_defaults(fn=_cmd_xtree_align)

    a = p.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    main()
