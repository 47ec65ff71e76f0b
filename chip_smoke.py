#!/usr/bin/env python3
"""Smoke test: the search pipeline end to end on one GPU.

    python chip_smoke.py                 # phases A, B, C on one GPU
    python chip_smoke.py --devices 4     # the 4-GPU path only (see below)
    python chip_smoke.py --profile-dir D # also trace a warm Phase A search into D
                                         # (with --devices 4: one routed batch,
                                         # NCCL kernels counted per device)

Every phase goes through the CLI entry point, `utree_tpu.cli.main`, called
in this process: a second JAX process on the card would find most of its
memory already reserved by this one.

  A  utree search at L4 scale: a 20M-entry synthetic index (k=32,
     complevel 1, 4,096 eight-rank labels; bench.make_tier_index)
     round-tripped through a .ctr, searched with --rc --batch 65536 over
     262,144 x 150bp reads sampled from the genome (1% mutation, 10% random
     rows) plus 4 x 200kb reads that take the long-read path.  The canonical
     table, the device vote and the native C++ scanner and vote must be
     engaged.  Every 64th short read and every long read must equal the host
     spec (search_host.search_file) byte for byte, and the step's compiled
     memory must fit beside the table budget.
  B  the displaced table, which auto mode picks at >= 80M entries, on a
     4M-entry index: --lookup-mode displaced == --lookup-mode canonical over
     the whole output, and == the host spec on the sampled reads.
  C  xtree ALIGN (k=29) on ~20K queries: --device == host-only, for the
     perq, tax and cov outputs.

With --devices 4 only Phase A's database and reads run, under --devices 4
(table replicated) and --devices 4 --lookup-mode routed (table sharded,
all_to_all routing), each compared byte for byte with the one-device run.

The search is integer arithmetic throughout (gathers, compares, a stable
integer argsort in the device vote, no matrix product), so every comparison
is byte identity: no tolerance, and no TF32 precision question.

Reads/s lines are smoke observations that include compilation, not
benchmark numbers.  The last line of standard output is the JSON result; any
failure exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ACGT = b"ACGT"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg) -> None:
    """An assertion that `python -O` keeps."""
    if not ok:
        raise AssertionError(msg)


def _cli(argv: list[str]):
    """utree_tpu.cli.main in this process; returns (result, seconds)."""
    from utree_tpu.cli import main

    t0 = time.perf_counter()
    res = main(argv)
    return res, time.perf_counter() - t0


# ---- data -----------------------------------------------------------------


def make_search_db(wd: str, num_kmers: int, num_labels: int):
    """bench.py's synthetic tier index written as a real .ctr; returns the
    path, the genome it was sampled from and the generator to draw reads."""
    import numpy as np

    from bench import make_tier_index
    from utree_tpu.formats import write_ctr

    _index, sw, ixs, labels, genome, cfg, rng = make_tier_index(num_kmers, num_labels)
    ctr = os.path.join(wd, f"db_{num_kmers}.ctr")
    write_ctr(ctr, sw, ixs, labels, np.ones(len(labels), np.int64), cfg)
    return ctr, genome, rng


def write_reads(path: str, genome, rng, num_reads: int, read_len: int = 150,
                num_long: int = 0, long_len: int = 200_000) -> None:
    """Reads sampled from the genome as bench.py draws them (1% mutation,
    10% random rows), then `num_long` reads of `long_len` bases."""
    import numpy as np

    bases = np.frombuffer(ACGT, np.uint8)
    starts = rng.integers(0, len(genome) - read_len, size=num_reads)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    mut = rng.random(reads.shape) < 0.01
    reads[mut] = rng.choice(bases, size=int(mut.sum()))
    rand_rows = rng.random(num_reads) < 0.10
    reads[rand_rows] = rng.choice(bases, size=(int(rand_rows.sum()), read_len))
    with open(path, "wb") as f:
        f.write(b"".join(b">r%d\n%s\n" % (i, reads[i].tobytes())
                         for i in range(num_reads)))
        for j in range(num_long):
            s = int(rng.integers(0, len(genome) - long_len))
            seq = genome[s : s + long_len].copy()
            m = rng.random(long_len) < 0.01
            seq[m] = rng.choice(bases, size=int(m.sum()))
            f.write(b">long%d\n%s\n" % (j, seq.tobytes()))


def _records(path: str):
    with open(path, "rb") as f:
        while True:
            head = f.readline()
            if not head:
                return
            yield head, f.readline()


def _lines_by_name(path: str) -> dict[bytes, bytes]:
    with open(path, "rb") as f:
        return {ln.split(b"\t", 1)[0]: ln for ln in f}


def check_against_spec(ctr: str, reads: str, out: str, wd: str,
                       every: int = 64) -> int:
    """Every `every`-th short read and every long read of `reads` through the
    host spec; their lines in `out` must be byte-identical (a read with no
    hits has no line in either).  Returns the number of reads compared."""
    from utree_tpu.search_host import HostIndex, search_file

    sample = os.path.join(wd, "spec_sample.fa")
    names = []
    with open(sample, "wb") as f:
        for i, (head, seq) in enumerate(_records(reads)):
            if i % every == 0 or head.startswith(b">long"):
                f.write(head + seq)
                names.append(head[1:].split()[0])
    spec_out = os.path.join(wd, "spec_sample.txt")
    search_file(HostIndex.from_ctr(ctr), sample, spec_out, do_rc=True)
    want, got = _lines_by_name(spec_out), _lines_by_name(out)
    bad = [n for n in names if want.get(n) != got.get(n)]
    check(not bad, f"{len(bad)} of {len(names)} reads differ from the host "
          f"spec, e.g. {bad[:3]}")
    check(len(want) > len(names) // 2, "too few sampled reads classified")
    return len(names)


def _same_bytes(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        check(fa.read() == fb.read(), f"{a} and {b} differ")


def _engaged(pipe) -> dict:
    d = pipe.describe()
    log("  path: " + " ".join(f"{k}={v}" for k, v in d.items()))
    check(d["native_vote"], "native vote engine not loaded (Python fallback)")
    check(d["native_scanner"], "native FASTA scanner not loaded (Python fallback)")
    return d


def _rate(name: str, n: int, dt: float) -> None:
    log(f"  {name}: {n} reads in {dt:.2f}s = {n / dt:,.0f} reads/s "
        "(smoke observation incl. compile, not a benchmark)")


def step_memory(pipe, read_len: int) -> dict:
    """The main step's compiled memory at this pipeline's batch size, beside
    the device memory and the table budget: the step's workspace plus every
    table array but t1 must fit in what the t1 budget leaves free."""
    import jax

    from utree_tpu.memory import device_memory_bytes

    ma = pipe.compiled_step(read_len).memory_analysis()
    table = {k: int(v.nbytes) for k, v in pipe._table.items()}
    big = max(table.values())
    workspace = (ma.temp_size_in_bytes + ma.output_size_in_bytes
                 + ma.argument_size_in_bytes - sum(table.values()))
    limit = device_memory_bytes(jax.devices()[0])
    need = pipe.describe()["t1_cap"] + sum(table.values()) - big + workspace
    out = {"device_bytes": limit, "t1_cap": pipe.describe()["t1_cap"],
           "table_bytes": sum(table.values()), "step_temp_bytes": ma.temp_size_in_bytes,
           "step_workspace_bytes": workspace, "worst_case_bytes": need}
    log("  memory: " + " ".join(f"{k}={v}" for k, v in out.items()))
    check(need <= limit, "a table at the t1 budget would not leave room for the step")
    return out


# ---- phases ---------------------------------------------------------------


def phase_a(wd: str, num_kmers: int = 20_000_000, num_labels: int = 4096,
            num_reads: int = 262_144, num_long: int = 4, long_len: int = 200_000,
            batch: int = 65536, profile_dir: str | None = None) -> dict:
    ctr, genome, rng = make_search_db(wd, num_kmers, num_labels)
    reads = os.path.join(wd, "reads_a.fa")
    write_reads(reads, genome, rng, num_reads, num_long=num_long, long_len=long_len)
    out = os.path.join(wd, "out_a.txt")
    argv = ["search", ctr, reads, out, "--rc", "--batch", str(batch), "--trace"]
    pipe, dt = _cli(argv)
    d = _engaged(pipe)
    check(d["table_kind"] == "canonical", d)
    check(d["device_vote"], "device vote not engaged")
    _rate("phase A search", num_reads + num_long, dt)
    mem = step_memory(pipe, 150)
    n = check_against_spec(ctr, reads, out, wd)
    log(f"  phase A: {n} sampled reads byte-identical to the host spec")
    if profile_dir:
        # the same search again, traced: its shapes are compiled now (jit
        # caches are per pipeline, so the window still holds re-lowering and
        # compile-cache loads), and its output must not change
        traced = os.path.join(wd, "out_a_traced.txt")
        _, dt = _cli(argv[:3] + [traced] + argv[4:] + ["--profile-dir", profile_dir])
        _rate("phase A traced search", num_reads + num_long, dt)
        _same_bytes(out, traced)
        print_trace_summary(profile_dir)
    return {"ctr": ctr, "reads": reads, "out": out, "describe": d, "memory": mem}


def print_trace_summary(profile_dir: str) -> None:
    from utree_tpu.utils.trace import summarize_trace

    t = summarize_trace(profile_dir)
    log(f"  trace {t['device']}: {t['num_events']} kernel events, busy "
        f"{t['busy_ns'] / 1e6:.1f} ms of a {t['window_ns'] / 1e6:.1f} ms window "
        f"(idle share {t['idle_share']})")
    for name, ns, count in t["top_ops"]:
        log(f"    op {ns / 1e6:10.3f} ms {count:6d}x  {name[:100]}")
    for start, length, frames in t["gaps"]:
        log(f"    gap {length / 1e6:9.3f} ms at {start / 1e6:.1f} ms  host: {frames}")


def phase_b(wd: str, num_kmers: int = 4_000_000, num_labels: int = 4096,
            num_reads: int = 65_536, batch: int = 65536) -> dict:
    ctr, genome, rng = make_search_db(wd, num_kmers, num_labels)
    reads = os.path.join(wd, "reads_b.fa")
    write_reads(reads, genome, rng, num_reads)
    outs = {}
    for mode in ("displaced", "canonical"):
        outs[mode] = os.path.join(wd, f"out_b_{mode}.txt")
        pipe, dt = _cli(["search", ctr, reads, outs[mode], "--rc", "--batch",
                         str(batch), "--lookup-mode", mode])
        d = _engaged(pipe)
        check(d["table_kind"] == mode, d)
        _rate(f"phase B {mode}", num_reads, dt)
    _same_bytes(outs["displaced"], outs["canonical"])
    n = check_against_spec(ctr, reads, outs["displaced"], wd)
    log(f"  phase B: displaced == canonical; {n} sampled reads == host spec")
    return outs


def phase_c(wd: str, num_refs: int = 64, ref_len: int = 50_000,
            num_queries: int = 20_000) -> dict:
    from utree_tpu.testdata import make_toy_db, make_toy_reads

    refs, tax, q = (os.path.join(wd, f) for f in ("x_refs.fa", "x_tax.map", "x_q.fa"))
    recs = make_toy_db(refs, tax, num_refs=num_refs, ref_len=ref_len, seed=2901)
    make_toy_reads(q, recs, num_reads=num_queries, read_len=150, seed=2902,
                   mutate_prob=0.02)
    db = os.path.join(wd, "x.xtr")
    _cli(["xtree-build", "--seqs", refs, "--map", tax, "--db-out", db, "--k", "29"])
    names = ("perq", "tax", "cov")
    for tag, flag in (("host", []), ("device", ["--device"])):
        outs = [f"--{n}-out={os.path.join(wd, f'x_{tag}_{n}.tsv')}" for n in names]
        _, dt = _cli(["xtree-align", "--db", db, "--seqs", q, *outs, *flag])
        log(f"  phase C xtree-align {tag}: {num_queries} queries in {dt:.2f}s "
            "(smoke observation incl. compile, not a benchmark)")
    for n in names:
        _same_bytes(os.path.join(wd, f"x_host_{n}.tsv"), os.path.join(wd, f"x_device_{n}.tsv"))
    with open(os.path.join(wd, "x_host_perq.tsv"), "rb") as f:
        check(sum(1 for _ in f) > num_queries // 2, "too few queries aligned")
    log("  phase C: xtree-align --device == host for perq, tax, cov")
    return {"db": db}


def _collectives(pipe) -> list[str]:
    text = pipe.compiled_step(150).as_text()
    return sorted({op for op in ("all-to-all", "all-reduce", "all-gather",
                                 "collective-permute") if op in text})


def trace_one_batch(pipe, reads: str, batch: int, profile_dir: str) -> dict:
    """Trace one dispatch of the first `batch` reads; returns the collective
    (NCCL) kernel counts per device plane."""
    import jax
    import numpy as np

    from utree_tpu.utils.trace import device_event_counts

    seqs = []
    for _, seq in _records(reads):
        seqs.append(seq.rstrip(b"\n"))
        if len(seqs) == batch:
            break
    np.asarray(pipe.dispatch(seqs))  # compiled outside the window
    with jax.profiler.trace(profile_dir):
        np.asarray(pipe.dispatch(seqs))
    nccl = device_event_counts(profile_dir, "nccl")
    for plane, names in sorted(nccl.items()):
        log(f"    {plane}: {sum(names.values())} nccl kernels "
            + ", ".join(f"{n[:60]} x{c}" for n, c in sorted(names.items())))
    return nccl


def phase_devices(wd: str, devices: int, num_kmers: int = 20_000_000,
                  num_labels: int = 4096, num_reads: int = 262_144,
                  num_long: int = 4, long_len: int = 200_000,
                  batch: int = 65536, profile_dir: str | None = None) -> dict:
    """Phase A's DB and reads on `devices` devices, replicated and routed,
    each == the one-device run byte for byte.  With `profile_dir`, one
    routed batch is traced and its collective kernels counted per device."""
    import jax

    ctr, genome, rng = make_search_db(wd, num_kmers, num_labels)
    reads = os.path.join(wd, "reads_a.fa")
    write_reads(reads, genome, rng, num_reads, num_long=num_long, long_len=long_len)
    one = os.path.join(wd, "out_1.txt")
    pipe, dt = _cli(["search", ctr, reads, one, "--rc", "--batch", str(batch)])
    _rate("1 device", num_reads + num_long, dt)
    del pipe
    result = {}
    for mode, extra in (("replicated", []), ("routed", ["--lookup-mode", "routed"])):
        out = os.path.join(wd, f"out_{devices}_{mode}.txt")
        pipe, dt = _cli(["search", ctr, reads, out, "--rc", "--batch", str(batch),
                         "--devices", str(devices), *extra])
        d = _engaged(pipe)
        check(d["devices"] == devices, d)
        if mode == "routed":
            check(d["table_kind"] == "routed-displaced", d)
        colls = _collectives(pipe)
        spread = {len(v.sharding.device_set) for v in pipe._table.values()}
        used = [(jax.devices()[i].memory_stats() or {}).get("bytes_in_use")
                for i in range(devices)]
        log(f"  {mode}: collectives in the compiled step {colls}; table arrays "
            f"span {spread} devices; bytes in use per device {used}")
        check(spread == {devices}, "a table array does not span every device")
        if mode == "routed":
            check("all-to-all" in colls, colls)
        _rate(f"{devices} devices {mode}", num_reads + num_long, dt)
        _same_bytes(one, out)
        log(f"  {devices} devices {mode} == 1 device, byte for byte")
        result[mode] = {"describe": d, "collectives": colls, "bytes_in_use": used}
        if profile_dir and mode == "routed":
            result[mode]["nccl"] = trace_one_batch(pipe, reads, batch, profile_dir)
        del pipe
    return result


# ---- entry ----------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1: run only the N-device replicated and routed "
                         "search against the one-device run")
    ap.add_argument("--profile-dir", default=None,
                    help="also run Phase A's search a second time, traced "
                         "with jax.profiler into this dir, and summarize it")
    a = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "utree_tpu")):
        raise SystemExit("chip_smoke.py runs from a utree_tpu checkout")
    sys.path.insert(0, HERE)
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs}")
    if len(devs) < a.devices:
        raise SystemExit(f"--devices {a.devices} but JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi)
    log(f"jax.devices(): {devs}")

    wd = tempfile.mkdtemp(prefix="utree_smoke_")
    t0 = time.perf_counter()
    try:
        if a.devices > 1:
            log(f"phase {a.devices} devices: replicated and routed vs 1 device")
            r = phase_devices(wd, a.devices, profile_dir=a.profile_dir)
            if a.profile_dir:
                nccl = r["routed"]["nccl"]
                check(len(nccl) == a.devices and all(nccl.values()),
                      "routed collectives did not run as NCCL kernels on "
                      "every device")
        else:
            log("phase A: utree search, 20M-entry canonical table")
            phase_a(wd, profile_dir=a.profile_dir)
            log("phase B: displaced table, 4M entries")
            phase_b(wd)
            log("phase C: xtree ALIGN --device")
            phase_c(wd)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": a.devices}}))


if __name__ == "__main__":
    main()
