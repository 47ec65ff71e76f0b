"""Oracle harness: compile and run the reference C binaries for golden tests.

The reference compiles with `gcc -m64 -std=gnu11 -O3 -fopenmp -D <MODE>`
(makefile:5-15).  We build utree-buildGG / utree-compress / utree-searchGG
out-of-tree into .oracle/bin and invoke them on test fixtures; outputs are
the golden truth our implementation must match bit-for-bit (single-threaded,
since the reference's multithreaded output line order is nondeterministic,
itree.c:1009-1101).

The reference sources (itree.c, xtree.c) are looked up in
$UTREE_REFERENCE_DIR, else in the checkout's own `reference/` directory
(gitignored).
Golden tests skip when they are absent (`reference_available`).
"""

from __future__ import annotations

import os
import pathlib
import subprocess

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE_BIN = REPO / ".oracle" / "bin"
REF_DIR = pathlib.Path(os.environ.get("UTREE_REFERENCE_DIR", REPO / "reference"))
REF_SRC = REF_DIR / "itree.c"
XTREE_SRC = REF_DIR / "xtree.c"


def reference_available() -> bool:
    return REF_SRC.exists() and XTREE_SRC.exists()

_MODES = {
    "utree-build": "BUILD",
    "utree-buildGG": "BUILD_GG",
    "utree-compress": "COMPRESS",
    "utree-search": "SEARCH",
    "utree-searchGG": "SEARCH_GG",
}


def build_oracle(extra_defs: tuple[str, ...] = (), suffix: str = "") -> dict[str, pathlib.Path]:
    """Compile the five reference binaries; returns name -> path."""
    ORACLE_BIN.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, mode in _MODES.items():
        exe = ORACLE_BIN / (name + suffix)
        if not exe.exists():
            cmd = [
                # -fgnu89-inline: the reference uses bare `inline` functions
                # (e.g. addSampleU, itree.c:224) that need gnu89 semantics to
                # link under modern gcc.
                "gcc", "-m64", "-std=gnu11", "-O2", "-fopenmp", "-fgnu89-inline",
                "-D", mode, *[f"-D{d}" for d in extra_defs],
                str(REF_SRC), "-o", str(exe), "-lm",
            ]
            subprocess.run(cmd, check=True, capture_output=True)
        out[name] = exe
    return out


def build_xtree_oracle() -> pathlib.Path:
    """Compile the reference xtree.c (needs zlib)."""
    ORACLE_BIN.mkdir(parents=True, exist_ok=True)
    exe = ORACLE_BIN / "xtree"
    if not exe.exists():
        subprocess.run(
            ["gcc", "-m64", "-std=gnu11", "-O2", "-fopenmp", "-fgnu89-inline",
             str(XTREE_SRC), "-o", str(exe), "-lm", "-lz"],
            check=True, capture_output=True,
        )
    return exe


def run_xtree_oracle(args: list[str], threads: int = 1) -> None:
    exe = build_xtree_oracle()
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    subprocess.run([str(exe), *args, "--threads", str(threads)],
                   check=True, capture_output=True, env=env)


def run_oracle_pipeline(
    fasta: str, tax_map: str, reads: str, workdir: str, complevel: int = 1,
    do_rc: bool = False, gg: bool = True,
    extra_defs: tuple[str, ...] = (), suffix: str = "",
) -> dict[str, pathlib.Path]:
    """build -> compress -> search with the reference binaries (1 thread)."""
    bins = build_oracle(extra_defs=extra_defs, suffix=suffix)
    wd = pathlib.Path(workdir)
    wd.mkdir(parents=True, exist_ok=True)
    ubt = wd / "db.ubt"
    ctr = wd / "db.ctr"
    cls = wd / "classifications.txt"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    build_bin = bins["utree-buildGG" if gg else "utree-build"]
    search_bin = bins["utree-searchGG" if gg else "utree-search"]
    subprocess.run(
        [build_bin, fasta, tax_map, str(ubt), "1", str(complevel)],
        check=True, capture_output=True, env=env,
    )
    subprocess.run([bins["utree-compress"], str(ubt), str(ctr)], check=True, capture_output=True, env=env)
    cmd = [search_bin, str(ctr), reads, str(cls), "1"]
    if do_rc:
        cmd.append("RC")
    subprocess.run(cmd, check=True, capture_output=True, env=env)
    log = wd / ("db.ubt.gg.log" if gg else "db.ubt.log")
    return {"ubt": ubt, "ctr": ctr, "classifications": cls, "log": log}
