"""Deterministic toy-data generation for tests and benchmarks.

Produces linearized reference FASTA + greengenes-style taxonomy maps + read
sets shaped like BASELINE.json config 1 (10 refs, 1K x 150bp reads).  All
generation is seeded NumPy so fixtures are reproducible without committing
binary blobs.
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_RANKS = b"kpcofgst"


def random_taxonomy(rng: np.random.Generator, depth: int = 8, shared: list[bytes] | None = None) -> bytes:
    """A k__..;t__.. style greengenes taxonomy with `depth` ranks."""
    parts = []
    for d in range(depth):
        tok = bytes(rng.integers(ord("a"), ord("z") + 1, size=4, dtype=np.uint8))
        parts.append(_RANKS[d : d + 1] + b"__" + tok)
    if shared is not None:
        # overwrite leading ranks with a shared lineage to force conflicts
        for d, s in enumerate(shared):
            parts[d] = s
    return b";".join(parts)


def shared_lineage(rng: np.random.Generator, depth: int) -> list[bytes]:
    return [
        _RANKS[d : d + 1] + b"__" + bytes(rng.integers(ord("a"), ord("z") + 1, size=4, dtype=np.uint8))
        for d in range(depth)
    ]


def random_seq(rng: np.random.Generator, length: int, n_prob: float = 0.0) -> bytes:
    seq = _BASES[rng.integers(0, 4, size=length)]
    if n_prob > 0:
        mask = rng.random(length) < n_prob
        seq = np.where(mask, np.uint8(ord("N")), seq)
    return seq.astype(np.uint8).tobytes()


def make_toy_db(
    path_fa: str,
    path_map: str,
    num_refs: int = 10,
    ref_len: int = 5000,
    seed: int = 7,
    num_lineages: int = 3,
    n_prob: float = 0.002,
) -> list[tuple[bytes, bytes, bytes]]:
    """Write a toy reference FASTA + map.  Some refs share genus-level lineages
    and overlapping sequence so the build exercises the conflict fold."""
    rng = np.random.default_rng(seed)
    lineages = [shared_lineage(rng, depth=6) for _ in range(num_lineages)]
    records = []
    prev_seq = None
    for i in range(num_refs):
        name = f"ref{i:04d}".encode()
        lineage = lineages[i % num_lineages]
        tax = random_taxonomy(rng, shared=lineage)
        seq = random_seq(rng, ref_len, n_prob)
        if prev_seq is not None and i % 2 == 1:
            # splice in a chunk of the previous ref -> shared k-mers -> folds
            cut = ref_len // 3
            seq = prev_seq[:cut] + seq[cut:]
        prev_seq = seq
        records.append((name, tax, seq))
    with open(path_fa, "wb") as fa, open(path_map, "wb") as mp:
        for name, tax, seq in records:
            fa.write(b">" + name + b"\n" + seq + b"\n")
            mp.write(name + b"\t" + tax + b"\n")
    return records


def make_toy_reads(
    path_fa: str,
    records: list[tuple[bytes, bytes, bytes]],
    num_reads: int = 1000,
    read_len: int = 150,
    seed: int = 11,
    mutate_prob: float = 0.01,
    random_frac: float = 0.1,
) -> None:
    """Reads sampled from the toy refs plus some fully random ones."""
    rng = np.random.default_rng(seed)
    with open(path_fa, "wb") as fa:
        for i in range(num_reads):
            if rng.random() < random_frac:
                seq = random_seq(rng, read_len)
            else:
                _, _, ref = records[rng.integers(0, len(records))]
                start = int(rng.integers(0, max(1, len(ref) - read_len)))
                arr = np.frombuffer(ref[start : start + read_len], dtype=np.uint8).copy()
                mut = rng.random(len(arr)) < mutate_prob
                arr[mut] = _BASES[rng.integers(0, 4, size=int(mut.sum()))]
                seq = arr.tobytes()
            fa.write(b">read%d some description\n" % i + seq + b"\n")


def build_spec_db(refs, tax_map, wd, cfg, reads=None, rc_modes=(False, True)) -> dict:
    """Toy DB through the in-repo build -> .ubt -> .ctr path, plus the host
    spec's classifications (search_host.search_file) of `reads`, keyed
    "cls" (forward) and "cls_rc" (with reverse complement)."""
    import pathlib

    from utree_tpu.build import build_database
    from utree_tpu.formats import write_ctr_from_ubt, write_ubt
    from utree_tpu.search_host import HostIndex, search_file

    wd = pathlib.Path(wd)
    res = build_database(str(refs), str(tax_map), cfg)
    out = {"ubt": wd / "db.ubt", "ctr": wd / "db.ctr"}
    write_ubt(str(out["ubt"]), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(out["ubt"]), str(out["ctr"]), cfg)
    if reads is not None:
        idx = HostIndex.from_ctr(str(out["ctr"]), cfg)
        for rc in rc_modes:
            key = "cls_rc" if rc else "cls"
            out[key] = wd / f"{key}.txt"
            search_file(idx, str(reads), str(out[key]), do_rc=rc)
    return out
