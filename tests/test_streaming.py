"""Streamed (chunked) ingestion: O(chunk) memory, identical output.

The native driver reads the file in pieces and a producer thread packs while
the main thread dispatches (itree.c:867-875's streaming reader, rebuilt).
Forcing tiny chunks exercises piece boundaries, partial batches, tail-grow
(record bigger than the chunk), and resume across pieces.
"""

import numpy as np

from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline


def _pipe(spec, **kw):
    idx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    return SearchPipeline(idx, do_rc=True, **kw)


def test_tiny_chunks_identical(spec, tmp_path):
    ref = _pipe(spec, batch_size=128)
    a = tmp_path / "whole.txt"
    n1 = ref.search_file(spec["reads"], str(a))

    pipe = _pipe(spec, batch_size=128)
    pipe.stream_chunk_bytes = 1  # floor is 64KiB; still forces many pieces
    b = tmp_path / "chunked.txt"
    n2 = pipe.search_file(spec["reads"], str(b))
    assert n1 == n2 == 1000
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes() == spec["cls_rc"].read_bytes()


def test_record_larger_than_chunk(spec, tmp_path):
    """A single record bigger than the chunk grows the tail until complete."""
    rng = np.random.default_rng(4)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=300_000).tobytes()
    reads = tmp_path / "mix.fa"
    with open(reads, "wb") as f:
        f.write(b">big first\n" + seq + b"\n")
        for i in range(10):
            s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=120).tobytes()
            f.write(b">r%d\n" % i + s + b"\n")

    ref = _pipe(spec, batch_size=16)
    a = tmp_path / "whole.txt"
    ref.search_file(str(reads), str(a))

    pipe = _pipe(spec, batch_size=16)
    pipe.stream_chunk_bytes = 1  # 64KiB floor < 300KB record
    b = tmp_path / "chunked.txt"
    n = pipe.search_file(str(reads), str(b))
    assert n == 11
    assert a.read_bytes() == b.read_bytes()


def test_resume_across_pieces(spec, tmp_path):
    """Interrupt mid-file, resume with chunked ingestion: bytes identical."""
    from utree_tpu.utils.checkpoint import SearchCheckpoint

    full = _pipe(spec, batch_size=64)
    a = tmp_path / "full.txt"
    full.search_file(spec["reads"], str(a))

    out = tmp_path / "resumed.txt"
    # simulate an interrupted run: process ~1/3, keep the sidecar
    pipe = _pipe(spec, batch_size=64)
    pipe.stream_chunk_bytes = 1

    class Boom(RuntimeError):
        pass

    count = 0
    orig = SearchCheckpoint.commit

    def bomb(self, done, tell):
        nonlocal count
        orig(self, done, tell)
        count += 1
        if count == 5:
            raise Boom()

    SearchCheckpoint.commit = bomb
    try:
        try:
            pipe.search_file(spec["reads"], str(out))
            raise AssertionError("expected interruption")
        except Boom:
            pass
    finally:
        SearchCheckpoint.commit = orig

    pipe2 = _pipe(spec, batch_size=64)
    pipe2.stream_chunk_bytes = 1
    n = pipe2.search_file(spec["reads"], str(out), resume=True)
    assert n == 1000
    assert out.read_bytes() == a.read_bytes()


def test_gz_input_native_driver_identical(spec, tmp_path):
    """.gz reads stream through the native driver and produce the same
    bytes as the plain file (the reference utree reads plain FASTA only;
    gz is an ingestion extension matching xtree's gzread chunking)."""
    import gzip

    from utree_tpu.config import UTreeConfig
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.pipeline import SearchPipeline

    cfg = UTreeConfig(complevel=1)
    idx = DeviceIndexArrays.from_ctr(str(spec["ctr"]), cfg)
    gz = tmp_path / "reads.fa.gz"
    with gzip.open(gz, "wb") as f:
        f.write(open(spec["reads"], "rb").read())
    pipe = SearchPipeline(idx, do_rc=True, batch_size=128)
    pipe.stream_chunk_bytes = 1 << 16
    pipe.search_file(spec["reads"], str(tmp_path / "plain.txt"))
    pipe.search_file(str(gz), str(tmp_path / "gz.txt"))
    plain = (tmp_path / "plain.txt").read_bytes()
    assert plain == (tmp_path / "gz.txt").read_bytes()
    assert plain  # non-empty
