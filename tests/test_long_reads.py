"""Long-read (position-sharded) classification vs the host spec."""

import numpy as np

from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline
from utree_tpu.search_host import HostIndex, search_file


def test_long_reads_identical_to_oracle(spec, tmp_path):
    """Queries up to ~200Kb (reference supports 16Mb lines, itree.c:836):
    chunked long-read path must equal the host spec byte-for-byte."""
    rng = np.random.default_rng(99)
    refs = spec["records"]
    reads_path = tmp_path / "long_reads.fa"
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(reads_path, "wb") as f:
        for i in range(6):
            # stitch several reference spans + random spacers, some Ns
            parts = []
            for _ in range(4):
                _, _, ref = refs[int(rng.integers(0, len(refs)))]
                a = int(rng.integers(0, max(1, len(ref) - 2000)))
                parts.append(ref[a : a + 2000])
                parts.append(rng.choice(bases, size=int(rng.integers(100, 50_000))).tobytes())
                if rng.random() < 0.5:
                    parts.append(b"N" * int(rng.integers(1, 5)))
            seq = b"".join(parts)
            f.write(b">long%d descr\n" % i + seq + b"\n")

    want = tmp_path / "spec.txt"
    search_file(HostIndex.from_ctr(str(spec["ctr"])), str(reads_path), str(want),
                do_rc=True)
    idx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    pipe = SearchPipeline(idx, do_rc=True, batch_size=64)
    pipe.long_read_threshold = 10_000  # force the chunked path
    pipe.long_chunk = 8192
    out = tmp_path / "ours.txt"
    n = pipe.search_file(str(reads_path), str(out))
    assert n == 6
    assert out.read_bytes() == want.read_bytes()
    assert want.read_bytes().count(b"\n") == 6  # every long read classified
