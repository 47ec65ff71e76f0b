"""Multi-host end-to-end: 2 processes (jax.distributed over localhost CPU)
must produce output bytes identical to a 1-host run.

This is the N>=2-hosts leg of BASELINE's reporting matrix (SURVEY.md §5.8):
each process searches its contiguous record range through its own pipeline
into a part file; process 0 concatenates after the psum barrier.
"""

import os
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
# 2 local devices per process: catches per-host tallies overcounted by the
# local device count (merge_sample_tallies regression)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, sys.argv[6])
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
db, reads, out = sys.argv[4], sys.argv[5], sys.argv[7]
from utree_tpu.parallel.distributed import init_distributed, search_file_multihost
init_distributed(f"127.0.0.1:{port}", nproc, pid)
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline
idx = DeviceIndexArrays.from_ctr(db)
pipe = SearchPipeline(idx, do_rc=True, batch_size=128)
n = search_file_multihost(pipe, reads, out)
print(f"host {pid} searched {n}")
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_hosts_identical_to_one(spec, tmp_path):
    # single-host (in-process) reference
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.pipeline import SearchPipeline

    idx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    single = tmp_path / "single.txt"
    SearchPipeline(idx, do_rc=True, batch_size=128).search_file(
        spec["reads"], str(single))

    port = _free_port()
    out = tmp_path / "merged.txt"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port),
             str(spec["ctr"]), str(spec["reads"]), str(REPO), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    for p in procs:
        o, e = p.communicate(timeout=600)
        assert p.returncode == 0, (o.decode(), e.decode())
    assert out.read_bytes() == single.read_bytes()
    assert out.read_bytes() == spec["cls_rc"].read_bytes()
