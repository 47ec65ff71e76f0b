"""chip_smoke.py: refuses to run without a GPU, and its phases' device-vs-spec
comparisons pass at toy sizes on the CPU backend (the platform check lives
only in main())."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _env_without_platform():
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}


def test_fails_without_gpu(tmp_path):
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=tmp_path, env=_env_without_platform(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_fails_outside_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       env=_env_without_platform(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_phase_a_toy(tmp_path):
    r = chip_smoke.phase_a(str(tmp_path), num_kmers=200_000, num_labels=64,
                           num_reads=2048, num_long=2, long_len=40_000,
                           batch=512, profile_dir=str(tmp_path / "trace"))
    d = r["describe"]
    assert d["table_kind"] == "canonical" and d["device_vote"]
    assert r["memory"]["worst_case_bytes"] <= r["memory"]["device_bytes"]


def test_phase_b_toy(tmp_path):
    outs = chip_smoke.phase_b(str(tmp_path), num_kmers=100_000, num_labels=64,
                              num_reads=1024, batch=256)
    assert pathlib.Path(outs["displaced"]).read_bytes()


def test_phase_c_toy(tmp_path):
    chip_smoke.phase_c(str(tmp_path), num_refs=8, ref_len=3000, num_queries=400)


def test_phase_devices_toy(tmp_path):
    r = chip_smoke.phase_devices(str(tmp_path), 4, num_kmers=100_000,
                                 num_labels=64, num_reads=1024, num_long=1,
                                 long_len=30_000, batch=256,
                                 profile_dir=str(tmp_path / "trace"))
    assert "all-to-all" in r["routed"]["collectives"]
    assert r["routed"]["nccl"] == {}  # the CPU backend has no device planes
    assert r["replicated"]["describe"]["devices"] == 4


def test_spec_check_catches_a_changed_line(tmp_path):
    """check_against_spec fails when one sampled read's line differs."""
    ctr, genome, rng = chip_smoke.make_search_db(str(tmp_path), 50_000, 16)
    reads = tmp_path / "r.fa"
    chip_smoke.write_reads(str(reads), genome, rng, 256)
    out = tmp_path / "o.txt"
    chip_smoke._cli(["search", ctr, str(reads), str(out), "--rc", "--batch", "64"])
    chip_smoke.check_against_spec(ctr, str(reads), str(out), str(tmp_path))
    lines = out.read_bytes().splitlines(keepends=True)
    first = lines[0].split(b"\t")
    lines[0] = b"\t".join(first[:-1] + [b"tampered\n"])
    out.write_bytes(b"".join(lines))
    with pytest.raises(AssertionError, match="differ from the host spec"):
        chip_smoke.check_against_spec(ctr, str(reads), str(out), str(tmp_path),
                                      every=1)


def test_busy_and_gaps():
    from utree_tpu.utils.trace import busy_and_gaps

    ev = [("a", 0, 10), ("b", 5, 10), ("a", 30, 5), ("c", 100, 1)]
    r = busy_and_gaps(ev, top=2)
    assert r["busy_ns"] == 15 + 5 + 1
    assert r["window_ns"] == 101
    assert r["gaps"] == [(35, 65), (15, 15)]
    assert r["top_ops"] == [("a", 15, 2), ("b", 10, 1)]
