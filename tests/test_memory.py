"""Device memory budget and compile-cache location."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.memory import TABLE_SHARE, device_memory_bytes, table_budget

REPO = pathlib.Path(__file__).resolve().parent.parent


def _cache_dir(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "UTREE_TPU_NO_JIT_CACHE")}
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, "-c",
         "import utree_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120, check=True)
    return r.stdout.strip()


def test_cache_dir_defaults_to_checkout():
    assert _cache_dir({}) == str(REPO / ".jax_cache")


def test_cache_dir_env_is_used(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


def test_cache_dir_opt_out():
    assert _cache_dir({"UTREE_TPU_NO_JIT_CACHE": "1"}) in ("", "None")


def test_cpu_budget_is_host_memory():
    """The CPU backend's virtual devices split the host's memory."""
    dev = jax.devices()[0]
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert len(jax.devices("cpu")) == 8
    assert device_memory_bytes(dev) == host // 8
    assert table_budget(dev) == host // 8 // TABLE_SHARE


class _FakeDevice:
    platform = "gpu"
    device_kind = "unknown accelerator"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_accelerator_budget_from_bytes_limit():
    assert table_budget(_FakeDevice({"bytes_limit": 60 << 30})) == (60 << 30) // TABLE_SHARE


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_device_without_memory_size_is_an_error(stats):
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        table_budget(_FakeDevice(stats))


def _index(n=200_000, seed=3):
    rng = np.random.default_rng(seed)
    words = np.unique(rng.integers(0, 1 << 64, size=n, dtype=np.uint64))
    ixs = rng.integers(0, 50, size=len(words)).astype(np.int64)
    return DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(50)],
                                        UTreeConfig())


@pytest.mark.parametrize("builder", ["canonical", "displaced", "routed"])
def test_small_cap_exceeds_budget(builder):
    from utree_tpu.hash_index import build_canonical_hash_index, build_displaced_index
    from utree_tpu.parallel.routed import ShardedDisplacedIndex

    idx = _index()
    build = {
        "canonical": lambda cap: build_canonical_hash_index(idx, t1_cap=cap),
        "displaced": lambda cap: build_displaced_index(idx, t1_cap=cap),
        "routed": lambda cap: ShardedDisplacedIndex.build(idx, 4, t1_cap=cap),
    }[builder]
    with pytest.raises(ValueError, match="exceed .*device memory budget"):
        build(4096)
    build(1 << 30)  # a cap the table fits in builds


def test_small_cap_exceeds_budget_64mer():
    from utree_tpu.hash_index64 import build_displaced_index64

    rng = np.random.default_rng(4)
    from utree_tpu.encode import W128

    words = np.zeros(20_000, dtype=W128)
    words["hi"] = np.sort(rng.integers(0, 1 << 63, size=20_000, dtype=np.uint64))
    words["lo"] = rng.integers(0, 1 << 63, size=20_000, dtype=np.uint64)
    cfg = UTreeConfig(packsize=64, ixtype_bytes=4)
    idx = DeviceIndexArrays.from_build(words, np.arange(20_000) % 7,
                                       [b"l%d" % i for i in range(7)], cfg)
    with pytest.raises(ValueError, match="exceed .*device memory budget"):
        build_displaced_index64(idx, t1_cap=4096)


def test_pipeline_passes_its_device_budget(monkeypatch):
    import utree_tpu.hash_index as hi
    from utree_tpu.pipeline import SearchPipeline

    seen = {}
    real = hi.build_canonical_hash_index

    def spy(index, **kw):
        seen.update(kw)
        return real(index, **kw)

    monkeypatch.setattr(hi, "build_canonical_hash_index", spy)
    pipe = SearchPipeline(_index(), lookup_mode="canonical", batch_size=8)
    assert seen["t1_cap"] == table_budget(jax.devices()[0])
    assert pipe.describe()["t1_cap"] == seen["t1_cap"]


def test_pipeline_small_device_budget(monkeypatch):
    """A device whose budget the table cannot fit: an explicit layout
    request fails instead of placing an oversized table."""
    import utree_tpu.memory
    from utree_tpu.pipeline import SearchPipeline

    monkeypatch.setattr(utree_tpu.memory, "table_budget", lambda device: 4096)
    with pytest.raises(RuntimeError, match="cannot be honored"):
        SearchPipeline(_index(), lookup_mode="displaced", batch_size=8)


def test_cached_bench_table_checked_against_budget(tmp_path):
    """bench.py's cached displaced table obeys the budget of the device it
    goes to, whether placed fresh or loaded from the cache."""
    sys.path.insert(0, str(REPO))
    import bench

    idx, *_ = bench.make_tier_index(100_000, 16)
    cap = table_budget(jax.devices()[0])
    bench.load_or_build_displaced(idx, 100_000, 16, str(tmp_path), cap)
    assert list(tmp_path.glob("disp_100000_16.npz"))
    with pytest.raises(ValueError, match="exceed the device memory budget"):
        bench.load_or_build_displaced(idx, 100_000, 16, str(tmp_path), 4096)


def test_reference_dir_defaults_inside_checkout(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "UTREE_REFERENCE_DIR"}

    def run(e):
        return subprocess.run(
            [sys.executable, "-c", "from utree_tpu.oracle import REF_DIR; print(REF_DIR)"],
            cwd=REPO, env=e, capture_output=True, text=True, timeout=120,
            check=True).stdout.strip()

    assert run(env) == str(REPO / "reference")
    assert run(dict(env, UTREE_REFERENCE_DIR=str(tmp_path))) == str(tmp_path)
