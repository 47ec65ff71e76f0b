"""Multi-device sharding tests on the virtual 8-CPU mesh.

Every mode must produce results identical to the single-device path — the
distributed design's exactness contract (SURVEY.md §5.8: deterministic
reduction, bit-identical outputs at any device count).
"""

import jax
import numpy as np

from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.lookup import search_step
from utree_tpu.memory import table_budget
from utree_tpu.parallel import (
    ShardedIndex,
    long_read_histogram,
    make_mesh,
    replicated_search_step,
    sharded_search_step,
    split_long_read,
)

# byte cap for the tables, from the device they are placed onto
CAP = table_budget(jax.devices()[0])


def _toy_index(spec):
    return DeviceIndexArrays.from_ctr(str(spec["ctr"]), UTreeConfig())


def _reads(batch, length, seed=42):
    rng = np.random.default_rng(seed)
    r = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(batch, length),
                   p=[0.24, 0.24, 0.24, 0.24, 0.04])
    lens = rng.integers(length // 2, length + 1, size=batch).astype(np.int32)
    return r.astype(np.uint8), lens


def _single_device_ref(index, reads, lens, do_rc):
    cfg = index.config
    table = {"bin_ix": index.bin_ix, "suf_hi": index.suf_hi,
             "suf_lo": index.suf_lo, "ix": index.ix}
    out = search_step(table, reads, lens, k=cfg.packsize, do_rc=do_rc,
                      probe_iters=index.probe_iters, bad_ix=cfg.bad_ix)
    return np.asarray(out)


def test_replicated_dp_identical(spec):
    index = _toy_index(spec)
    mesh = make_mesh(data=8, table=1)
    reads, lens = _reads(32, 150)
    step = replicated_search_step(mesh, index, do_rc=True)
    out = np.asarray(step(index.device_put(), reads, lens))
    ref = _single_device_ref(index, reads, lens, do_rc=True)
    assert np.array_equal(out, ref)


def test_prefix_sharded_identical(spec):
    index = _toy_index(spec)
    mesh = make_mesh(data=2, table=4)
    sharded = ShardedIndex.from_index(index, num_shards=4)
    step = sharded_search_step(mesh, sharded, do_rc=False)
    reads, lens = _reads(16, 200, seed=9)
    out = np.asarray(step(sharded.device_put(mesh), reads, lens))
    ref = _single_device_ref(index, reads, lens, do_rc=False)
    assert np.array_equal(out, ref)


def test_prefix_sharded_rc_8way(spec):
    index = _toy_index(spec)
    mesh = make_mesh(data=1, table=8)
    sharded = ShardedIndex.from_index(index, num_shards=8)
    step = sharded_search_step(mesh, sharded, do_rc=True)
    reads, lens = _reads(8, 120, seed=3)
    out = np.asarray(step(sharded.device_put(mesh), reads, lens))
    ref = _single_device_ref(index, reads, lens, do_rc=True)
    assert np.array_equal(out, ref)


def test_long_read_sequence_parallel_identical(spec):
    """Position-sharded long read: psum'd histogram == single-device histogram."""
    index = _toy_index(spec)
    cfg = index.config
    mesh = make_mesh(data=4, table=2)
    rng = np.random.default_rng(17)
    # build a long read stitched from reference material so it actually hits
    ref_seq = spec["records"][0][2]
    long_read = ref_seq[:3000] + rng.choice(np.frombuffer(b"ACGT", np.uint8), 1000).tobytes()

    chunks, clens = split_long_read(long_read, 8, cfg.packsize)
    hist_fn = long_read_histogram(mesh, index, num_labels=index.num_labels, do_rc=True)
    table = index.device_put()
    hist = np.asarray(hist_fn(table, chunks, clens))

    # single-device reference histogram
    reads = np.zeros((1, len(long_read)), np.uint8)
    reads[0] = np.frombuffer(long_read, np.uint8)
    ix = _single_device_ref(index, reads, np.array([len(long_read)], np.int32), do_rc=True)
    hits = ix[ix < index.num_labels]
    ref_hist = np.bincount(hits, minlength=index.num_labels)
    assert np.array_equal(hist, ref_hist)
    assert hist.sum() > 0  # the read actually matched


def test_split_long_read_covers_all_windows():
    seq = b"ACGT" * 300  # 1200 bases
    chunks, lens = split_long_read(seq, 8, 32)
    # windows per chunk = lens - 31 where positive; total must be n - k + 1
    total = sum(max(0, int(l) - 31) for l in lens)
    assert total == len(seq) - 31


def test_replicated_dp_canonical_table(spec):
    """DP mode must carry the canonical fast-path table (regression:
    search_step NameError'd on canonical tables; replicated in_shardings
    hardwired the bsearch dict)."""
    from utree_tpu.hash_index import build_canonical_hash_index

    index = _toy_index(spec)
    mesh = make_mesh(data=8, table=1)
    reads, lens = _reads(32, 150, seed=5)
    canon = build_canonical_hash_index(index, t1_cap=CAP)
    table = {"c1": canon.t1, "c2": canon.t2, "c3": canon.t3}
    step = replicated_search_step(mesh, index, do_rc=True)
    out = np.asarray(step(table, reads, lens))
    cfg = index.config
    ref = np.asarray(search_step(
        table, reads, lens, k=cfg.packsize, do_rc=True,
        probe_iters=index.probe_iters, bad_ix=cfg.bad_ix,
        num_labels=index.num_labels))
    assert np.array_equal(out, ref)
    # and the canonical path agrees with the bsearch path
    ref_bs = _single_device_ref(index, reads, lens, do_rc=True)
    assert np.array_equal(out, ref_bs)


def test_pipeline_mesh_mode_byte_identical(spec, tmp_path):
    """The PRODUCT driver on an 8-device mesh: SearchPipeline(devices=8)
    .search_file must produce byte-identical output to the single-device
    pipeline and the host spec."""
    from utree_tpu.pipeline import SearchPipeline

    index = _toy_index(spec)
    single = tmp_path / "single.txt"
    SearchPipeline(index, do_rc=True, batch_size=128).search_file(
        spec["reads"], str(single))

    index2 = _toy_index(spec)
    mesh_out = tmp_path / "mesh.txt"
    pipe = SearchPipeline(index2, do_rc=True, batch_size=128, devices=8)
    assert pipe._mesh is not None
    pipe.search_file(spec["reads"], str(mesh_out))
    assert mesh_out.read_bytes() == single.read_bytes()
    assert mesh_out.read_bytes() == spec["cls_rc"].read_bytes()


def test_pipeline_mesh_mode_bsearch_table(spec, tmp_path):
    from utree_tpu.pipeline import SearchPipeline

    index = _toy_index(spec)
    single = tmp_path / "s.txt"
    SearchPipeline(index, do_rc=False, batch_size=64,
                   lookup_mode="bsearch").search_file(spec["reads"], str(single))
    index2 = _toy_index(spec)
    out = tmp_path / "m.txt"
    SearchPipeline(index2, do_rc=False, batch_size=64, lookup_mode="bsearch",
                   devices=4).search_file(spec["reads"], str(out))
    assert out.read_bytes() == single.read_bytes()


def test_pipeline_routed_mode_byte_identical(spec, tmp_path):
    """The bigger-than-one-device product driver: SearchPipeline(devices=8,
    lookup_mode='routed') shards the displaced table across the mesh and its
    search_file output must equal the single-device pipeline and the host
    spec, long reads and cap overflows included."""
    from utree_tpu.pipeline import SearchPipeline

    index = _toy_index(spec)
    single = tmp_path / "r_single.txt"
    SearchPipeline(index, do_rc=True, batch_size=128).search_file(
        spec["reads"], str(single))

    index2 = _toy_index(spec)
    out = tmp_path / "r_routed.txt"
    pipe = SearchPipeline(index2, do_rc=True, batch_size=128, devices=8,
                          lookup_mode="routed")
    assert pipe.table_kind == "routed-displaced"
    pipe.search_file(spec["reads"], str(out))
    assert out.read_bytes() == single.read_bytes()
    assert out.read_bytes() == spec["cls_rc"].read_bytes()


def test_pipeline_routed_overflow_fallback(spec, tmp_path):
    """A routed pipeline whose step capacity is forced tiny must flag every
    batch and redispatch through the exact fallback — output unchanged."""
    from utree_tpu.parallel.routed import routed_displaced_search_step
    from utree_tpu.pipeline import SearchPipeline

    index = _toy_index(spec)
    single = tmp_path / "o_single.txt"
    SearchPipeline(index, do_rc=True, batch_size=128).search_file(
        spec["reads"], str(single))

    index2 = _toy_index(spec)
    pipe = SearchPipeline(index2, do_rc=True, batch_size=128, devices=8,
                          lookup_mode="routed")
    # rebuild the routed step with a capacity that must overflow
    from utree_tpu.parallel.routed import ShardedDisplacedIndex

    sharded = ShardedDisplacedIndex.build(index2, 8, t1_cap=CAP)
    pipe._step_routed = routed_displaced_search_step(
        pipe._mesh, sharded, do_rc=True, num_labels=index2.num_labels,
        cap=pipe.hist_cap, bad_ix=index2.config.bad_ix, capacity=8)
    out = tmp_path / "o_routed.txt"
    pipe.search_file(spec["reads"], str(out))
    assert out.read_bytes() == single.read_bytes()
