"""Search checkpoint/resume: interrupted run + resume == uninterrupted run."""

import numpy as np

from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline


def test_resume_produces_identical_output(spec, tmp_path):
    idx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    pipe = SearchPipeline(idx, do_rc=False, batch_size=128)

    full = tmp_path / "full.txt"
    pipe.search_file(spec["reads"], str(full))
    assert not (tmp_path / "full.txt.ckpt").exists()

    # simulate an interruption: run a copy that stops after 3 batches
    part = tmp_path / "part.txt"

    class Stop(Exception):
        pass

    count = {"n": 0}
    orig_unpack = pipe._unpack
    orig_packed = pipe._vote_packed
    orig_dev = pipe._format_devvote

    def tick():
        if count["n"] >= 3:
            raise Stop()
        count["n"] += 1

    def bomb_unpack(handles):
        tick()
        return orig_unpack(handles)

    def bomb_packed(*a, **kw):
        tick()
        return orig_packed(*a, **kw)

    def bomb_dev(*a, **kw):
        tick()
        return orig_dev(*a, **kw)

    # the drain goes through _vote_packed (packed-output DBs) or _unpack
    # (everything else) — bomb both so either layout gets interrupted
    pipe._unpack = bomb_unpack
    pipe._vote_packed = bomb_packed
    pipe._format_devvote = bomb_dev
    try:
        pipe.search_file(spec["reads"], str(part))
        raise AssertionError("should have been interrupted")
    except Stop:
        pass
    pipe._unpack = orig_unpack
    pipe._vote_packed = orig_packed
    pipe._format_devvote = orig_dev
    assert (tmp_path / "part.txt.ckpt").exists()
    partial_size = part.stat().st_size
    assert 0 < partial_size < full.stat().st_size

    n = pipe.search_file(spec["reads"], str(part), resume=True)
    assert n == 1000
    assert part.read_bytes() == full.read_bytes()
    assert not (tmp_path / "part.txt.ckpt").exists()


def test_resume_with_record_range(spec, tmp_path):
    """Resume + record_range must not double-add the range start (regression:
    ckpt stored absolute `done` but resume added range_lo again, silently
    skipping records)."""
    idx = DeviceIndexArrays.from_ctr(str(spec["ctr"]))
    pipe = SearchPipeline(idx, do_rc=False, batch_size=128)

    lo, hi = 300, 800
    full = tmp_path / "range_full.txt"
    pipe.search_file(spec["reads"], str(full), record_range=(lo, hi))

    part = tmp_path / "range_part.txt"

    class Stop(Exception):
        pass

    count = {"n": 0}
    orig_unpack = pipe._unpack
    orig_packed = pipe._vote_packed
    orig_dev = pipe._format_devvote

    def tick():
        if count["n"] >= 1:
            raise Stop()
        count["n"] += 1

    def bomb_unpack(handles):
        tick()
        return orig_unpack(handles)

    def bomb_packed(*a, **kw):
        tick()
        return orig_packed(*a, **kw)

    def bomb_dev(*a, **kw):
        tick()
        return orig_dev(*a, **kw)

    pipe._unpack = bomb_unpack
    pipe._vote_packed = bomb_packed
    pipe._format_devvote = bomb_dev
    try:
        pipe.search_file(spec["reads"], str(part), record_range=(lo, hi))
        raise AssertionError("should have been interrupted")
    except Stop:
        pass
    pipe._unpack = orig_unpack
    pipe._vote_packed = orig_packed
    pipe._format_devvote = orig_dev
    assert (tmp_path / "range_part.txt.ckpt").exists()

    n = pipe.search_file(spec["reads"], str(part), resume=True,
                         record_range=(lo, hi))
    assert n == hi - lo
    assert part.read_bytes() == full.read_bytes()
