"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Multi-device sharding is validated on virtual CPU devices (jax.sharding over
--xla_force_host_platform_device_count); chip_smoke.py runs the same paths on
a GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from utree_tpu.testdata import build_spec_db, make_toy_db, make_toy_reads  # noqa: E402


def _toy_inputs(wd):
    records = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"))
    make_toy_reads(str(wd / "reads.fa"), records)
    return {
        "dir": wd,
        "refs": str(wd / "refs.fa"),
        "map": str(wd / "tax.map"),
        "reads": str(wd / "reads.fa"),
        "records": records,
    }


@pytest.fixture(scope="session")
def spec(tmp_path_factory):
    """Toy DB + reads (BASELINE.json config 1) with the host spec's outputs:
    the DB built by build_database + write_ubt + write_ctr_from_ubt, the
    reads classified by search_host.search_file without and with RC.  Needs
    no reference sources."""
    from utree_tpu.config import UTreeConfig

    wd = tmp_path_factory.mktemp("spec")
    toy = _toy_inputs(wd)
    toy.update(build_spec_db(toy["refs"], toy["map"], wd, UTreeConfig(complevel=1),
                             reads=toy["reads"]))
    return toy


@pytest.fixture(scope="session")
def reference_sources():
    """The reference C sources the golden tests compile; skips when absent."""
    from utree_tpu.oracle import REF_DIR, reference_available

    if not reference_available():
        pytest.skip(f"reference sources (itree.c, xtree.c) not found in {REF_DIR}")
    return REF_DIR


@pytest.fixture(scope="session")
def golden(reference_sources, tmp_path_factory):
    """The same toy inputs run through the compiled reference binaries."""
    from utree_tpu.oracle import run_oracle_pipeline

    wd = tmp_path_factory.mktemp("golden")
    toy = _toy_inputs(wd)
    toy["golden"] = run_oracle_pipeline(
        toy["refs"], toy["map"], toy["reads"], str(wd / "oracle"), complevel=1)
    toy["golden_rc"] = run_oracle_pipeline(
        toy["refs"], toy["map"], toy["reads"], str(wd / "oracle_rc"),
        complevel=1, do_rc=True)
    return toy
