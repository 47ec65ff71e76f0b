"""CLI end-to-end: the `utree-tpu` subcommands must drive the same pipelines
the library tests cover, producing byte-identical artifacts vs the in-repo
host spec and, where their sources exist, the compiled reference binaries
(I19 / X7 parity)."""

import os

import pytest

from utree_tpu.cli import main as cli_main
from utree_tpu.oracle import run_oracle_pipeline, run_xtree_oracle
from utree_tpu.testdata import make_toy_db, make_toy_reads


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    wd = tmp_path_factory.mktemp("cli")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=77)
    make_toy_reads(str(wd / "reads.fa"), recs, seed=78)
    return wd, recs


def test_cli_build_compress_search_golden(reference_sources, data, tmp_path):
    wd, _ = data
    gold = run_oracle_pipeline(str(wd / "refs.fa"), str(wd / "tax.map"),
                               str(wd / "reads.fa"), str(tmp_path / "gold"),
                               complevel=2, do_rc=True)
    cli_main(["build", str(wd / "refs.fa"), str(wd / "tax.map"),
              str(tmp_path / "db.ubt"), "--complevel", "2"])
    cli_main(["compress", str(tmp_path / "db.ubt"), str(tmp_path / "db.ctr")])
    cli_main(["search", str(tmp_path / "db.ctr"), str(wd / "reads.fa"),
              str(tmp_path / "cls.txt"), "--rc"])
    assert (tmp_path / "db.ubt").read_bytes() == gold["ubt"].read_bytes()
    assert (tmp_path / "db.ctr").read_bytes() == gold["ctr"].read_bytes()
    assert (tmp_path / "cls.txt").read_bytes() == gold["classifications"].read_bytes()


def test_cli_search_host_and_shallow(reference_sources, data, tmp_path):
    """--rank-specific must match the non-GG reference binary (through the
    CLI surface)."""
    import subprocess

    from utree_tpu.oracle import build_oracle

    wd, _ = data
    cli_main(["build", str(wd / "refs.fa"), str(wd / "tax.map"),
              str(tmp_path / "n.ubt"), "--complevel", "2", "--rank-specific"])
    cli_main(["compress", str(tmp_path / "n.ubt"), str(tmp_path / "n.ctr")])
    cli_main(["search", str(tmp_path / "n.ctr"), str(wd / "reads.fa"),
              str(tmp_path / "sh.txt"), "--rank-specific"])
    exes = build_oracle()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    subprocess.run([str(exes["utree-search"]), str(tmp_path / "n.ctr"),
                    str(wd / "reads.fa"), str(tmp_path / "sh_ref.txt"), "1"],
                   check=True, capture_output=True, env=env)
    assert (tmp_path / "sh.txt").read_bytes() == (tmp_path / "sh_ref.txt").read_bytes()


def test_cli_xtree_build_align_golden(reference_sources, data, tmp_path):
    wd, _ = data
    run_xtree_oracle([
        "BUILD", "--seqs", str(wd / "refs.fa"), "--map", str(wd / "tax.map"),
        "--db-out", str(tmp_path / "g.xtr"), "--k", "29",
    ])
    run_xtree_oracle([
        "ALIGN", "--db", str(tmp_path / "g.xtr"), "--seqs", str(wd / "reads.fa"),
        "--perq-out", str(tmp_path / "g_perq.tsv"),
        "--ref-out", str(tmp_path / "g_ref.tsv"),
    ], threads=1)
    cli_main(["xtree-build", "--seqs", str(wd / "refs.fa"),
              "--map", str(wd / "tax.map"), "--db-out", str(tmp_path / "o.xtr"),
              "--k", "29"])
    cli_main(["xtree-align", "--db", str(tmp_path / "o.xtr"),
              "--seqs", str(wd / "reads.fa"),
              "--perq-out", str(tmp_path / "o_perq.tsv"),
              "--ref-out", str(tmp_path / "o_ref.tsv")])
    assert (tmp_path / "o.xtr").read_bytes() == (tmp_path / "g.xtr").read_bytes()
    assert (tmp_path / "o_perq.tsv").read_bytes() == (tmp_path / "g_perq.tsv").read_bytes()
    assert (tmp_path / "o_ref.tsv").read_bytes() == (tmp_path / "g_ref.tsv").read_bytes()


def test_cli_build_compress_search_spec(data, tmp_path):
    """build/compress match the library writers byte for byte; device and
    --host search match the host spec; --trace reports the resolved path."""
    from utree_tpu.config import UTreeConfig
    from utree_tpu.testdata import build_spec_db

    wd, _ = data
    spec_dir = tmp_path / "spec"
    spec_dir.mkdir()
    want = build_spec_db(wd / "refs.fa", wd / "tax.map", spec_dir,
                         UTreeConfig(complevel=2), reads=wd / "reads.fa",
                         rc_modes=(True,))
    cli_main(["build", str(wd / "refs.fa"), str(wd / "tax.map"),
              str(tmp_path / "db.ubt"), "--complevel", "2"])
    cli_main(["compress", str(tmp_path / "db.ubt"), str(tmp_path / "db.ctr")])
    assert (tmp_path / "db.ubt").read_bytes() == want["ubt"].read_bytes()
    assert (tmp_path / "db.ctr").read_bytes() == want["ctr"].read_bytes()
    pipe = cli_main(["search", str(tmp_path / "db.ctr"), str(wd / "reads.fa"),
                     str(tmp_path / "cls.txt"), "--rc", "--trace"])
    assert pipe.describe()["table_kind"] == "canonical"
    assert pipe.describe()["native_vote"] and pipe.describe()["native_scanner"]
    cli_main(["search", str(tmp_path / "db.ctr"), str(wd / "reads.fa"),
              str(tmp_path / "cls_host.txt"), "--rc", "--host"])
    assert (tmp_path / "cls.txt").read_bytes() == want["cls_rc"].read_bytes()
    assert (tmp_path / "cls_host.txt").read_bytes() == want["cls_rc"].read_bytes()


def test_cli_search_rank_specific_spec(data, tmp_path):
    """--rank-specific through the CLI == search_file_shallow on the same DB."""
    from utree_tpu.search_host import HostIndex, search_file_shallow

    wd, _ = data
    cli_main(["build", str(wd / "refs.fa"), str(wd / "tax.map"),
              str(tmp_path / "n.ubt"), "--complevel", "2", "--rank-specific"])
    cli_main(["compress", str(tmp_path / "n.ubt"), str(tmp_path / "n.ctr")])
    cli_main(["search", str(tmp_path / "n.ctr"), str(wd / "reads.fa"),
              str(tmp_path / "sh.txt"), "--rank-specific", "--rc"])
    search_file_shallow(HostIndex.from_ctr(str(tmp_path / "n.ctr")),
                        str(wd / "reads.fa"), str(tmp_path / "want.txt"), do_rc=True)
    assert (tmp_path / "sh.txt").read_bytes() == (tmp_path / "want.txt").read_bytes()
    assert (tmp_path / "sh.txt").read_bytes()


def test_cli_xtree_build_align_spec(data, tmp_path):
    """xtree-build == the library writer; xtree-align, with and without
    --device, == the host aligner."""
    from utree_tpu.xtree.align import AlignOptions, XtreeAligner
    from utree_tpu.xtree.build import build_xtree_db, read_xtr, write_xtr

    wd, _ = data
    write_xtr(build_xtree_db(str(wd / "refs.fa"), str(wd / "tax.map"), k=29),
              str(tmp_path / "want.xtr"))
    cli_main(["xtree-build", "--seqs", str(wd / "refs.fa"),
              "--map", str(wd / "tax.map"), "--db-out", str(tmp_path / "o.xtr"),
              "--k", "29"])
    assert (tmp_path / "o.xtr").read_bytes() == (tmp_path / "want.xtr").read_bytes()
    XtreeAligner(read_xtr(str(tmp_path / "want.xtr"))).align_file(
        str(wd / "reads.fa"), AlignOptions(
            perq_out=str(tmp_path / "w_perq.tsv"),
            tax_out=str(tmp_path / "w_tax.tsv")))
    for flag in ([], ["--device"]):
        tag = "d" if flag else "h"
        cli_main(["xtree-align", "--db", str(tmp_path / "o.xtr"),
                  "--seqs", str(wd / "reads.fa"),
                  "--perq-out", str(tmp_path / f"{tag}_perq.tsv"),
                  "--tax-out", str(tmp_path / f"{tag}_tax.tsv"), *flag])
        for name in ("perq", "tax"):
            got = (tmp_path / f"{tag}_{name}.tsv").read_bytes()
            assert got == (tmp_path / f"w_{name}.tsv").read_bytes(), (tag, name)
