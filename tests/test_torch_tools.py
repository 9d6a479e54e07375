"""The port's host tools against the JAX package's, on the CPU: each CLI
of both packages runs on one ``build_catalog_fixture`` catalog (paired
reads for ``pe_utils``) and must write the same bytes.  ``run_miso.py``
runs the sampler: its ``--device cpu`` output is held to
``miso_torch --run --device cpu`` on the same genes and seed, and its
summarize / compare pass-throughs to the JAX package's bytes.
"""
import importlib
import os
import shutil
import zipfile

import numpy as np
import pytest
import torch
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()

PACKAGES = ["miso_tpu", "miso_tpu_torch"]
N = 8
READ_LEN = 36
FAST_SETTINGS = ("[sampler]\nburn_in = 100\nlag = 5\nnum_iters = 600\n"
                 "num_chains = 2\n")


def _cli(pkg, name):
    return importlib.import_module("%s.cli.%s" % (pkg, name)).main


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(d, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _same_trees(root):
    """The two packages' output directories under root hold the same
    files with the same bytes; returns the port's."""
    want, got = (_tree(os.path.join(root, pkg)) for pkg in PACKAGES)
    assert got and sorted(got) == sorted(want)
    for rel in got:
        assert got[rel] == want[rel], rel
    return got


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    from miso_tpu_torch.cli.index_gff import main as index_main
    from miso_tpu_torch.cli.main import main as torch_main
    from miso_tpu_torch.testing import build_catalog_fixture

    root = tmp_path_factory.mktemp("torch_tools")
    fix = build_catalog_fixture(str(root / "fix"), num_events=N,
                                reads_per_event=200, read_len=READ_LEN,
                                seed=5)
    idx = str(root / "index")
    assert index_main(["--index", fix["gff"], idx]) == 0
    settings = root / "fast.txt"
    settings.write_text(FAST_SETTINGS)
    out = str(root / "run_out")
    assert torch_main(["--run", idx, fix["bam"], "--output-dir", out,
                       "--read-len", str(READ_LEN), "--settings-filename",
                       str(settings), "--seed", "3", "--device", "cpu"]) == 0
    return {"root": root, "fix": fix, "idx": idx, "out": out,
            "settings": str(settings)}


def _copy_of_run(catalog, name):
    dest = str(catalog["root"] / name)
    shutil.copytree(catalog["out"], dest)
    shutil.rmtree(os.path.join(dest, "logs"), ignore_errors=True)
    return dest


def _db_rows(path):
    import sqlite3
    con = sqlite3.connect(path)
    try:
        tables = [r[0] for r in con.execute(
            "select name from sqlite_master where type='table' "
            "order by name")]
        return {t: con.execute("select * from %s order by 1" % t).fetchall()
                for t in tables}
    finally:
        con.close()


def test_pack_and_view(catalog, capsys):
    """miso_pack --pack then --view: the same .miso_db rows and the same
    listing from both packages, and the port's database reads back
    through its own MISOSamples."""
    listing = {}
    for pkg in PACKAGES:
        tree = _copy_of_run(catalog, "pack_" + pkg)
        assert _cli(pkg, "pack")(["--pack", tree]) == 0
        capsys.readouterr()
        dbs = sorted(f for f in os.listdir(tree) if f.endswith(".miso_db"))
        assert dbs == ["chr%d.miso_db" % c for c in (1, 2, 3, 4)]
        assert not any(os.path.isdir(os.path.join(tree, "chr%d" % c))
                       for c in (1, 2, 3, 4))
        assert _cli(pkg, "pack")(
            ["--view", os.path.join(tree, "chr1.miso_db")]) == 0
        listing[pkg] = capsys.readouterr().out
    assert listing["miso_tpu_torch"] == listing["miso_tpu"]
    assert "Database contains 2 events" in listing["miso_tpu_torch"]
    for c in (1, 2, 3, 4):
        rows = [_db_rows(str(catalog["root"] / ("pack_" + pkg) /
                             ("chr%d.miso_db" % c))) for pkg in PACKAGES]
        assert rows[0] == rows[1] and any(rows[1].values())
    from miso_tpu_torch.io.miso_file import MISOSamples
    obj = MISOSamples(str(catalog["root"] / "pack_miso_tpu_torch"))
    assert sorted(obj.all_event_names) == sorted(
        "ev%d" % e for e in range(N))
    assert obj.get_event_samples("ev3").samples.shape == (200, 2)


def test_zip_roundtrip(catalog):
    """miso_zip --compress / --uncompress: archives of both packages
    hold the same members with the same bytes (a zip records each
    member's time, so the archives themselves are compared by content),
    and they unpack to equal trees."""
    members = {}
    for pkg in PACKAGES:
        tree = _copy_of_run(catalog, "zip_" + pkg)
        archive = str(catalog["root"] / ("%s.misozip" % pkg))
        assert _cli(pkg, "zip")(["--compress", archive, tree]) == 0
        with zipfile.ZipFile(archive) as zf:
            members[pkg] = {
                n.replace("zip_" + pkg, "tree"): zf.read(n)
                for n in zf.namelist()}
        assert _cli(pkg, "zip")(
            ["--uncompress", archive,
             str(catalog["root"] / "unzipped" / pkg)]) == 0
    got, want = members["miso_tpu_torch"], members["miso_tpu"]
    assert sorted(got) == sorted(want) and len(got) >= 5
    for name in got:
        if name.endswith(".miso_db"):
            continue        # sqlite files: compared by rows above
        assert got[name] == want[name], name
    for pkg in PACKAGES:
        unpacked = str(catalog["root"] / "unzipped" / pkg / ("zip_" + pkg))
        assert sorted(f for f in os.listdir(unpacked)
                      if f.endswith(".miso_db")) == [
            "chr%d.miso_db" % c for c in (1, 2, 3, 4)]


@pytest.mark.parametrize("flags", [[], ["--min-exon-size", "60"],
                                   ["--all-constitutive"]])
def test_exon_utils_bytes_are_equal(catalog, flags):
    root = str(catalog["root"] / ("exons" + "_".join(flags).replace("-", "")))
    for pkg in PACKAGES:
        assert _cli(pkg, "exon_utils")(
            ["--get-const-exons", catalog["fix"]["gff"], "--output-dir",
             os.path.join(root, pkg)] + flags) == 0
    files = _same_trees(root)
    assert len(files) == 1 and all(b.count(b"\texon\t") >= N
                                   for b in files.values())


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    from miso_tpu_torch.testing import build_paired_catalog_fixture

    root = tmp_path_factory.mktemp("torch_tools_paired")
    fix = build_paired_catalog_fixture(str(root / "fix"), num_events=6,
                                       pairs_per_event=60, seed=4)
    return root, fix


def test_pe_utils_bytes_are_equal(paired):
    root, fix = paired
    exons = {}
    for pkg in PACKAGES:
        assert _cli(pkg, "exon_utils")(
            ["--get-const-exons", fix["gff"], "--min-exon-size", "250",
             "--output-dir", str(root / "exons" / pkg)]) == 0
        (exons[pkg],) = [str(root / "exons" / pkg / f)
                         for f in os.listdir(str(root / "exons" / pkg))]
        assert _cli(pkg, "pe_utils")(
            ["--compute-insert-len", fix["bam"], exons[pkg],
             "--min-exon-size", "250",
             "--output-dir", str(root / "insert" / pkg)]) == 0
    files = _same_trees(str(root / "insert"))
    (text,) = [b.decode() for b in files.values()]
    header = text.splitlines()[0]
    assert header.startswith("#mean=") and "num_pairs=" in header
    assert int(header.rsplit("=", 1)[1]) > 0


def test_rpkm_bytes_are_equal(catalog):
    root = str(catalog["root"] / "rpkm")
    for pkg in PACKAGES:
        assert _cli(pkg, "rpkm")(
            ["--compute-rpkm", catalog["fix"]["gff"], catalog["fix"]["bam"],
             "--read-len", str(READ_LEN),
             "--output-dir", os.path.join(root, pkg)]) == 0
    (table,) = _same_trees(root).values()
    assert table.count(b"\n") == N + 1


@pytest.mark.parametrize("flags", [[], ["--paired-end", "120", "10"]])
def test_simulate_then_sam_to_bam_bytes_are_equal(catalog, flags):
    tag = "pe" if flags else "se"
    root = str(catalog["root"] / ("sim_" + tag))
    for pkg in PACKAGES:
        os.makedirs(os.path.join(root, pkg))
        sam = os.path.join(root, pkg, "reads.sam")
        assert _cli(pkg, "simulate")(
            ["--gff", catalog["fix"]["gff"], "--gene", "ev2", "--psi",
             "0.7,0.3", "--num-reads", "120", "--read-len", "30",
             "--seed", "9", "--output", sam] + flags) == 0
        assert _cli(pkg, "sam_to_bam")(
            ["--convert", sam, os.path.join(root, pkg, "bam")]) == 0
    files = _same_trees(root)
    assert "reads.sam" in files
    assert os.path.join("bam", "reads.sorted.bam") in files


def test_run_events_analysis_is_equal(catalog, capsys):
    said = {}
    for pkg in PACKAGES:
        rc = _cli(pkg, "run_events_analysis")(
            ["--check", catalog["idx"], catalog["fix"]["bam"]])
        out = capsys.readouterr()
        said[pkg] = (rc, out.out.splitlines()[-1])
        assert _cli(pkg, "run_events_analysis")([]) == 1
        assert "deprecated" in capsys.readouterr().err
    assert said["miso_tpu_torch"] == said["miso_tpu"] == (0, "0 warnings.")


# --------------------------------------------------------------- run_miso
def _header(path):
    with open(path) as f:
        fields = f.readline().lstrip("#").rstrip("\n").split("\t")
    chain_dependent = ("percent_accept", "assigned_counts")
    return [x for x in fields if x.split("=", 1)[0] not in chain_dependent]


def _mean(path):
    return float(np.loadtxt(path, skiprows=2, usecols=0, dtype=str,
                            converters=lambda s: s.split(",")[0]
                            ).astype(float).mean())


def _pickle_of(catalog, gene):
    from miso_tpu_torch.io.index import get_gene_ids_to_filenames
    return get_gene_ids_to_filenames(catalog["idx"])[gene]


def test_run_miso_compute_gene_psi_matches_the_run(catalog, capsys):
    """run_miso.py --compute-gene-psi --device cpu against miso_torch
    --run --device cpu on the same genes and seed: the same files, the
    same headers apart from the chain-dependent fields, posterior means
    within the Monte-Carlo tolerance of two runs at these settings."""
    run_miso = _cli("miso_tpu_torch", "run_miso")
    out = str(catalog["root"] / "run_miso_out")
    for gene in ("ev1", "ev6"):
        assert run_miso(
            ["--compute-gene-psi", gene, _pickle_of(catalog, gene),
             catalog["fix"]["bam"], out, "--read-len", str(READ_LEN),
             "--settings-filename", catalog["settings"], "--seed", "3",
             "--device", "cpu"]) == 0
        assert "Wrote 1 events." in capsys.readouterr().out
    for gene, chrom in (("ev1", "chr2"), ("ev6", "chr3")):
        mine = os.path.join(out, chrom, gene + ".miso")
        ran = os.path.join(catalog["out"], chrom, gene + ".miso")
        assert _header(mine) == _header(ran)
        assert abs(_mean(mine) - _mean(ran)) < 0.05
    # an event that has its file is not run again
    assert run_miso(
        ["--compute-gene-psi", "ev1", _pickle_of(catalog, "ev1"),
         catalog["fix"]["bam"], out, "--read-len", str(READ_LEN),
         "--settings-filename", catalog["settings"], "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "exists, not running MISO" in text and "Wrote 0 events." in text


def test_run_miso_genes_from_file_matches_jax_headers(catalog, capsys):
    """--compute-genes-from-file through both packages (the JAX one on
    its CPU backend): the same set of files, headers equal apart from
    the chain-dependent fields, means within the tolerance."""
    genes = ["ev0", "ev3", "ev5"]
    listing = catalog["root"] / "genes.txt"
    listing.write_text("".join("%s\t%s\n" % (g, _pickle_of(catalog, g))
                               for g in genes))
    outs = {}
    for pkg in PACKAGES:
        outs[pkg] = str(catalog["root"] / ("genes_file_" + pkg))
        dev = ["--device", "cpu"] if pkg == "miso_tpu_torch" else []
        assert _cli(pkg, "run_miso")(
            ["--compute-genes-from-file", str(listing),
             catalog["fix"]["bam"], outs[pkg], "--read-len", str(READ_LEN),
             "--settings-filename", catalog["settings"]] + dev) == 0
        assert "Wrote 3 events." in capsys.readouterr().out
    got = _tree(outs["miso_tpu_torch"])
    assert sorted(got) == sorted(_tree(outs["miso_tpu"])) and len(got) == 3
    for rel in got:
        paths = [os.path.join(outs[pkg], rel) for pkg in PACKAGES]
        assert _header(paths[1]) == _header(paths[0])
        assert abs(_mean(paths[1]) - _mean(paths[0])) < 0.05


def test_run_miso_passes_summarize_and_compare_through(catalog):
    root = str(catalog["root"] / "run_miso_tools")
    for pkg in PACKAGES:
        run_miso = _cli(pkg, "run_miso")
        dest = os.path.join(root, pkg)
        assert run_miso(["--summarize-samples", catalog["out"],
                         os.path.join(dest, "summ"),
                         "--summary-label", "lbl"]) == 0
        assert run_miso(["--compare-samples", catalog["out"],
                         catalog["out"], os.path.join(dest, "cmp"),
                         "--comparison-labels", "a", "b"]) == 0
    files = _same_trees(root)
    assert os.path.join("summ", "summary", "lbl.miso_summary") in files
    assert os.path.join("cmp", "a_vs_b", "bayes-factors",
                        "a_vs_b.miso_bf") in files


def test_run_miso_device_flag(catalog):
    """--device defaults to the card and never falls back to the CPU."""
    run_miso = importlib.import_module("miso_tpu_torch.cli.run_miso")
    assert run_miso.build_parser().parse_args([]).device == "cuda"
    assert run_miso.main([]) == 1          # no action: help, as the JAX one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_miso.main(
                ["--compute-gene-psi", "ev2", _pickle_of(catalog, "ev2"),
                 catalog["fix"]["bam"], str(catalog["root"] / "no_card"),
                 "--read-len", str(READ_LEN),
                 "--settings-filename", catalog["settings"]])
        assert not os.path.exists(
            str(catalog["root"] / "no_card" / "chr3" / "ev2.miso"))


# ------------------------------------------------------------- the probes
def test_module_availability_counts_what_is_missing(capsys, monkeypatch):
    from miso_tpu_torch import kernels
    from miso_tpu_torch.cli import module_availability as probe

    rc = probe.main([])
    text = capsys.readouterr().out
    for mod in probe.MODULES:
        assert "  - %s: available" % mod in text
    assert "jax" not in probe.MODULES and "torch" in probe.MODULES
    assert "native host library: " in text
    missing = int(not torch.cuda.is_available())
    try:
        kernels._nvcc()
    except RuntimeError:
        missing += 1
    assert rc == missing
    assert ("All modules available!" in text) == (missing == 0)
    # a card, a compiler and a library that are there count as nothing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "a card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "/somewhere/nvcc")
    assert probe.main([]) == 0
    text = capsys.readouterr().out
    assert "CUDA device: a card, 1 device(s)" in text
    assert "nvcc: /somewhere/nvcc" in text and "All modules" in text
    # an import that fails counts as one
    monkeypatch.setattr(probe, "MODULES", ["numpy", "no_such_module_xyz"])
    assert probe.main([]) == 1
    assert "no_such_module_xyz: NOT available" in capsys.readouterr().out


def test_test_miso_smoke_verdict(capsys):
    from miso_tpu_torch.cli import test_miso as selftest

    assert selftest.smoke("cpu") == 0
    text = capsys.readouterr().out
    assert "smoke test on cpu: posterior mean 0." in text and "OK" in text
    assert selftest.main(["--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            selftest.main([])
