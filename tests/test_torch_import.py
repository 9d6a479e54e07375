"""The port imports neither jax nor the JAX package: the card's machine
has no jax, and the port's host half is its own copy.

tests/conftest.py imports jax before any test runs, so the import checks
run in a fresh interpreter.
"""
import os
import pkgutil
import re
import socket
import subprocess
import sys

import pytest

import miso_tpu_torch
from miso_tpu_torch.testing import cap_test_threads

# a child interpreter takes the cap too
CHILD_THREADS = cap_test_threads()

PKG = os.path.dirname(os.path.abspath(miso_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)

# printed by the fresh interpreter: the modules it must not hold
FOREIGN = ("print('FOREIGN', sorted(m for m in sys.modules if "
           "m.split('.')[0] in ('jax', 'jaxlib', 'miso_tpu')))")
SETTINGS = """\
[data]
min_event_reads = 20

[sampler]
burn_in = 20
lag = 5
num_iters = 220
num_chains = 2
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _fresh(code, timeout=600):
    env = dict(os.environ, PYTHONPATH=ROOT, **CHILD_THREADS)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("FOREIGN ")]
    assert lines, out.stdout[-2000:]
    return lines[-1]


def port_modules():
    """Every Python module of the port (its built libraries are no
    modules, though they lie in its packages)."""
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="miso_tpu_torch.")
        if not m.name.rsplit(".", 1)[1].startswith("lib"))


def test_port_imports_leave_jax_out():
    names = port_modules()
    assert {"miso_tpu_torch.pipeline", "miso_tpu_torch.core.events",
            "miso_tpu_torch.io.sam", "miso_tpu_torch.native",
            "miso_tpu_torch.cli.main", "miso_tpu_torch.kernels",
            "miso_tpu_torch.sampler.reassign_kernel",
            "miso_tpu_torch.parallel.distributed",
            "miso_tpu_torch.stats.bayes", "miso_tpu_torch.io.comparison",
            "miso_tpu_torch.core.as_events"} <= set(names)
    assert {"miso_tpu_torch.cli." + m for m in (
        "summarize", "compare", "filter_events", "pack", "zip",
        "exon_utils", "pe_utils", "rpkm", "sam_to_bam", "simulate",
        "run_events_analysis", "run_miso", "module_availability",
        "test_miso")} <= set(names)
    code = "import sys, miso_tpu_torch, %s; %s" % (", ".join(names), FOREIGN)
    assert _fresh(code) == "FOREIGN []"


@pytest.mark.parametrize("flags,events,reads", [
    ([], 6, 200), (["--paired-end", "250", "15"], 6, 150),
    (["--algorithm", "marginal", "--linear-start", "--pack-output"], 6, 200),
    ([], 2, 17000)],
    ids=["single_end", "paired_end", "marginal_packed", "deep_bucket"])
def test_a_run_of_the_port_leaves_jax_and_the_jax_package_out(
        tmp_path, flags, events, reads):
    """Catalog, index and ``miso_torch --run --device cpu`` in a fresh
    interpreter: neither jax nor miso_tpu is imported on the way.  Genes
    of 17,000 reads form a deep REASSIGN bucket (the multinomial route)."""
    settings = tmp_path / "settings.txt"
    settings.write_text(SETTINGS)
    paired = "--paired-end" in flags
    code = """
import os, sys
from miso_tpu_torch.cli.main import main
from miso_tpu_torch.sampler import deep
from miso_tpu_torch.testing import indexed_catalog
fix = indexed_catalog({cat!r}, num_events={events},
                      reads_per_event={reads}, read_len={read_len}, seed=3,
                      paired={paired})
rc = main(["--run", fix["index"], fix["bam"], "--output-dir", {out!r},
           "--read-len", "{read_len}", "--settings-filename", {settings!r},
           "--device", "cpu"] + {flags!r})
assert rc == 0
assert deep.LAUNCHES["plain"] == {deep_runs}, deep.LAUNCHES
with open(os.path.join({out!r}, "summary", "out.miso_summary")) as f:
    assert len(f.read().splitlines()) == {events} + 1
{foreign}
""".format(cat=str(tmp_path / "cat"), out=str(tmp_path / "out"),
           settings=str(settings), flags=flags, paired=paired,
           events=events, deep_runs=int(reads > 16384), reads=reads, read_len=40 if paired else 36,
           foreign=FOREIGN)
    assert _fresh(code) == "FOREIGN []"


def test_the_users_path_leaves_jax_and_the_jax_package_out(tmp_path):
    """Two hosts of ``miso_torch --run`` (host 1 a process of its own,
    host 0 this interpreter), then the port's summarize, compare, filter, run_miso.py and its two
    probes, all in one fresh interpreter: no jax, no miso_tpu."""
    settings = tmp_path / "settings.txt"
    settings.write_text(SETTINGS)
    code = """
import glob, os, subprocess, sys
from miso_tpu_torch.cli.main import main
from miso_tpu_torch.cli import (compare, filter_events, module_availability,
                                run_miso, summarize, test_miso)
from miso_tpu_torch.io.index import get_gene_ids_to_filenames
from miso_tpu_torch.io.sam import open_alignments
from miso_tpu_torch.testing import indexed_catalog
fix = indexed_catalog({cat!r}, num_events=6, reads_per_event=200,
                      read_len=36, seed=3)
bam = open_alignments(fix["bam"])     # the .bai, before two hosts race on it
list(bam.fetch(bam.references[0], 0, 1))
run = ["--run", fix["index"], fix["bam"], "--output-dir", {out!r},
       "--read-len", "36", "--settings-filename", {settings!r},
       "--device", "cpu", "--coordinator", "127.0.0.1:{port}",
       "--num-hosts", "2"]
other = subprocess.Popen([sys.executable, "-m", "miso_tpu_torch.cli.main"]
                         + run + ["--host-id", "1"])
try:
    assert main(run + ["--host-id", "0"]) == 0
    assert other.wait(timeout=300) == 0
finally:
    if other.poll() is None:
        other.kill()
assert len(glob.glob(os.path.join({out!r}, "summary", "*.host*"))) == 2
assert summarize.main(["--summarize-samples", {out!r}, {summ!r}]) == 0
assert compare.main(["--compare-samples", {out!r}, {out!r}, {cmp!r}]) == 0
(bf,) = glob.glob(os.path.join({cmp!r}, "*", "bayes-factors", "*.miso_bf"))
assert len(open(bf).read().splitlines()) == 7
assert filter_events.main(["--filter", bf, "--output-dir", {filt!r}]) == 0
gene, pickle = sorted(get_gene_ids_to_filenames(fix["index"]).items())[0]
assert run_miso.main(["--compute-gene-psi", gene, pickle, fix["bam"],
                      {single!r}, "--read-len", "36", "--settings-filename",
                      {settings!r}, "--device", "cpu"]) == 0
assert len(glob.glob(os.path.join({single!r}, "*", "*.miso"))) == 1
module_availability.main([])
assert test_miso.main(["--device", "cpu"]) == 0
{foreign}
""".format(cat=str(tmp_path / "cat"), out=str(tmp_path / "out"),
           summ=str(tmp_path / "summ"), cmp=str(tmp_path / "cmp"),
           filt=str(tmp_path / "filt"), single=str(tmp_path / "single"),
           settings=str(settings), foreign=FOREIGN, port=_free_port())
    assert _fresh(code) == "FOREIGN []"


def test_an_index_of_the_jax_package_loads_without_it(tmp_path):
    """An index written by the JAX package's ``index_gff`` pickles that
    package's Gene class; the port reads it into its own."""
    from miso_tpu.cli.index_gff import main as index_main
    from miso_tpu.testing import build_catalog_fixture

    fix = build_catalog_fixture(str(tmp_path / "fix"), num_events=5,
                                reads_per_event=120, seed=5)
    index_dir = str(tmp_path / "index")
    assert index_main(["--index", fix["gff"], index_dir]) == 0
    settings = tmp_path / "settings.txt"
    settings.write_text(SETTINGS)
    code = """
import sys
from miso_tpu_torch.cli.main import main
from miso_tpu_torch.io.index import (get_gene_ids_to_filenames,
                                     load_indexed_gene)
for gene_id, fname in get_gene_ids_to_filenames({index!r}).items():
    gene = load_indexed_gene(fname)[gene_id]["gene_object"]
    assert type(gene).__module__ == "miso_tpu_torch.core.gene", type(gene)
rc = main(["--run", {index!r}, {bam!r}, "--output-dir", {out!r},
           "--read-len", "36", "--settings-filename", {settings!r},
           "--device", "cpu", "--summary-only"])
assert rc == 0
{foreign}
""".format(index=index_dir, bam=fix["bam"], out=str(tmp_path / "out"),
           settings=str(settings), foreign=FOREIGN)
    assert _fresh(code) == "FOREIGN []"


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(import|from) (jax|miso_tpu)(\.|\s|$)", re.M)
    offenders = []
    for d, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                with open(path) as f:
                    if pat.search(f.read()):
                        offenders.append(os.path.relpath(path, ROOT))
    assert not offenders
    # nor does the smoke script
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        assert not re.search(r"^\s*(import|from) (jax|miso_tpu)\b",
                             f.read(), re.M)


def test_chip_smoke_imports_no_jax_and_no_plots():
    """The card's machine has neither jax nor matplotlib: the smoke
    script, imported in a fresh interpreter, loads no jax, nothing of the
    JAX package and no matplotlib, and its source names none of them in
    an import."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from) (jax|miso_tpu|matplotlib)\b",
                         src, re.M)
    assert not re.search(r"import_module\(|__import__\(", src)
    code = ("import sys; sys.argv = ['chip_smoke.py']; import chip_smoke; "
            "print('FOREIGN', sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'miso_tpu', "
            "'matplotlib')))")
    assert _fresh(code) == "FOREIGN []"


def test_tf32_is_off():
    import torch
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
