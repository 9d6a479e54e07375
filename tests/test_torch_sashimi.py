"""The port's sashimi plots (miso_tpu_torch/plot/, cli/sashimi.py) against
the JAX package's, on the CPU.

The plot modules are copies (tests/test_torch_host_copy.py); here both
packages render from one ``miso_torch --run --device cpu`` sample of a
fixture catalog, and the figures are compared by their structure as
tests/test_sashimi_golden.py compares them (that test needs the
reference's data and skips without it): axes, their limits and tick
labels, junction arcs and posterior panels.  The card's machine has no
matplotlib; nothing outside ``miso_tpu_torch/plot/`` imports it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.patches import PathPatch  # noqa: E402

from miso_tpu.io.index import index_gff as jindex_gff  # noqa: E402
from miso_tpu.plot import sashimi as jsashimi  # noqa: E402
from miso_tpu_torch.cli import sashimi as sashimi_cli  # noqa: E402
from miso_tpu_torch.cli.main import main as torch_main  # noqa: E402
from miso_tpu_torch.io.comparison import (  # noqa: E402
    output_samples_comparison)
from miso_tpu_torch.io.index import get_gene_ids_to_filenames  # noqa: E402
from miso_tpu_torch.plot import sashimi as tsashimi  # noqa: E402
from miso_tpu_torch.testing import (  # noqa: E402
    cap_test_threads, indexed_catalog)

# a child interpreter takes the cap too
CHILD_THREADS = cap_test_threads()

FAST = "[sampler]\nburn_in = 20\nlag = 2\nnum_iters = 220\nnum_chains = 2\n"
PLOT = """\
[data]
bam_prefix = %s
miso_prefix = %s
bam_files = ["%s", "%s"]
miso_files = ["one", "two"]

[plotting]
fig_width = 7
fig_height = 5
intron_scale = 30
exon_scale = 4
colors = ["#CC0011", "#FF8800"]
number_junctions = True
%s
"""


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """Four genes through ``miso_torch --run --device cpu`` twice (seeds 0
    and 1), indexed by each package, and the Bayes factors between the
    two runs."""
    root = tmp_path_factory.mktemp("sashimi_torch")
    fix = indexed_catalog(str(root / "cat"), num_events=4,
                          reads_per_event=200, read_len=36, seed=4)
    fast = root / "fast.txt"
    fast.write_text(FAST)
    for name, seed in (("one", 0), ("two", 1)):
        assert torch_main(["--run", fix["index"], fix["bam"],
                           "--output-dir", str(root / name), "--read-len",
                           "36", "--settings-filename", str(fast),
                           "--seed", str(seed), "--device", "cpu"]) == 0
    jindex = str(root / "jindex")
    assert jindex_gff(fix["gff"], jindex)
    bf = output_samples_comparison(str(root / "one"), str(root / "two"),
                                   str(root / "cmp"))
    insert_len = root / "pairs.insert_len"
    lengths = np.random.default_rng(2).normal(250, 15, 400).astype(int)
    insert_len.write_text(
        "#mean=250.0,sdev=15.0,dispersion=1.0,num_pairs=400\n"
        "chr1:1-900:+\t%s\n" % ",".join(map(str, lengths)))
    bam_dir, bam = os.path.split(fix["bam"])
    return {"root": root, "fix": fix, "jindex": jindex, "bf": bf,
            "insert_len": str(insert_len), "bam_dir": bam_dir, "bam": bam,
            "event": sorted(get_gene_ids_to_filenames(fix["index"]))[0]}


def _settings(sample, name, extra=""):
    path = sample["root"] / ("%s.txt" % name)
    path.write_text(PLOT % (sample["bam_dir"], sample["root"],
                            sample["bam"], sample["bam"], extra))
    return str(path)


def _structure(fig):
    """What the golden test pins, per axis: limits, tick labels, junction
    arcs, and the artists of a posterior panel."""
    out = []
    for ax in fig.axes:
        out.append({
            "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
            "xticks": [t.get_text() for t in ax.get_xticklabels()],
            "yticks": [t.get_text() for t in ax.get_yticklabels()],
            "arcs": sum(isinstance(p, PathPatch) for p in ax.patches),
            "artists": len(ax.lines) + len(ax.patches),
            "visible": ax.axison})
    return out


@pytest.mark.parametrize("extra", ["", "reverse_minus = True\nymax = 40\n"
                                   "bar_posteriors = True\nlogged = True"],
                         ids=["stock", "options"])
def test_plot_event_has_the_jax_package_structure(sample, tmp_path, extra):
    settings = _settings(sample, "plot_" + str(len(extra)), extra)
    figs = []
    for mod, index, out in ((jsashimi, sample["jindex"], tmp_path / "j"),
                            (tsashimi, sample["fix"]["index"],
                             tmp_path / "t")):
        os.makedirs(out)
        path, fig = mod.plot_event(sample["event"], index, settings,
                                   str(out), return_figure=True)
        assert os.path.getsize(path) > 5000
        figs.append(fig)
    try:
        want, got = (_structure(f) for f in figs)
        # 2 samples x (density, posterior) + (mRNA, blank)
        assert len(got) == len(want) == 6
        assert got == want
        # the density axes have arcs, the posterior panels content
        assert all(got[i]["arcs"] > 0 for i in (0, 2))
        assert all(got[i]["artists"] > 0 for i in (1, 3))
    finally:
        for f in figs:
            plt.close(f)


def _bar_heights(monkeypatch, fn, *args):
    """Run a plot function that closes its figure; return the heights of
    the bars it drew."""
    kept = []
    monkeypatch.setattr(plt, "close", kept.append)
    fn(*args)
    monkeypatch.undo()
    (fig,) = kept
    heights = [p.get_height() for ax in fig.axes for p in ax.patches]
    plt.close(fig)
    return heights


@pytest.mark.parametrize("what", ["insert_len", "bf_dist"])
def test_histograms_have_the_jax_package_bins(sample, tmp_path, monkeypatch,
                                              what):
    settings = _settings(sample, "hist")
    got = {}
    for tag, mod in (("jax", jsashimi), ("torch", tsashimi)):
        out = tmp_path / tag
        os.makedirs(out)
        if what == "insert_len":
            got[tag] = _bar_heights(monkeypatch, mod.plot_insert_len,
                                    sample["insert_len"], settings, str(out))
        else:
            got[tag] = _bar_heights(monkeypatch, mod.plot_bf_dist,
                                    sample["bf"], settings, str(out))
    assert len(got["torch"]) == (50 if what == "insert_len" else 6)
    assert sum(got["torch"]) > 0
    assert got["torch"] == got["jax"]


def test_sashimi_plot_torch_writes_each_mode(sample, tmp_path, capsys):
    settings = _settings(sample, "cli")
    out = str(tmp_path / "plots")
    assert sashimi_cli.main(["--plot-event", sample["event"],
                             sample["fix"]["index"], settings,
                             "--output-dir", out]) == 0
    assert sashimi_cli.main(["--plot-insert-len", sample["insert_len"],
                             settings, "--output-dir", out]) == 0
    assert sashimi_cli.main(["--plot-bf-dist", sample["bf"], settings,
                             "--output-dir", out]) == 0
    names = sorted(os.listdir(out))
    assert names == sorted([
        sample["event"] + ".pdf",
        os.path.basename(sample["insert_len"]) + ".pdf",
        os.path.basename(sample["bf"]) + ".pdf"])
    assert all(os.path.getsize(os.path.join(out, n)) > 1000 for n in names)
    capsys.readouterr()
    assert sashimi_cli.main(["--plot-insert-len", sample["insert_len"],
                             settings]) == 1
    assert "Need --output-dir" in capsys.readouterr().err
    plt.close("all")


def test_the_port_imports_matplotlib_only_for_its_plots():
    """The card's machine has no matplotlib: importing the package, its
    CLIs (``sashimi_plot_torch`` too, whose plot module loads at its
    first call) and the pipeline loads none of it."""
    code = ("import sys, miso_tpu_torch, miso_tpu_torch.pipeline, "
            "miso_tpu_torch.cli.main, miso_tpu_torch.cli.sashimi, "
            "miso_tpu_torch.cli.run_miso, miso_tpu_torch.plot.settings; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'matplotlib'))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root,
                                  **CHILD_THREADS),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
