"""The port's host half is a copy of the JAX package's, not a fork.

``miso_tpu_torch`` imports nothing of ``miso_tpu``: its ``core/``,
``io/``, ``native/``, ``stats/intervals.py``, ``stats/bayes.py`` and
every ``cli/`` tool that runs on the host alone are the reference's
files with the package name changed.  Each file is held
to its original here, with every allowed difference listed, and the
copies are run beside the originals on seeded numpy inputs: the results
must be equal to the last bit.
"""
import dataclasses
import fcntl
import inspect
import os
import re
import tempfile

import numpy as np
import pytest

import miso_tpu
import miso_tpu.cli.main as jmain
import miso_tpu.testing as jtesting
import miso_tpu_torch
import miso_tpu_torch.cli.main as tmain
import miso_tpu_torch.testing as ttesting
from miso_tpu import native as jnative
from miso_tpu.core import events as jev
from miso_tpu.core import matching as jmatch
from miso_tpu.core.gene import make_gene as jmake_gene
from miso_tpu.core.simulate import simulate_reads as jsimulate
from miso_tpu.io import miso_file as jmiso
from miso_tpu.stats import intervals as jint
from miso_tpu_torch import native as tnative
from miso_tpu_torch.core import events as tev
from miso_tpu_torch.core import matching as tmatch
from miso_tpu_torch.core.gene import make_gene as tmake_gene
from miso_tpu_torch.core.simulate import simulate_reads as tsimulate
from miso_tpu_torch.io import miso_file as tmiso
from miso_tpu_torch.stats import intervals as tint
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()


def _load_native_libraries():
    """Both packages' native host libraries, built by one test process at
    a time.  Every worker imports this file before it runs a test, and two
    workers that build one library at once race on its temporary file:
    the loser's load returns None for the rest of its run, and its tests
    take the numpy routes."""
    with open(os.path.join(tempfile.gettempdir(),
                           "miso_native_build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jnative.load()
            tnative.load()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_load_native_libraries()

JAX_PKG = os.path.dirname(os.path.abspath(miso_tpu.__file__))
PORT_PKG = os.path.dirname(os.path.abspath(miso_tpu_torch.__file__))

COPIED = [
    "core/__init__.py", "core/events.py", "core/gene.py",
    "core/matching.py", "core/cigar.py", "core/fragments.py",
    "core/assignment.py", "core/simulate.py",
    "native/__init__.py", "native/bamlib.cpp", "native/matchlib.cpp",
    "native/parselib.cpp", "native/formatlib.cpp",
    "io/__init__.py", "io/settings.py", "io/sam.py", "io/index.py",
    "io/gff.py", "io/sanity.py", "io/miso_file.py", "io/miso_db.py",
    "stats/intervals.py", "cli/index_gff.py",
    "stats/bayes.py", "io/comparison.py", "core/as_events.py",
    "cli/summarize.py", "cli/compare.py", "cli/filter_events.py",
    "cli/pack.py", "cli/zip.py", "cli/exon_utils.py", "cli/pe_utils.py",
    "cli/rpkm.py", "cli/sam_to_bam.py", "cli/simulate.py",
    "cli/run_events_analysis.py", "cli/run_miso.py",
    "plot/__init__.py", "plot/settings.py", "plot/sashimi.py",
    "cli/sashimi.py",
]

WORD = "build" + "er"

# Every difference a copy may have from its original once the package
# name is substituted: (text in the original, text in the copy).
ALLOWED = {
    # the per-read tiles default to float32, the width the CUDA kernel
    # reads; the original's default imports jax.numpy for bfloat16
    "core/events.py": [
        ("""    if read_dtype is None:
        import jax.numpy as jnp
        read_dtype = jnp.bfloat16
""", """    if read_dtype is None:
        read_dtype = np.float32
"""),
        ("""    ``read_dtype`` (default bfloat16): they are loop-invariant and re-read
    from HBM every MCMC iteration, so their width bounds sampler
    throughput.  bfloat16 weights shift per-read sampling probabilities
    by <0.5% relative (0/1 compatibility weights are exact), well inside
    Monte-Carlo equivalence; the per-read log-score term cancels in the
    MH ratio and only shifts recorded log-likelihoods.
""", """    ``read_dtype`` (default float32, the width the CUDA kernel reads;
    the JAX package defaults to bfloat16 here).  The per-read log-score
    term cancels in the MH ratio and only shifts recorded
    log-likelihoods.
"""),
    ],
    # one word of two comments
    "core/as_events.py": [
        ("event->gene\n%ss in misopy/Gene.py:1042-1131" % WORD,
         "event->gene\nconstructors in misopy/Gene.py:1042-1131"),
    ],
    # --device, as on miso_torch: the sampler runs on the card unless the
    # caller asks for the CPU
    "cli/run_miso.py": [
        ("""                        "(.pickle filename), as misopy/run_miso.py:391.")
    return p
""", """                        "(.pickle filename), as misopy/run_miso.py:391.")
    p.add_argument("--device", default="cuda",
                   help="torch device of the sampler: 'cuda' (the CUDA "
                        "kernels, on every visible card; "
                        "CUDA_VISIBLE_DEVICES or 'cuda:N' restricts "
                        "it) or 'cpu' (their plain PyTorch versions).")
    return p
"""),
        ("    results = run_events(events, cfg, seed=args.seed)\n",
         "    results = run_events(events, cfg, seed=args.seed, "
         "device=args.device)\n"),
    ],
    "core/gene.py": [
        ("    %s used by the reference's own smoke tests." % WORD,
         "    constructor used by the reference's own smoke tests."),
    ],
    "io/sam.py": [
        ("                if v == 0:                # %s does" % WORD,
         "                if v == 0:                # scanner does"),
    ],
    # the paired batch matcher keys a class by its fragment-length
    # vector and has no isoform bitmask, so it takes genes of any width;
    # the single-end matchers keep the 62-isoform limit their mask needs
    "native/matchlib.cpp": [
        ("""//     out_class_ofs and noiso).
// Returns 0, -1 on bad cigar, -2 on overflow/noiso > 62.
int64_t miso_match_classes_paired_multi(""",
         """//     out_class_ofs and noiso).  A class is keyed by its fl vector,
//     not by an isoform bitmask, so a gene may have any noiso.
// Returns 0, -1 on bad cigar, -2 on overflow.
int64_t miso_match_classes_paired_multi("""),
        ("""        if (noiso > 62) return -2;
        const int64_t* eidx = exon_idx_flat + eidx_ofs[g];
        sig_index.clear();
        sig_pairs.clear();
""", """        const int64_t* eidx = exon_idx_flat + eidx_ofs[g];
        sig_index.clear();
        sig_pairs.clear();
"""),
    ],
    # its wrapper: no early None past 62 isoforms, and room sized by
    # each gene's own width, not every gene at the widest one's
    "native/__init__.py": [
        ("""    noiso_arr[g] consecutive entries of the flat streams -- or None if
    the native library is unavailable / noiso > 62.
    \"\"\"
    lib = load()
    if lib is None:
        return None
    n_genes = len(pair_lo)
    noiso_arr = np.ascontiguousarray(noiso_arr, np.int64)
    if noiso_arr.size and noiso_arr.max() > 62:
        return None
""", """    noiso_arr[g] consecutive entries of the flat streams -- or None if
    the native library is unavailable.  A class is keyed by its
    fragment-length vector, not by an isoform bitmask, so a gene may
    have any number of isoforms.
    \"\"\"
    lib = load()
    if lib is None:
        return None
    n_genes = len(pair_lo)
    noiso_arr = np.ascontiguousarray(noiso_arr, np.int64)
"""),
        ("""    cap_classes = tot_pairs + n_genes
    max_iso = int(noiso_arr.max()) if noiso_arr.size else 1
    cap_entries = cap_classes * max_iso
""", """    cap_classes = tot_pairs + n_genes
    # a gene has at most one class a pair (plus one), each of its own
    # width: one wide gene does not widen every other gene's room
    cap_entries = int(((pair_hi - pair_lo + 1) * noiso_arr).sum())
"""),
    ],
    # an index written by either package loads into the port's classes
    "io/index.py": [
        ('''def load_indexed_gene(pickle_filename: str) -> Dict[str, dict]:
    """Load one per-gene pickle ({gene_id: {'gene_object': Gene, ...}})."""
    with open(pickle_filename, "rb") as f:
        return pickle.load(f)
''', '''class _IndexUnpickler(pickle.Unpickler):
    """Reads an index written by either package: a class pickled under
    the JAX package's name resolves to this package's copy of it, so an
    existing index needs no re-indexing and no import of that package."""

    def find_class(self, module, name):
        if module == "miso_tpu" or module.startswith("miso_tpu."):
            module = "miso_tpu_torch" + module[len("miso_tpu"):]
        return super().find_class(module, name)


def load_indexed_gene(pickle_filename: str) -> Dict[str, dict]:
    """Load one per-gene pickle ({gene_id: {'gene_object': Gene, ...}})."""
    with open(pickle_filename, "rb") as f:
        return _IndexUnpickler(f).load()
'''),
        ("""    with open(path, "rb") as f:
        obj = pickle.load(f)
""", """    with open(path, "rb") as f:
        obj = _IndexUnpickler(f).load()
"""),
    ],
}


def renamed(text):
    """``text`` of the JAX package with the port's package name."""
    return re.sub(r"miso_tpu(?!_torch)", "miso_tpu_torch", text)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_its_original(rel):
    with open(os.path.join(JAX_PKG, rel)) as f:
        want = renamed(f.read())
    for old, new in ALLOWED.get(rel, []):
        assert want.count(renamed(old)) == 1, (rel, old)
        want = want.replace(renamed(old), new)
    with open(os.path.join(PORT_PKG, rel)) as f:
        assert f.read() == want


def test_every_allowed_difference_names_a_copied_module():
    assert set(ALLOWED) <= set(COPIED)


@pytest.mark.parametrize("name", [
    "make_se_catalog", "simulate_catalog_bam", "simulate_catalog_bam_paired",
    "build_paired_catalog_fixture", "build_catalog_fixture"])
def test_catalog_helper_equals_its_original(name):
    want = renamed(inspect.getsource(getattr(jtesting, name)))
    # the port's module imports the paired simulator at its top
    want = want.replace(
        "    from miso_tpu_torch.core.simulate import simulate_paired_reads"
        "\n\n", "")
    assert inspect.getsource(getattr(ttesting, name)) == want


def test_view_gene_equals_its_original():
    assert inspect.getsource(tmain.view_gene) == renamed(
        inspect.getsource(jmain.view_gene))


def test_parser_takes_the_flags_of_miso_and_device():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.nargs, a.default,
                         a.type, tuple(a.choices or ()), a.metavar)
                for a in parser._actions if a.dest != "help"}

    want, got = flags(jmain.build_parser()), flags(tmain.build_parser())
    device = got.pop("device")
    assert got == want
    assert device[0] == ("--device",) and device[2] == "cuda"


# ------------------------------------------------- behaviour, both packages
SE_GENE = ([100, 50, 100], [[1, 2, 3], [1, 3]])
G3_GENE = ([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])


def _events(mod_gene, mod_sim, mod_ev, seed, algorithm="reassign"):
    """Seeded events of two and three isoforms, compiled by one package."""
    out = []
    for j, (gene_def, psi, n) in enumerate((
            (SE_GENE, [0.7, 0.3], 120), (G3_GENE, [0.5, 0.3, 0.2], 500),
            (SE_GENE, [0.2, 0.8], 40), (G3_GENE, [0.1, 0.1, 0.8], 90))):
        gene = mod_gene(list(gene_def[0]), [list(i) for i in gene_def[1]])
        _, pos, cig = mod_sim(gene, psi, n, 25,
                              np.random.default_rng(seed + j))
        out.append(mod_ev.compile_single_end(gene, pos, cig, read_len=25,
                                             algorithm=algorithm))
    return out


def _both_events(seed, algorithm="reassign"):
    return (_events(jmake_gene, jsimulate, jev, seed, algorithm),
            _events(tmake_gene, tsimulate, tev, seed, algorithm))


@pytest.mark.parametrize("algorithm", ["reassign", "marginal", "classes"])
def test_compiled_events_are_equal(algorithm):
    def same(va, vb, what):
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=what)
        elif dataclasses.is_dataclass(va):
            assert type(va).__name__ == type(vb).__name__, what
            for f in dataclasses.fields(va):
                same(getattr(va, f.name), getattr(vb, f.name),
                     "%s.%s" % (what, f.name))
        else:
            assert va == vb, what

    for a, b in zip(*_both_events(3, algorithm)):
        for f in dataclasses.fields(a):
            if f.name != "gene":
                same(getattr(a, f.name), getattr(b, f.name), f.name)


@pytest.mark.parametrize("per_read", [True, False])
def test_pad_events_is_equal(per_read):
    jevs, tevs = _both_events(5)
    want = jev.pad_events(jevs, read_dtype=np.float32, per_read=per_read)
    got = tev.pad_events(tevs, read_dtype=np.float32, per_read=per_read)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_pad_events_defaults_to_float32_reads():
    _, tevs = _both_events(5)
    got = tev.pad_events(tevs)
    assert got["read_w"].dtype == np.float32
    assert got["read_logscore"].dtype == np.float32
    np.testing.assert_array_equal(
        got["read_w"], tev.pad_events(tevs, read_dtype=np.float32)["read_w"])


def test_bucket_events_is_equal():
    jevs, tevs = _both_events(7)
    assert tev.bucket_events(tevs * 3) == jev.bucket_events(jevs * 3)
    for x in (1, 2, 3, 5, 9, 33, 300, 513, 2049, 20000):
        assert tev._round_up_reads(x) == jev._round_up_reads(x)
        assert tev._round_up_iso(min(x, 256)) == jev._round_up_iso(
            min(x, 256))


def _reads(seed, n=400):
    gene_def = G3_GENE
    rng = np.random.default_rng(seed)
    jg = jmake_gene(list(gene_def[0]), [list(i) for i in gene_def[1]])
    tg = tmake_gene(list(gene_def[0]), [list(i) for i in gene_def[1]])
    _, pos, cig = jsimulate(jg, [0.5, 0.3, 0.2], n, 25, rng)
    # some reads that match nothing
    pos = np.concatenate([pos, rng.integers(1, 300, 20)])
    cig = list(cig) + ["10M7N15M"] * 20
    return jg, tg, pos, cig


def test_native_libraries_build_apart():
    jl, tl = jnative.load(), tnative.load()
    assert jl is not None and tl is not None
    assert os.path.dirname(tl._name) == os.path.join(PORT_PKG, "native")
    assert os.path.dirname(jl._name) == os.path.join(JAX_PKG, "native")


def test_native_cigar_match_is_equal():
    jg, tg, pos, cig = _reads(11)
    want = jmatch.match_iso(jg, pos, cig, read_len=25)
    got = tmatch.match_iso(tg, pos, cig, read_len=25)
    assert want.any()
    np.testing.assert_array_equal(got, want)


def test_native_read_class_collapse_is_equal():
    jg, tg, pos, cig = _reads(13)
    (want, want_any) = jmatch.match_classes(jg, pos, cig, read_len=25)
    (got, got_any) = tmatch.match_classes(tg, pos, cig, read_len=25)
    assert got_any == want_any
    np.testing.assert_array_equal(got.templates, want.templates)
    np.testing.assert_array_equal(got.counts, want.counts)
    # the numpy route of each package gives the same classes
    plain = tmatch.collapse_to_classes(
        tmatch.match_iso(tg, pos, cig, read_len=25))
    np.testing.assert_array_equal(plain.templates, want.templates)
    np.testing.assert_array_equal(plain.counts, want.counts)


@pytest.mark.parametrize("quantized", [False, True])
def test_write_miso_file_bytes_are_equal(tmp_path, quantized):
    jevs, tevs = _both_events(17)
    rng = np.random.default_rng(19)
    for j, (a, b) in enumerate(zip(jevs, tevs)):
        S, k = 60, a.num_iso
        psi = rng.dirichlet(np.ones(k), size=S)
        scores = -rng.random(S) * 500.0
        kw = dict(iters=600, burn_in=100, lag=5, percent_accept=41.5,
                  final_n=rng.integers(0, 50, k).astype(np.float64))
        if quantized:
            kw["psi_ticks"] = np.round(psi * 1e4).astype(np.int64)
            kw["score_cents"] = np.round(scores * 100).astype(np.int64)
        paths = [str(tmp_path / ("%s_%d.miso" % (w, j))) for w in "jt"]
        jmiso.write_miso_file(paths[0], a, psi, scores, **kw)
        tmiso.write_miso_file(paths[1], b, psi, scores, **kw)
        with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
            want, got = f0.read(), f1.read()
        assert len(want) > 1000 and got == want


def test_ci_bound_indices_are_equal():
    for n in list(range(0, 130)) + [200, 450, 2700, 5400, 10 ** 6]:
        for level in (0.95, 0.9, 0.5):
            assert tint.ci_bound_indices(n, level) == jint.ci_bound_indices(
                n, level)
