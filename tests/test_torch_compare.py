"""The port's summarize / compare / filter tools (stats/bayes.py,
io/comparison.py, cli/summarize.py, cli/compare.py, cli/filter_events.py)
and core/as_events.py against the JAX package's, on the CPU.

One pair of ``miso_torch --run --device cpu`` output trees (two simulated
samples with a known delta-psi) goes through both packages' CLIs: the
``.miso_summary``, ``.miso_bf`` and ``.filtered`` files must be equal
byte for byte.  Beside them the cases of tests/test_differential.py,
tests/test_filter_votes.py and tests/test_as_events.py on the port's
modules.
"""
import importlib
import os

import numpy as np
import pytest
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()

FAST_SETTINGS = """\
[sampler]
burn_in = 150
lag = 5
num_iters = 900
num_chains = 2
"""
N = 12
PACKAGES = ["miso_tpu", "miso_tpu_torch"]


def _mod(pkg, name):
    return importlib.import_module("%s.%s" % (pkg, name))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two samples over one 12-gene catalog, run by the port on the CPU:
    psi = 0.8 everywhere in s1; the first half drops to 0.2 in s2."""
    from miso_tpu_torch.cli.index_gff import main as index_main
    from miso_tpu_torch.cli.main import main as torch_main
    from miso_tpu_torch.io.gff import write_gff
    from miso_tpu_torch.testing import make_se_catalog, simulate_catalog_bam

    root = tmp_path_factory.mktemp("torch_compare")
    rng = np.random.default_rng(21)
    genes, records, _ = make_se_catalog(N, rng)
    gff = str(root / "c.gff")
    write_gff(records, gff)
    idx = str(root / "idx")
    assert index_main(["--index", gff, idx]) == 0
    settings = root / "s.txt"
    settings.write_text(FAST_SETTINGS)
    psi1 = np.full(N, 0.8)
    psi2 = np.where(np.arange(N) < N // 2, 0.2, 0.8)
    for seed, (label, psis) in enumerate((("s1", psi1), ("s2", psi2))):
        bam = str(root / ("%s.bam" % label))
        simulate_catalog_bam(genes, psis, 500, 36, bam,
                             np.random.default_rng(100 + seed))
        assert torch_main(["--run", idx, bam, "--output-dir",
                           str(root / ("%s_out" % label)),
                           "--read-len", "36", "--settings-filename",
                           str(settings), "--device", "cpu"]) == 0
    return root


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _bf_path(cmp_dir):
    return os.path.join(cmp_dir, "s1_out_vs_s2_out", "bayes-factors",
                        "s1_out_vs_s2_out.miso_bf")


@pytest.fixture(scope="module")
def compared(trees):
    """The .miso_bf of each package's compare CLI over the same trees."""
    out = {}
    for pkg in PACKAGES:
        cmp_dir = str(trees / ("cmp_" + pkg))
        assert _mod(pkg, "cli.compare").main(
            ["--compare-samples", str(trees / "s1_out"),
             str(trees / "s2_out"), cmp_dir]) == 0
        out[pkg] = _bf_path(cmp_dir)
    return out


def test_summarize_bytes_are_equal(trees):
    got = {}
    for pkg in PACKAGES:
        for label in ("s1", "s2"):
            dest = str(trees / ("summ_%s_%s" % (pkg, label)))
            assert _mod(pkg, "cli.summarize").main(
                ["--summarize-samples", str(trees / (label + "_out")),
                 dest]) == 0
            got[pkg, label] = _read(os.path.join(
                dest, "summary", "%s_out.miso_summary" % label))
    for label in ("s1", "s2"):
        assert got["miso_tpu_torch", label].count(b"\n") == N + 1
        assert got["miso_tpu_torch", label] == got["miso_tpu", label]
    # the run's own summary holds the same rows as the summarizer's (it
    # sorts them by event name, the summarizer walks the directories)
    run_rows = _read(str(trees / "s1_out" / "summary" /
                         "s1_out.miso_summary")).splitlines()
    summ_rows = got["miso_tpu_torch", "s1"].splitlines()
    assert run_rows[0] == summ_rows[0]
    assert sorted(run_rows[1:]) == sorted(summ_rows[1:])


def test_summary_label_and_missing_dir(trees, capsys):
    for pkg in PACKAGES:
        dest = str(trees / ("summ_label_" + pkg))
        assert _mod(pkg, "cli.summarize").main(
            ["--summarize-samples", str(trees / "s1_out"), dest,
             "--summary-label", "mine"]) == 0
        assert os.listdir(os.path.join(dest, "summary")) == [
            "mine.miso_summary"]
    assert (_read(str(trees / "summ_label_miso_tpu_torch" / "summary" /
                      "mine.miso_summary"))
            == _read(str(trees / "summ_label_miso_tpu" / "summary" /
                         "mine.miso_summary")))
    codes = [_mod(pkg, "cli.summarize").main(
        ["--summarize-samples", str(trees / "nowhere"),
         str(trees / "unused")]) for pkg in PACKAGES]
    assert codes[0] == codes[1] != 0


def test_compare_bytes_are_equal(compared):
    want, got = _read(compared["miso_tpu"]), _read(
        compared["miso_tpu_torch"])
    assert got.count(b"\n") == N + 1
    assert got == want


def test_compare_with_labels_bytes_are_equal(trees):
    got = {}
    for pkg in PACKAGES:
        cmp_dir = str(trees / ("cmp_labels_" + pkg))
        assert _mod(pkg, "cli.compare").main(
            ["--compare-samples", str(trees / "s1_out"),
             str(trees / "s2_out"), cmp_dir,
             "--comparison-labels", "ctl", "kd"]) == 0
        got[pkg] = _read(os.path.join(
            cmp_dir, "ctl_vs_kd", "bayes-factors", "ctl_vs_kd.miso_bf"))
    assert got["miso_tpu_torch"] == got["miso_tpu"]
    assert got["miso_tpu_torch"].count(b"\n") == N + 1


def test_filter_bytes_are_equal(trees, compared):
    got = {}
    for pkg in PACKAGES:
        fdir = str(trees / ("filt_" + pkg))
        assert _mod(pkg, "cli.filter_events").main(
            ["--filter", compared["miso_tpu_torch"], "--output-dir", fdir,
             "--bayes-factor", "20", "--delta-psi", "0.3",
             "--num-inc", "1", "--num-exc", "1"]) == 0
        got[pkg] = _read(os.path.join(
            fdir, "s1_out_vs_s2_out.miso_bf.filtered"))
    assert got["miso_tpu_torch"] == got["miso_tpu"]


def test_bayes_factors_separate_changed_events(trees, compared):
    """tests/test_differential.py's contract on the port: run, compare
    and filter all by the port."""
    from miso_tpu_torch.cli.filter_events import main as filter_main
    from miso_tpu_torch.cli.filter_events import read_bf_file

    bf_file = compared["miso_tpu_torch"]
    _, rows = read_bf_file(bf_file)
    assert len(rows) == N
    by_event = {r["event_name"]: r for r in rows}
    half = N // 2
    changed = [by_event["ev%d" % e] for e in range(half)]
    same = [by_event["ev%d" % e] for e in range(half, N)]
    assert all(float(r["diff"]) > 0.35 for r in changed), changed
    assert all(float(r["bayes_factor"]) > 20 for r in changed), changed
    assert all(abs(float(r["diff"])) < 0.3 for r in same), same
    fdir = str(trees / "filt_contract")
    assert filter_main(["--filter", bf_file, "--output-dir", fdir,
                        "--bayes-factor", "20", "--delta-psi", "0.3",
                        "--num-inc", "1", "--num-exc", "1"]) == 0
    with open(os.path.join(fdir, "s1_out_vs_s2_out.miso_bf.filtered")) as f:
        lines = f.read().splitlines()
    kept = {line.split("\t")[0] for line in lines[1:]}
    assert kept == {"ev%d" % e for e in range(half)}, kept


def _fake_samples(pkg, rng):
    """The inputs of test_differential.py's batch-against-scalar case,
    as ``pkg``'s MISOFileData."""
    mf = _mod(pkg, "io.miso_file")

    def fake(samples):
        samples = np.asarray(samples, np.float64)
        header = ("#isoforms=['a','b']\tcounts=(1,0):5\t"
                  "assigned_counts=0:3,1:2\tchrom=chr1\tstrand=+\t"
                  "mRNA_starts=1,1\tmRNA_ends=9,9")
        return mf.MISOFileData(
            samples=samples, header=header,
            log_scores=np.zeros(len(samples)),
            sampled_map=list(samples[0]), sampled_map_log_score=0.0,
            counts_info=mf.get_counts_from_header(header),
            params=mf.parse_sampler_params_from_header(header))

    names, s1s, s2s = [], [], []
    for e in range(40):  # 2-isoform events, various separations
        c1 = np.clip(rng.beta(8, 4, 200), 1e-4, 1 - 1e-4)
        shift = [0.0, 0.3, 0.003][e % 3]
        c2 = np.clip(rng.beta(8, 4, 200) - shift, 1e-4, 1 - 1e-4)
        names.append("e%d" % e)
        s1s.append(fake(np.stack([c1, 1 - c1], axis=1)))
        s2s.append(fake(np.stack([c2, 1 - c2], axis=1)))
    for e in range(12):  # 3-isoform events (csv branches)
        names.append("m%d" % e)
        s1s.append(fake(rng.dirichlet([4, 3, 2], 200)))
        s2s.append(fake(rng.dirichlet([2, 3, 4], 200)))
    names.append("null")  # identical samples (all_same -> BF 0.0)
    s1s.append(fake(s1s[0].samples))
    s2s.append(fake(s1s[0].samples))
    names.append("ragged")  # shape mismatch falls back to scalar
    s1s.append(fake(s1s[0].samples[:150]))
    s2s.append(fake(s2s[0].samples))
    return names, s1s, s2s


def test_batch_comparison_matches_scalar_rows():
    """The port's batched comparison rows equal its per-event scalar
    rows, and both equal the JAX package's, field for field."""
    rows = {}
    for pkg in PACKAGES:
        cmp_mod = _mod(pkg, "io.comparison")
        names, s1s, s2s = _fake_samples(pkg, np.random.default_rng(9))
        batch = cmp_mod._comparison_rows(names, s1s, s2s, 0.95)
        scalar = [cmp_mod._comparison_fields(nm, a, b, 0.95)
                  for nm, a, b in zip(names, s1s, s2s)]
        assert len(batch) == len(scalar) == 54
        for got, want in zip(batch, scalar):
            assert got == want, (got, want)
        rows[pkg] = batch
    assert rows["miso_tpu_torch"] == rows["miso_tpu"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bayes_factors_are_equal(seed):
    """stats/bayes.py of both packages on seeded posteriors: the scalar
    and the batched Savage-Dickey factors, to the last bit."""
    jb, tb = _mod("miso_tpu", "stats.bayes"), _mod("miso_tpu_torch",
                                                   "stats.bayes")
    rng = np.random.default_rng(seed)
    a = np.clip(rng.beta(6, 3, (5, 300)), 1e-4, 1 - 1e-4)
    b = np.clip(rng.beta(3, 6, (5, 300)) + 0.1 * seed, 1e-4, 1 - 1e-4)
    s1 = np.stack([a, 1 - a], axis=-1)                # (E, S, I)
    s2 = np.stack([b, 1 - b], axis=-1)
    want = jb.batch_bayes_factors(s1, s2)
    got = tb.batch_bayes_factors(s1, s2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for e in range(5):
        assert tb.compute_bayes_factors(s1[e], s2[e]) == \
            jb.compute_bayes_factors(s1[e], s2[e])


# ---------------------------------- tests/test_filter_votes.py on the port
def _row(name, bf, dp, c1="(1,0):50,(0,1):50", c2="(1,0):50,(0,1):50"):
    return {"event_name": name, "bayes_factor": str(bf), "diff": str(dp),
            "sample1_counts": c1, "sample2_counts": c2}


def test_get_counts_two_isoform():
    from miso_tpu_torch.cli.filter_events import get_counts
    assert get_counts("(0,0):278,(0,1):2513,(1,1):798") == (0, 2513, 798)
    assert get_counts("(1,0):5,(0,1):3") == (5, 3, 0)


def test_get_counts_rejects_multi_isoform_and_garbage():
    from miso_tpu_torch.cli.filter_events import get_counts
    assert get_counts("(1,0,0):5,(0,1,0):3") is None
    assert get_counts("n/a") is None
    assert get_counts("") is None


def test_count_thresholds():
    from miso_tpu_torch.cli.filter_events import CountThresholds
    t = CountThresholds(total=10, inc=1, exc=1, inc_plus_exc=5)
    assert t.passes((4, 3, 5))
    assert not t.passes((4, 0, 10))   # no exclusion reads
    assert not t.passes((2, 2, 3))    # total below 10


def test_single_table_filter():
    from miso_tpu_torch.cli.filter_events import filter_events
    rows = [_row("a", 100.0, 0.3), _row("b", 1.0, 0.3),
            _row("c", 100.0, 0.01)]
    out = filter_events(rows, 0, 0, 0, 0, 0.2, 10.0)
    assert [r["event_name"] for r in out] == ["a"]


def test_votes_requires_agreement_across_replicates():
    from miso_tpu_torch.cli.filter_events import multi_filter
    reps = []
    for sign in (1, -1, 1):
        reps.append([
            _row("good", 50.0, 0.4),
            _row("flip", 50.0, sign * 0.4),
            _row("weak", 50.0 if sign > 0 else 1.0, 0.4),
        ])
    reps[1][2]["bayes_factor"] = "1.0"
    reps[2][2]["bayes_factor"] = "1.0"
    out = multi_filter(reps, 0, 0, 0, 0, 0.2, 10.0, votes=3)
    names = [{r["event_name"] for r in rows} for rows in out]
    assert all(n == {"good"} for n in names), names


def test_votes_two_of_three():
    from miso_tpu_torch.cli.filter_events import multi_filter
    reps = []
    for present in (True, True, False):
        rows = [_row("x", 50.0, 0.4)] if present else [_row("x", 1.0, 0.4)]
        reps.append(rows)
    out = multi_filter(reps, 0, 0, 0, 0, 0.2, 10.0, votes=2)
    assert [len(rows) for rows in out] == [1, 1, 0]
    out3 = multi_filter(reps, 0, 0, 0, 0, 0.2, 10.0, votes=3)
    assert [len(rows) for rows in out3] == [0, 0, 0]


def test_cli_votes_roundtrip(tmp_path):
    """--votes through both packages' CLIs: the same files, byte for
    byte, keeping only the event whose direction agrees."""
    header = ("event_name\tbayes_factor\tdiff\tsample1_counts\t"
              "sample2_counts\n")
    paths = []
    for i, sign in enumerate((1, 1, -1)):
        p = tmp_path / ("rep%d.miso_bf" % i)
        lines = [header]
        lines.append("ev_ok\t99\t0.5\t(1,0):30,(0,1):30\t(1,0):30,(0,1):30\n")
        lines.append("ev_dir\t99\t%s\t(1,0):30,(0,1):30\t(1,0):30,(0,1):30\n"
                     % (sign * 0.5))
        p.write_text("".join(lines))
        paths.append(str(p))
    for pkg in PACKAGES:
        assert _mod(pkg, "cli.filter_events").main(
            ["--filter"] + paths + ["--output-dir", str(tmp_path / pkg),
             "--bayes-factor", "10", "--delta-psi", "0.2",
             "--votes", "3"]) == 0
    for i in range(3):
        name = "rep%d.miso_bf.filtered" % i
        got = _read(str(tmp_path / "miso_tpu_torch" / name))
        assert got == _read(str(tmp_path / "miso_tpu" / name))
        lines = got.decode().splitlines()
        assert len(lines) == 2  # header + ev_ok only
        assert lines[1].startswith("ev_ok\t")


# ------------------------------------- tests/test_as_events.py on the port
def test_parse_se_event_name():
    from miso_tpu_torch.core.as_events import parse_event_information
    name = "chr17:100:199:+;chr17:300:349:+;chr17:500:599:+"
    ev = parse_event_information(name, "SE")
    assert ev.chrom == "chr17"
    assert ev.up_part_len == 100
    assert ev.len == 50
    assert ev.dn_part_len == 100


def test_se_event_to_gene():
    from miso_tpu_torch.core.as_events import se_event_to_gene
    g = se_event_to_gene(100, 50, 100, "chr1", label="ev")
    assert g.num_isoforms == 2
    assert g.iso_lengths.tolist() == [250, 200]
    assert [p.label for p in g.parts] == ["A", "B", "C"]


def test_tandem_utr_event_to_gene():
    from miso_tpu_torch.core.as_events import tandem_utr_event_to_gene
    g = tandem_utr_event_to_gene(200, 100, "chr2")
    assert g.iso_lengths.tolist() == [300, 200]


def test_filter_se_events():
    from miso_tpu_torch.core.as_events import MISOEvents, TwoIsoEvent
    events = {}
    for i, (ni, ne, nb) in enumerate([(5, 5, 20), (0, 5, 30), (10, 0, 5)]):
        ev = TwoIsoEvent(label="e%d" % i, event_type="SE")
        ev.num_inc, ev.num_exc, ev.num_common = ni, ne, nb
        events[ev.label] = ev
    m = MISOEvents(2, "SE", events=events)
    m.filter_se_events(atleast_inc=1, atleast_exc=1, atleast_sum=20)
    assert sorted(m.events) == ["e0"]


def test_events_to_genes_and_sampler():
    """The legacy two-isoform flow on the port: NI/NE/NB counts -> gene
    -> the REASSIGN sampler (its plain version, on the CPU)."""
    from miso_tpu_torch.core.as_events import se_event_to_gene
    from miso_tpu_torch.core.events import (pad_events,
                                            two_iso_event_from_counts)
    from miso_tpu_torch.sampler.mcmc import SamplerConfig, batch_from_numpy
    from miso_tpu_torch.sampler.reassign_kernel import run_batch_reassign

    g = se_event_to_gene(100, 50, 100, "chr1", label="ev")
    ev = two_iso_event_from_counts(g, ni=500, ne=50, nb=40, read_len=36)
    batch, _ = batch_from_numpy(pad_events([ev]), "cpu")
    res = run_batch_reassign(
        0, batch, SamplerConfig(iters=800, burn_in=200, lag=5, chains=2))
    mean = float(res.flat_samples()[0][:, 0].mean())
    assert mean > 0.75, mean   # heavy inclusion support -> high psi


def test_load_event_counts_se(tmp_path):
    from miso_tpu_torch.core.as_events import load_event_counts
    p = tmp_path / "se_counts.txt"
    p.write_text(
        "chr1:1:100:+;chr1:200:249:+;chr1:300:399:+\t10;5;8;3;4;7\n"
        "chr1:1:50:+;chr1:60:79:+;chr1:90:139:+\t0;0;0;0;0;1\n")
    evs = load_event_counts(str(p), "SE")
    assert len(evs) == 2
    ev = evs.get_event("chr1:1:100:+;chr1:200:249:+;chr1:300:399:+")
    assert ev.num_inc == 5 + 3 + 4
    assert ev.num_exc == 7
    assert ev.num_common == 10 + 8
    evs.filter_events()
    assert len(evs) == 1


def test_load_afe_ale_events(tmp_path):
    from miso_tpu_torch.core.as_events import load_event_counts
    info = tmp_path / "afe_info.txt"
    info.write_text(
        "evA\tchr1:100:199:+,chr1:300:349:+\tchr1:500:599:+\n"
        "evB\tchr2:10:59:-\tchr2:100:149:-,chr2:200:219:-\n")
    counts = tmp_path / "afe_counts.txt"
    counts.write_text("evA\t12;8;3;2\nevB\t1;0;1;0\n")
    evs = load_event_counts(str(counts), "AFE",
                            events_info_filename=str(info))
    ev = evs.get_event("evA")
    assert ev.chrom == "chr1"
    assert ev.num_proximal_body == 12 and ev.num_distal_jxns == 2
    assert sum(e["len"] for e in ev.proximal_exons) == 150
    assert sum(e["len"] for e in ev.distal_exons) == 100
    genes = evs.loaded_events_to_genes()
    g = genes["evA"]
    assert g.num_isoforms == 2
    assert sorted(g.iso_lengths.tolist()) == [100, 150]
    evs.filter_events()   # proximal+distal sum >= 20 keeps only evA
    assert list(evs.events) == ["evA"]


def test_load_event_counts_ri_and_tandem(tmp_path):
    from miso_tpu_torch.core.as_events import load_event_counts
    ri = tmp_path / "ri.txt"
    ri.write_text("chr1:1:100:+;chr1:101:200:+;chr1:201:300:+\t6;9;4;3\n")
    evs = load_event_counts(str(ri), "RI")
    ev = next(iter(evs.events.values()))
    assert (ev.num_inc, ev.num_exc, ev.num_common) == (9, 3, 10)
    tu = tmp_path / "tu.txt"
    tu.write_text("chr3:1:200:+;chr3:201:300:+\t4;11\n")
    evs = load_event_counts(str(tu), "TandemUTR")
    ev = next(iter(evs.events.values()))
    assert (ev.num_ext, ev.num_core) == (4, 11)
