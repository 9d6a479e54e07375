"""Where the MARGINAL and CLASSES means stand against the simulation
truth, in both packages, on the CPU.

On the fixture catalogs the collapsed algorithms' posterior means sit
about 0.04-0.05 above the simulated psi while REASSIGN's do not.  Both
CLIs run one ``build_catalog_fixture`` catalog here (100 events of 300
reads, short chains): the JAX package shows the same offset as the port,
so it is the collapsed model's as the JAX package wrote it down, not a
fault of the port's kernel, start or final-assignment pass.

Where it comes from: the collapsed score is sum_c counts_c * log(sum_i
W_ci psi_i) with W_ci = match_ci / efflen_i (core/events.py, after
miso.c:807-815), which is the likelihood of a read under the FRAGMENT
fraction psi_f_i ~ psi_i * efflen_i, so the chain's "psi" is psi_f.
REASSIGN converts (its assignment prior carries the effective lengths).
For these genes (effective lengths 215 and 165 at 36-nt reads) psi_f
exceeds psi by 0.048 on average over psi ~ U(0.05, 0.95): against psi_f
the collapsed means are unbiased, which the last assertion holds.
"""
import numpy as np
import pytest
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()

N = 100
READS = 300
READ_LEN = 36
FAST_SETTINGS = ("[sampler]\nburn_in = 100\nlag = 5\nnum_iters = 600\n"
                 "num_chains = 2\n")
# standard error of a catalog's mean offset at this size: ~0.005
# (sd of one event's posterior-mean error ~0.05, 100 events)
SE = 0.005


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    from miso_tpu_torch.cli.index_gff import main as index_main
    from miso_tpu_torch.testing import build_catalog_fixture

    root = tmp_path_factory.mktemp("torch_bias")
    fix = build_catalog_fixture(str(root / "fix"), num_events=N,
                                reads_per_event=READS, read_len=READ_LEN,
                                seed=11)
    idx = str(root / "index")
    assert index_main(["--index", fix["gff"], idx]) == 0
    settings = root / "fast.txt"
    settings.write_text(FAST_SETTINGS)
    return root, fix, idx, str(settings)


def _offsets(catalog, algorithm):
    """{package: posterior means - truth} of one algorithm through both
    CLIs."""
    from miso_tpu.cli.main import main as jax_main
    from miso_tpu_torch.cli.main import main as torch_main
    from miso_tpu_torch.io.miso_file import MISOSamples

    root, fix, idx, settings = catalog
    out = {}
    for name, fn, dev in (("jax", jax_main, []),
                          ("torch", torch_main, ["--device", "cpu"])):
        tree = str(root / ("%s_%s" % (name, algorithm)))
        assert fn(["--run", idx, fix["bam"], "--output-dir", tree,
                   "--read-len", str(READ_LEN), "--settings-filename",
                   settings, "--algorithm", algorithm] + dev) == 0
        obj = MISOSamples(tree)
        means = np.array([
            obj.get_event_samples("ev%d" % e).samples[:, 0].mean()
            for e in range(N)])
        out[name] = means - fix["true_psi"]
        print("%s %s: bias %+.4f against psi, %+.4f against psi_f" % (
            algorithm, name, out[name].mean(),
            (means - _fragment_fraction(fix["true_psi"])).mean()))
    return out


def _fragment_fraction(psi, read_len=READ_LEN, lens=(250, 200)):
    """psi_f of the inclusion isoform: psi weighted by the isoforms'
    effective lengths (positions a read can start at)."""
    eff = [length - read_len + 1 for length in lens]
    return psi * eff[0] / (psi * eff[0] + (1 - psi) * eff[1])


def test_reassign_is_unbiased_in_both_packages(catalog):
    """The control: |bias| < 0.02 (four standard errors)."""
    for name, off in _offsets(catalog, "reassign").items():
        assert abs(off.mean()) < 0.02, (name, off.mean())


@pytest.mark.parametrize("algorithm", ["marginal", "classes"])
def test_collapsed_bias_is_inherited_from_the_jax_package(catalog,
                                                          algorithm):
    off = _offsets(catalog, algorithm)
    # both packages sit well above the truth (five standard errors) ...
    for name in ("jax", "torch"):
        assert off[name].mean() > 5 * SE, (name, off[name].mean())
    # ... by the same amount: the two runs read the same reads, so their
    # offsets differ by chain noise alone (0.2 of a standard error seen)
    assert abs(off["torch"].mean() - off["jax"].mean()) < 0.01
    # and it is the gap between psi and the fragment fraction psi_f
    truth = catalog[1]["true_psi"]
    gap = _fragment_fraction(truth) - truth
    assert 0.04 < gap.mean() < 0.055
    for name in ("jax", "torch"):
        assert abs((off[name] - gap).mean()) < 0.02, name
