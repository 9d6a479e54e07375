"""Paired-end events through the port, against the JAX package on the CPU.

Paired reads reuse the REASSIGN kernel B1 (or B2) unchanged, but its
inputs differ from single-end ones: class weights are fragment-length
probabilities, not {0, 1}; per-read scores are non-zero; and log_iso_w
holds ``assscores`` = log sum of the admissible fragment placements,
about 11 for these exons.  The plain version must follow the numpy
replica of the Pallas kernel's chain on such tiles, land on the
grid-exact posterior, agree with the JAX XLA sampler, and the whole
``--paired-end`` run must match the JAX CLI's.
"""
import numpy as np
import pytest
import torch

import jax

from exact_posterior import exact_posterior_mean_2iso
from miso_tpu.core.events import pad_events
from miso_tpu.sampler import mcmc as jmcmc
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler.mcmc import SamplerConfig, batch_from_numpy
from miso_tpu_torch.testing import PAIRED_GENE, cap_test_threads, paired_event
from test_pallas_interpret import _sim_event
from test_torch_pipeline import (MEAN_TOL, N_EVENTS, _check_truth,
                                 _header, _means, _miso_files, _run_both,
                                 _summary)

cap_test_threads()

# tests/test_pallas_interpret.py's tolerances: f32 against the f64
# replica of the same chain
PSI_ATOL, LL_ATOL, N_ATOL = 2e-4, 2e-3, 1e-5


def _paired_tiles(seed):
    """E=2 lanes of R=16 per-read tiles cut from a paired event (400
    pairs of 40 nt, fragments 250 +- 15): 13 of its reads, chosen at
    random, then 3 all-zero padding reads."""
    ev = paired_event(*PAIRED_GENE, [0.6, 0.4], 400, 40, 250.0, 15.0,
                      seed=11)
    pad = pad_events([ev, ev], read_dtype=np.float32)
    rng = np.random.default_rng(seed)
    E, R = 2, 16
    rows = np.stack([rng.choice(400, R - 3, replace=False)
                     for _ in range(E)])
    read_w = np.zeros((E, R, 2), np.float32)
    rls = np.zeros((E, R, 2), np.float32)
    for e in range(E):
        read_w[e, :R - 3] = pad["read_w"][e, rows[e]]
        rls[e, :R - 3] = pad["read_logscore"][e, rows[e]]
    return jmcmc.EventBatch(
        weights=pad["weights"], log_read=pad["log_read"],
        counts=pad["counts"], log_iso_w=pad["log_iso_w"],
        hyper=pad["hyper"], num_iso=pad["num_iso"], read_w=read_w,
        read_logscore=rls)


@pytest.mark.parametrize("given", [False, True])
def test_plain_follows_sim_event_on_paired_tiles(given):
    batch = _paired_tiles(seed=3 if given else 0)
    assert np.all(batch.log_iso_w > 10) and np.any(batch.read_logscore < -5)
    assert np.any((batch.read_w > 0) & (batch.read_w < 1))
    E, K = 2, 2
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=K)
    start = None
    if given:
        p0 = np.array([0.85, 0.2], np.float32)
        start = np.repeat(np.stack([p0, 1.0 - p0], -1)[:, None], K, axis=1)
    tb, tstart = batch_from_numpy(batch, "cpu", start)
    got = rk.run_batch_reassign(0, tb, cfg, start_psi=tstart,
                                fixed_uniform=rk.FIXED_U).to_numpy()
    for e in range(E):
        sim_psi, sim_ll, sim_acc, sim_n, sim_fpsi = _sim_event(
            batch.read_w[e].astype(np.float64),
            batch.read_logscore[e].astype(np.float64),
            np.asarray(batch.log_iso_w[e], np.float64),
            np.asarray(batch.hyper[e], np.float64), 2, cfg, 16,
            start_psi=None if start is None else start[e, 0])
        for k in range(K):
            np.testing.assert_allclose(got.psi_samples[e, :, k], sim_psi,
                                       rtol=0, atol=PSI_ATOL)
            np.testing.assert_allclose(got.loglik[e, :, k], sim_ll, rtol=0,
                                       atol=LL_ATOL)
            np.testing.assert_allclose(got.final_n[e, k], sim_n, rtol=0,
                                       atol=N_ATOL)
            np.testing.assert_allclose(got.final_psi[e, k], sim_fpsi,
                                       rtol=0, atol=PSI_ATOL)
        assert got.accepted[e] == sim_acc * K


def test_plain_matches_exact_posterior_paired():
    """tests/test_sampler.py::test_paired_end_recovery with the plain
    version: 1,500 pairs of 30 nt, fragments 200 +- 10; each event's
    posterior mean within 0.02 of the grid-exact one."""
    ev = paired_event(*PAIRED_GENE, [0.65, 0.35], 1500, 30, 200.0, 10.0,
                      seed=11)
    exact = exact_posterior_mean_2iso(ev)
    tb, _ = batch_from_numpy(pad_events([ev] * 2, read_dtype=np.float32),
                             "cpu")
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=5, chains=4)
    res = rk.run_batch_reassign(5, tb, cfg).to_numpy()
    means = res.flat_samples()[:, :, 0].mean(axis=1)
    assert np.all(np.abs(means - exact) < 0.02), (means, exact)


def test_plain_paired_agrees_with_xla():
    """tests/test_pallas.py::test_pallas_paired_agrees_with_xla with the
    plain version against the JAX XLA sampler: means within 0.02 and
    acceptance within 0.05 (the JAX tiles are bf16, the port's f32, so
    the two agree in distribution only)."""
    ev = paired_event(*PAIRED_GENE, [0.6, 0.4], 400, 40, 250.0, 15.0,
                      seed=11)
    pad = pad_events([ev] * 2)
    iters, chains = 1500, 4
    ref = jmcmc.run_batch(jax.random.PRNGKey(5), jmcmc.EventBatch(**pad),
                          jmcmc.SamplerConfig(iters=iters, burn_in=300,
                                              lag=5, chains=chains))
    tb, _ = batch_from_numpy(pad_events([ev] * 2, read_dtype=np.float32),
                             "cpu")
    got = rk.run_batch_reassign(
        4, tb, SamplerConfig(iters=iters, burn_in=300, lag=5,
                             chains=chains)).to_numpy()
    m1 = got.flat_samples()[:, :, 0].mean(axis=1)
    m2 = float(np.asarray(ref.flat_samples())[:, :, 0].mean())
    assert np.all(np.abs(m1 - m2) < 0.02), (m1, m2)
    a1 = float(got.accepted[0]) / (iters * chains)
    a2 = float(ref.accepted[0]) / (iters * chains)
    assert abs(a1 - a2) < 0.05, (a1, a2)
    assert a1 > 0.05, ("chain frozen", a1)


# ------------------------------------------------------------- the CLI
# Longer chains than test_torch_pipeline's FAST_SETTINGS: on this catalog
# two JAX runs of paired MARGINAL at those settings differ by up to 0.054
# in one event's mean (three seeds); at these, any two of three JAX and
# three port runs differ by at most 0.028, inside MEAN_TOL.
PAIRED_SETTINGS = """\
[data]
filter_results = True
min_event_reads = 20

[sampler]
burn_in = 300
lag = 5
num_iters = 1600
num_chains = 4
"""


@pytest.fixture(scope="module")
def paired_catalog(tmp_path_factory):
    from miso_tpu.cli.index_gff import main as index_main
    from miso_tpu.testing import build_paired_catalog_fixture

    root = tmp_path_factory.mktemp("torch_paired")
    fix = build_paired_catalog_fixture(str(root / "fix"),
                                       num_events=N_EVENTS,
                                       pairs_per_event=150, seed=7)
    settings = root / "settings.txt"
    settings.write_text(PAIRED_SETTINGS)
    index_dir = str(root / "index")
    assert index_main(["--index", fix["gff"], index_dir]) == 0
    return root, fix, index_dir, str(settings)


@pytest.mark.parametrize("flags", [
    ["--paired-end", "250", "15"],
    ["--paired-end", "250", "15", "--algorithm", "marginal"]])
def test_paired_cli_matches_jax_cli(paired_catalog, flags):
    """Both CLIs on a 40-gene paired catalog: the same .miso files,
    headers equal apart from chain-dependent fields, posterior means
    within the Monte-Carlo tolerance of each other and of the truth."""
    outs = _run_both(paired_catalog, flags)
    jf, tf = _miso_files(outs["jax"]), _miso_files(outs["torch"])
    assert len(tf) == N_EVENTS and sorted(tf) == sorted(jf)
    for rel in tf:
        assert _header(tf[rel]) == _header(jf[rel]), rel
    assert sorted(_summary(outs["torch"])) == sorted(_summary(outs["jax"]))
    means = {name: _means(out) for name, out in outs.items()}
    assert np.all(np.abs(means["torch"] - means["jax"]) < MEAN_TOL)
    _check_truth(means["torch"], paired_catalog[1])


@pytest.mark.parametrize("cli", ["jax", "torch"])
def test_overhang_is_one_in_paired_mode(paired_catalog, monkeypatch,
                                        capsys, cli):
    """--overhang-len in paired mode warns and runs with overhang 1, and
    the fragment model is MEAN and SD**2, in both CLIs."""
    import miso_tpu.pipeline as jp
    import miso_tpu_torch.pipeline as tp
    from miso_tpu.cli.main import main as jax_main
    from miso_tpu_torch.cli.main import main as torch_main

    root, fix, index_dir, settings = paired_catalog
    seen = {}
    monkeypatch.setattr(jp if cli == "jax" else tp, "compute_all_genes_psi",
                        lambda *a, **kw: seen.update(kw))
    main, dev = ((jax_main, []) if cli == "jax"
                 else (torch_main, ["--device", "cpu"]))
    rc = main(["--run", index_dir, fix["bam"], "--output-dir",
               str(root / ("overhang_" + cli)), "--read-len", "40",
               "--paired-end", "250", "15", "--overhang-len", "5"] + dev)
    assert rc == 0
    cfg = seen["cfg"]
    assert cfg.paired_end and cfg.overhang_len == 1
    assert (cfg.mean_frag_len, cfg.frag_variance) == (250.0, 225.0)
    assert "cannot use --overhang-len in paired-end mode" in \
        capsys.readouterr().out
    if cli == "torch":
        assert seen["device"] == torch.device("cpu")
