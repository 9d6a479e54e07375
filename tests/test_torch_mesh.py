"""The port's event mesh (miso_tpu_torch/parallel/mesh.py and the
pipeline over it) against the JAX package's (miso_tpu/parallel/mesh.py).

Here every mesh entry is the CPU, so each shard runs its kernel's plain
version; the kernels themselves are held sharded on the card by
``chip_smoke.py mesh``.  In fixed-uniform mode the port's sharded run
must follow the JAX package's sharded Pallas kernels (interpret mode,
``_DEBUG_NO_PRNG``, over the 8-device CPU mesh of tests/conftest.py) to
the tolerances of tests/test_torch_reassign.py; with random draws every
shard must be bitwise its slice run alone with its own seed.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax

import miso_tpu.sampler.pallas_kernel as pk
from miso_tpu.core import events as jev
from miso_tpu.core.gene import make_gene as jmake_gene
from miso_tpu.core.simulate import simulate_reads as jsimulate
from miso_tpu.parallel import mesh as jmesh
from miso_tpu.pipeline import RunConfig as JRunConfig
from miso_tpu.pipeline import resolve_mesh as jresolve_mesh
from miso_tpu.pipeline import run_events as jrun_events
from miso_tpu.sampler import mcmc as jmcmc
import miso_tpu_torch.pipeline as tp
from miso_tpu_torch._host import RunConfig
from miso_tpu_torch.core import events as tev
from miso_tpu_torch.core.gene import make_gene as tmake_gene
from miso_tpu_torch.core.simulate import simulate_reads as tsimulate
from miso_tpu_torch.parallel import mesh as tmesh
from miso_tpu_torch.sampler import marginal_kernel as mk
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler.mcmc import (SamplerConfig, SamplerResult,
                                         batch_from_numpy)
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()

# f32 chains that follow the same path differ only by rounding
# (tests/test_torch_reassign.py::_assert_same_chain)
PSI_ATOL, LL_ATOL, N_ATOL = 2e-4, 2e-3, 1e-5
CPU8 = ("cpu",) * 8
CFG = dict(iters=60, burn_in=20, lag=4, chains=2)
G2 = ([100, 50, 100], [[1, 2, 3], [1, 3]])
G3 = ([100, 50, 80, 100], [[1, 2, 3, 4], [1, 3, 4], [1, 4]])


def _events(mod_gene, mod_sim, mod_ev, n, seed=11, algorithm="reassign",
            both_genes=False):
    """n seeded single-end events compiled by one package: the events of
    tests/test_shard_map_pallas.py, or with ``both_genes`` those of
    tests/test_multichip.py (two- and three-isoform genes in turn)."""
    rng = np.random.default_rng(seed)
    out = []
    for e in range(n):
        gdef = G3 if both_genes and e % 2 else G2
        g = mod_gene(list(gdef[0]), [list(i) for i in gdef[1]])
        psi = rng.dirichlet(np.ones(g.num_isoforms))
        reads = (120 + 10 * (e % 3)) if both_genes else 60 + (e % 3) * 10
        _, pos, cig = mod_sim(g, psi, reads, 25, rng)
        out.append(mod_ev.compile_single_end(g, pos, cig, read_len=25,
                                             name="ev%d" % e,
                                             algorithm=algorithm))
    return out


def _batch(n, algorithm="reassign"):
    """A numpy EventBatch of the JAX package's pad_events, f32 reads."""
    evs = _events(jmake_gene, jsimulate, jev, n, algorithm=algorithm)
    pad = jev.pad_events(evs, pad_iso=2, pad_classes=4, pad_reads=128,
                         read_dtype=np.float32)
    return jmcmc.EventBatch(**{k: np.asarray(v) for k, v in pad.items()})


def _kernel(seed, b, cfg, start_psi=None, fixed_uniform=None):
    """The kernel of ``cfg.algorithm`` on a batch with per-read tiles (B1
    or B2; on the CPU their plain versions), in fixed-uniform mode where
    asked."""
    run = (rk.run_batch_reassign if cfg.algorithm == "reassign"
           else mk.run_batch_marginal)
    return run(seed, b, cfg, start_psi=start_psi,
               fixed_uniform=fixed_uniform)


def _assert_same_chain(a, b):
    np.testing.assert_allclose(a.psi_samples, b.psi_samples, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_allclose(a.loglik, b.loglik, rtol=0, atol=LL_ATOL)
    np.testing.assert_allclose(a.final_n, b.final_n, rtol=0, atol=N_ATOL)
    np.testing.assert_array_equal(a.accepted, b.accepted)


def _assert_bitwise(a, b):
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("n_events", [16, 11])
def test_pad_and_shard_equal_the_jax_functions(n_events):
    batch = _batch(n_events)
    for a in batch:
        np.testing.assert_array_equal(tmesh.pad_to_devices(a, 8),
                                      jmesh.pad_to_devices(a, 8))
    jm = jmesh.make_event_mesh()
    want = jmesh.shard_batch(batch, jm)
    got = tmesh.shard_batch(batch, tmesh.make_event_mesh(CPU8))
    assert len(got) == 8
    for name, field in zip(want._fields, want):
        by_device = {s.device: np.asarray(s.data)
                     for s in field.addressable_shards}
        for k, dev in enumerate(jm.devices.flat):
            t = getattr(got[k], name)
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(
                t.numpy(), by_device[dev].astype(t.numpy().dtype),
                err_msg=name)


def _jax_sharded(batch, cfg, start=None):
    res = jmesh.run_batch_sharded(jax.random.PRNGKey(5), batch, cfg,
                                  mesh=jmesh.make_event_mesh(),
                                  backend="pallas", start_psi=start,
                                  interpret=True)
    return jmcmc.SamplerResult(*(np.asarray(x) for x in res))


@pytest.mark.parametrize("case", ["reassign16", "reassign11", "marginal",
                                  "given"])
def test_fixed_uniform_shards_follow_the_jax_sharded_kernels(monkeypatch,
                                                             case):
    """tests/test_shard_map_pallas.py's three cases on the port: the
    plain versions over eight CPU entries under fixed uniforms against
    the Pallas kernels under shard_map over eight devices."""
    monkeypatch.setattr(pk, "_DEBUG_NO_PRNG", True)
    algorithm = "marginal" if case == "marginal" else "reassign"
    n = {"reassign16": 16, "reassign11": 11, "marginal": 16,
         "given": 8}[case]
    batch = _batch(n, algorithm)
    start = None
    if case == "given":
        start = np.random.default_rng(3).dirichlet(
            np.ones(2), size=(n, CFG["chains"])).astype(np.float32)
    ref = _jax_sharded(batch, jmcmc.SamplerConfig(algorithm=algorithm,
                                                  **CFG), start)
    got = tmesh.run_batch_sharded(
        [0] * 8, batch, SamplerConfig(algorithm=algorithm, **CFG),
        tmesh.make_event_mesh(CPU8), _kernel, start_psi=start,
        fixed_uniform=rk.FIXED_U).to_numpy()
    # each shard pads to 2 events: 16 rows either way
    assert got.psi_samples.shape == ref.psi_samples.shape
    ref = jmcmc.SamplerResult(*(x[:n] for x in ref))
    got = jmcmc.SamplerResult(*(x[:n] for x in got))
    if algorithm == "marginal":   # final_n: zeros in the port
        ref = ref._replace(final_n=got.final_n)
    _assert_same_chain(got, ref)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_every_shard_is_its_slice_run_alone_with_its_seed(n_shards):
    """Philox stand-in (the plain version's generator): shard k of a run
    of the pipeline's sampler over n entries, seeded as the pipeline
    seeds it with ``chunk_seed(..., shard=k)``, is bitwise its slice of
    the padded batch run alone with that seed; one entry has no shard
    axis and is bitwise the sampler's run on the whole batch."""
    batch = _batch(11)
    cfg = SamplerConfig(**CFG)
    sampler = functools.partial(tp.run_sampler, pad_reads=128)
    mesh = tmesh.make_event_mesh(("cpu",) * n_shards)
    seeds = [tp.chunk_seed(5, 0, 2, 4, 128,
                           shard=k if n_shards > 1 else None)
             for k in range(n_shards)]
    assert len(set(seeds)) == n_shards
    res = tmesh.run_batch_sharded(seeds, batch, cfg, mesh, sampler)
    assert len(res.shards) == n_shards
    padded = [tmesh.pad_to_devices(a, n_shards) for a in batch]
    step = padded[0].shape[0] // n_shards
    for k, shard in enumerate(res.shards):
        alone, _ = batch_from_numpy(
            jmcmc.EventBatch(*(a[k * step:(k + 1) * step] for a in padded)),
            "cpu")
        _assert_bitwise(shard.to_numpy(),
                        sampler(seeds[k], alone, cfg, None).to_numpy())
    if n_shards == 1:
        whole, _ = batch_from_numpy(batch, "cpu")
        _assert_bitwise(res.to_numpy(), sampler(
            tp.chunk_seed(5, 0, 2, 4, 128), whole, cfg, None).to_numpy())
    with pytest.raises(ValueError, match="seeds for a mesh"):
        tmesh.run_batch_sharded(seeds[:1] * (n_shards + 1), batch, cfg,
                                mesh, sampler)


def test_a_failing_shard_raises_and_nothing_takes_its_place():
    batch = _batch(8)
    ran = []

    def sampler(seed, b, cfg, start_psi=None):
        ran.append(seed)
        if len(ran) == 2:
            raise RuntimeError("reassign kernel launch: CUDA error 700")
        return _kernel(seed, b, cfg, start_psi)

    before = dict(rk.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tmesh.run_batch_sharded([1, 2, 3, 4], batch, SamplerConfig(**CFG),
                                tmesh.make_event_mesh(("cpu",) * 4),
                                sampler)
    assert len(ran) == 2 and rk.LAUNCHES["plain"] == before["plain"] + 1


def _both_event_sets(n, algorithm):
    kw = dict(seed=3, algorithm=algorithm, both_genes=True)
    return (_events(jmake_gene, jsimulate, jev, n, **kw),
            _events(tmake_gene, tsimulate, tev, n, **kw))


@pytest.mark.parametrize("mode", ["linear", "convergent", "marginal"])
def test_run_events_over_the_mesh_agrees_with_the_jax_package(mode):
    """``run_events`` over eight CPU entries against the port's own
    unsharded run, and with the linear start against the JAX package's
    over its 8-device mesh, on tests/test_multichip.py's events.  The
    chains are independent (600 samples each; posterior SDs 0.04-0.11),
    so the tolerance is statistical: every event's posterior means within
    0.1 of the reference's, and within 0.04 on average over the events.
    The JAX package runs once, as each mode there costs a compile per
    bucket: MARGINAL and the GIVEN start that the convergent
    continuations take are held to its sharded kernels tightly by
    test_fixed_uniform_shards_follow_the_jax_sharded_kernels.  The
    convergent stop is capped at its first round here;
    test_convergent_rounds_split_over_the_mesh runs its continuations."""
    algorithm = "marginal" if mode == "marginal" else "reassign"
    kw = dict(read_len=25, iters=200, burn_in=50, lag=2, chains=8,
              algorithm=algorithm)
    if mode == "linear":
        kw["start"] = "linear"
    if mode == "convergent":
        kw.update(stop="convergent", max_iters=200)
    jevs, tevs = _both_event_sets(12, algorithm)
    got = tp.run_events(tevs, RunConfig(**kw), seed=7, device=CPU8)
    refs = [tp.run_events(tevs, RunConfig(**kw), seed=7, device="cpu")]
    if mode == "linear":
        refs.append(jrun_events(jevs, JRunConfig(**kw), seed=7,
                                mesh=jresolve_mesh("auto")))
    for ref in refs:
        diffs = []
        for r, g, ev in zip(ref, got, tevs):
            m_r, m_g = (x["samples"].mean(axis=0) for x in (r, g))
            assert m_g.shape == m_r.shape == (ev.num_iso,)
            diffs.append(np.abs(m_g - m_r).max())
        assert max(diffs) < 0.1 and np.mean(diffs) < 0.04, diffs


def test_convergent_rounds_split_over_the_mesh():
    """The convergent stop over a mesh: continuation rounds (GIVEN start
    from each event's final psi) split their unconverged events over the
    entries.  One entry is bitwise the unsharded run; three give every
    event its samples on the schedule it stopped at."""
    _, tevs = _both_event_sets(6, "reassign")
    cfg = RunConfig(read_len=25, iters=120, burn_in=40, lag=2, chains=2,
                    stop="convergent", max_iters=280)   # one continuation
    alone = tp.run_events(tevs, cfg, seed=3, device="cpu")
    one = tp.run_events(tevs, cfg, seed=3, device=["cpu"])
    three = tp.run_events(tevs, cfg, seed=3, device=("cpu",) * 3)
    assert any(r["iters"] > cfg.iters for r in alone)
    assert any(r["iters"] > cfg.iters for r in three)
    for a, b in zip(alone, one):
        np.testing.assert_array_equal(a["samples"], b["samples"])
        np.testing.assert_array_equal(a["loglik"], b["loglik"])
        assert (a["iters"], a["percent_accept"]) == (b["iters"],
                                                     b["percent_accept"])
    for c, ev in zip(three, tevs):
        S = c["samples"].shape[0]
        assert c["samples"].shape == (S, ev.num_iso) and S >= 80
        assert np.all(np.isfinite(c["loglik"])) and len(c["loglik"]) == S
        np.testing.assert_allclose(c["samples"].sum(-1), 1.0, atol=1e-3)
        assert S == (c["iters"] - c["burn_in"]) // cfg.lag * cfg.chains


def test_one_entry_mesh_writes_what_the_unsharded_run_writes():
    """``device=["cpu"]`` is a mesh of one entry: no shard axis, so every
    result is bitwise the unsharded run's; two entries draw other
    chains."""
    _, tevs = _both_event_sets(5, "reassign")
    cfg = RunConfig(read_len=25, iters=120, burn_in=20, lag=2, chains=2)
    alone = tp.run_events(tevs, cfg, seed=2, device="cpu")
    one = tp.run_events(tevs, cfg, seed=2, device=["cpu"])
    two = tp.run_events(tevs, cfg, seed=2, device=["cpu", "cpu"])
    for a, b in zip(alone, one):
        np.testing.assert_array_equal(a["psi_ticks"], b["psi_ticks"])
        np.testing.assert_array_equal(a["score_cents"], b["score_cents"])
        np.testing.assert_array_equal(a["final_n"], b["final_n"])
        assert a["summary"][0].tolist() == b["summary"][0].tolist()
    assert any(not np.array_equal(a["psi_ticks"], c["psi_ticks"])
               for a, c in zip(alone, two))


def _pretend_cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("device,cards,want", [
    ("cuda", 2, ("cuda:0", "cuda:1")),
    (torch.device("cuda"), 4, ("cuda:0", "cuda:1", "cuda:2", "cuda:3")),
    ("cuda", 1, None),
    ("cuda:1", 2, None),
    ("cpu", 2, None),
    ("cpu", 0, None),
    (["cuda:0", "cuda:0"], 1, ("cuda:0", "cuda:0")),
    (("cpu",), 0, ("cpu",)),
    (["cpu", "cpu", "cpu"], 0, ("cpu", "cpu", "cpu")),
])
def test_resolve_mesh(monkeypatch, device, cards, want):
    _pretend_cards(monkeypatch, cards)
    got = tp.resolve_mesh(device)
    assert (None if got is None else tuple(str(d) for d in got)) == want


@pytest.mark.parametrize("device", ["cuda", "cuda:0", ["cpu", "cuda:0"],
                                    ("cuda",)])
def test_a_cuda_entry_without_a_card_raises(monkeypatch, device):
    _pretend_cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.resolve_mesh(device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.StreamRunner(RunConfig(read_len=25), device=device)
    if device == "cuda":
        with pytest.raises(RuntimeError, match="sees none"):
            tmesh.make_event_mesh()


def test_posterior_summary_equals_the_jax_one():
    rng = np.random.default_rng(4)
    psi = rng.dirichlet(np.ones(3), size=(5, 7, 2)).astype(np.float32)
    j = jmcmc.SamplerResult(psi_samples=jax.numpy.asarray(psi),
                            loglik=None, accepted=None, rejected=None,
                            final_n=None, final_psi=None)
    t = SamplerResult(psi_samples=torch.from_numpy(psi), loglik=None,
                         accepted=None, rejected=None, final_n=None,
                         final_psi=None)
    for got, want in zip(tmesh.posterior_summary(t),
                         jmesh.posterior_summary(j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_a_catalog_run_over_the_mesh(tmp_path, capsys):
    """``compute_all_genes_psi`` over two CPU entries writes every event
    and says it is sharded; over one entry it writes the bytes the
    unsharded run writes."""
    from miso_tpu_torch.io.settings import Settings
    from miso_tpu_torch.testing import indexed_catalog

    fix = indexed_catalog(str(tmp_path / "cat"), num_events=6,
                          reads_per_event=150, read_len=36, seed=8)
    settings = tmp_path / "fast.txt"
    settings.write_text("[sampler]\nburn_in = 20\nlag = 2\n"
                        "num_iters = 120\nnum_chains = 2\n")
    outs = {}
    for name, device in (("alone", "cpu"), ("one", ["cpu"]),
                         ("two", ["cpu", "cpu"])):
        out = str(tmp_path / name)
        capsys.readouterr()
        assert tp.compute_all_genes_psi(
            fix["index"], fix["bam"], 36, out,
            settings=Settings.load(str(settings)), device=device) == 6
        text = capsys.readouterr().out
        assert ("Event catalog sharded over 2 local devices" in text) == (
            name == "two")
        assert "on %s (" % ("cpu,cpu" if name == "two" else "cpu") in text
        assert "events/s/chip)" in text
        outs[name] = {os.path.relpath(os.path.join(d, f), out):
                      open(os.path.join(d, f), "rb").read()
                      for d, _, files in os.walk(out) for f in files
                      if f.endswith(".miso")}
        assert len(outs[name]) == 6
    assert outs["one"] == outs["alone"]
    assert outs["two"].keys() == outs["alone"].keys()
    assert outs["two"] != outs["alone"]


def test_a_mesh_with_a_cuda_entry_refuses_buckets_wider_than_its_kernels(
        monkeypatch):
    """A mesh with a card among its entries refuses no bucket now: a
    bucket of 2,048 isoforms is split over the entries, and each shard
    goes to the wrapper once, there to its wide route (on a card B1w;
    here the entry only says CUDA and the tensors stay on the CPU: the
    plain version in the wide kernel's summing order), each shard on its
    own seed."""
    from miso_tpu_torch.sampler import reassign_kernel as rk
    from miso_tpu_torch.testing import wide_event

    ev = wide_event("reassign")
    key = tp._bucket_key(ev)
    real = tmesh.batch_from_numpy
    monkeypatch.setattr(
        tmesh, "batch_from_numpy",
        lambda batch, device, start=None: real(batch, "cpu", start))
    calls, seeds = [], []
    real_plain = rk._reassign_plain

    def recorded(seed, batch, *args, **kw):
        calls.append((batch.weights.shape, kw.get("wide_order")))
        seeds.append(seed)
        return real_plain(seed, batch, *args, **kw)

    monkeypatch.setattr(rk, "_reassign_plain", recorded)
    results = []
    runner = tp.StreamRunner(RunConfig(read_len=25, iters=20, burn_in=10,
                                       lag=5, chains=2),
                             device=["cpu", "cpu"],
                             on_chunk=lambda tags, res: results.extend(res))
    runner.mesh = (torch.device("cpu"), torch.device("cuda"))
    launches = dict(rk.LAUNCHES)
    try:
        runner._dispatch((2048, key[1], key[2]), [ev, ev], [0, 1])
        runner.finish()
    except BaseException:
        runner.abort()
        raise
    assert [(tuple(shape), order) for shape, order in calls] == [
        ((1, key[1], 2048), True)] * 2
    assert seeds == [tp.chunk_seed(0, 0, 2048, key[1], key[2], shard=k)
                     for k in range(2)]
    assert rk.LAUNCHES == dict(launches, plain=launches["plain"] + 2)
    assert len(results) == 2
    for res in results:
        assert res["psi_ticks"].shape == (4, 300)
        assert float(np.sum(res["final_n"])) == float(ev.counts.sum())
