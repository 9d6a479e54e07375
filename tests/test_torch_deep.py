"""The port's deep REASSIGN route (miso_tpu_torch/sampler/deep.py and the
multinomial Gibbs step ``model.gibbs_reassign``) against the JAX package
on the CPU: the cases of tests/test_deep_events.py, the multinomial
draws' own invariants, and the pipeline's routing of deep and wide
buckets.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

from exact_posterior import exact_posterior_mean_2iso
from miso_tpu.core.events import pad_events
import miso_tpu_torch.pipeline as tp
from miso_tpu_torch._host import RunConfig
from miso_tpu_torch.parallel import mesh as tmesh
from miso_tpu_torch.sampler import deep
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler.mcmc import SamplerConfig, batch_from_numpy
from miso_tpu_torch.sampler.model import gibbs_reassign
from miso_tpu_torch.testing import (cap_test_threads, class_batch, deepened,
                                    simulated_event, wide_event)

cap_test_threads()


def _deep_event(scale=500, n_base=2000):
    """tests/test_deep_events.py::_deep_event: a 2-isoform event of
    n_base * scale reads (the class counts of n_base simulated reads,
    scaled).  Returns (shallow, deep)."""
    ev = simulated_event([100, 50, 100], [[1, 2, 3], [1, 3]], [0.3, 0.7],
                         n_base, 25, seed=4)
    return ev, deepened(ev, scale)


def test_gibbs_reassign_sums_exactly_and_matches_its_mean():
    """Each class's draws sum exactly to its count; padded isoforms and
    a class with no compatible isoform get 0; over N lanes the mean
    draw is counts * p within 5 binomial standard errors."""
    N, C, I = 4000, 4, 4
    psi = torch.tensor([0.5, 0.3, 0.2, 0.0]).expand(N, I)  # isoform 3 pad
    W = torch.tensor([[1.0, 1.0, 1.0, 0.0],
                      [0.0, 0.4, 0.9, 0.0],
                      [0.0, 0.0, 0.0, 0.0],      # incompatible class
                      [0.2, 0.0, 0.0, 0.0]])
    counts = torch.tensor([1_000_000.0, 37.0, 50.0, 3.0])
    gen = torch.Generator().manual_seed(0)
    draws = gibbs_reassign(psi, W.expand(N, C, I), counts.expand(N, C),
                           generator=gen)
    assert draws.shape == (N, C, I)
    assert torch.equal(draws, draws.round()) and (draws >= 0).all()
    sums = draws.sum(-1)
    assert torch.equal(sums[:, [0, 1, 3]], counts[[0, 1, 3]].expand(N, 3))
    assert (draws[:, 2] == 0).all() and (draws[..., 3] == 0).all()
    p = (psi[0] * W) / (psi[0] * W).sum(-1, keepdim=True).clamp_min(1e-30)
    expect = (counts[:, None] * p).numpy()
    sd = np.sqrt(counts[:, None].numpy() * p.numpy() * (1 - p.numpy()) / N)
    got = draws.double().mean(0).numpy()
    assert np.all(np.abs(got - expect) <= 5 * sd + 1e-9), (got, expect)


def test_deep_event_skips_per_read_tensors(monkeypatch):
    """The pipeline pads a million-read bucket without per-read tiles and
    runs the deep route: expand_read_tensors is never called and no
    REASSIGN kernel or plain version launches."""
    _, ev = _deep_event()
    assert int(ev.counts.sum()) == 1_000_000

    def refuse(*a, **k):
        raise AssertionError("per-read tiles built for a deep bucket")

    seen = {}
    orig = tp.pad_events

    def spy(events, **kw):
        seen.update(kw)
        return orig(events, **kw)

    monkeypatch.setattr(rk, "expand_read_tensors", refuse)
    monkeypatch.setattr(tp, "pad_events", spy)
    before = (dict(deep.LAUNCHES), dict(rk.LAUNCHES))
    cfg = RunConfig(read_len=25, iters=40, burn_in=10, lag=5, chains=2)
    out = tp.run_events([ev], cfg, seed=0, device="cpu")
    assert seen["per_read"] is False and seen["pad_reads"] > tp.DEEP_READS
    assert deep.LAUNCHES["plain"] == before[0]["plain"] + 1
    assert deep.LAUNCHES["cuda"] == before[0]["cuda"]
    assert rk.LAUNCHES == before[1]
    assert out[0]["psi_ticks"].shape == (12, 2)


def test_deep_event_final_counts_sum_to_its_reads():
    """Every chain's final assignment counts sum exactly to 1,000,000,
    and the .miso result (chain 0) does too."""
    _, ev = _deep_event()
    res = deep.run_batch_multinomial(
        1, class_batch([ev], "cpu"),
        SamplerConfig(iters=50, burn_in=10, lag=5, chains=4))
    np.testing.assert_array_equal(res.final_n.sum(-1).numpy(),
                                  np.full((1, 4), 1_000_000.0))
    cfg = RunConfig(read_len=25, iters=50, burn_in=10, lag=5, chains=2)
    out = tp.run_events([ev], cfg, seed=0, device="cpu")
    assert float(np.sum(out[0]["final_n"])) == 1_000_000.0


def test_deep_event_matches_exact_posterior():
    """At 1M reads the posterior concentrates; the multinomial route's
    mean lands within 0.02 of the grid-exact one."""
    _, ev = _deep_event()
    exact = exact_posterior_mean_2iso(ev)
    res = deep.run_batch_multinomial(
        0, class_batch([ev], "cpu"),
        SamplerConfig(iters=800, burn_in=200, lag=4, chains=4))
    mean = float(res.flat_samples()[0, :, 0].mean())
    assert abs(mean - exact) < 0.02, (mean, exact)


def test_multinomial_and_perread_gibbs_agree():
    """On the shallow event, the multinomial route and the per-read plain
    version both land within 0.02 of the exact posterior mean."""
    ev, _ = _deep_event()
    exact = exact_posterior_mean_2iso(ev)
    cfg = SamplerConfig(iters=1500, burn_in=300, lag=4, chains=4)
    per_read, _ = batch_from_numpy(pad_events([ev], read_dtype=np.float32),
                                   "cpu")
    means = {
        "perread": rk.run_batch_reassign(1, per_read, cfg),
        "multinomial": deep.run_batch_multinomial(
            1, class_batch([ev], "cpu"), cfg),
    }
    for name, res in means.items():
        mean = float(res.flat_samples()[0, :, 0].mean())
        assert abs(mean - exact) < 0.02, (name, mean, exact)


def test_deep_bucket_runs_under_convergent_stop():
    _, ev = _deep_event(scale=20)                 # 40,000 reads
    cfg = RunConfig(read_len=25, iters=60, burn_in=20, lag=5, chains=2,
                    stop="convergent", max_iters=400)
    before = deep.LAUNCHES["plain"]
    out = tp.run_events([ev, ev], cfg, seed=0, device="cpu")
    assert deep.LAUNCHES["plain"] > before
    for res in out:
        assert np.isfinite(res["samples"]).all()
        assert float(np.sum(res["final_n"])) == 40_000.0
        assert res["iters"] >= 60


def _wide_deep_event(num_iso=70, n_base=300, scale=60):
    """A gene of ``num_iso`` isoforms (70 of the 128 exon subsets that
    keep the first and last of 9 exons), n_base simulated reads scaled
    to n_base * scale."""
    subsets = [[1] + [2 + b for b in range(7) if m >> b & 1] + [9]
               for m in range(128)][:num_iso]
    psi = np.random.default_rng(2).dirichlet(np.ones(num_iso))
    return deepened(simulated_event([60] * 9, subsets, psi, n_base, 25,
                                    seed=2), scale)


def test_deep_bucket_wider_than_64_isoforms_runs():
    """A deep bucket of 128 padded isoforms runs (the multinomial
    kernel, or here its plain version), with padded isoforms at 0."""
    ev = _wide_deep_event()
    assert tp._bucket_key(ev)[0] == 128 and tp._bucket_key(ev)[2] > \
        tp.DEEP_READS
    cfg = RunConfig(read_len=25, iters=20, burn_in=10, lag=5, chains=2)
    out = tp.run_events([ev], cfg, seed=0, device="cpu")
    assert out[0]["psi_ticks"].shape == (4, 70)
    assert float(np.sum(out[0]["final_n"])) == float(ev.counts.sum())
    res = deep.run_batch_multinomial(
        0, class_batch([ev], "cpu"),
        SamplerConfig(iters=10, burn_in=0, lag=5, chains=2))
    assert (res.psi_samples[..., 70:] == 0).all()
    assert (res.final_n[..., 70:] == 0).all()


def _runner_on_a_pretended_card(monkeypatch, cfg, results):
    """A StreamRunner whose device says CUDA while its tensors stay on
    the CPU (no card here): the routing reads the device, the samplers
    read the tensors."""
    real = tmesh.batch_from_numpy
    monkeypatch.setattr(
        tmesh, "batch_from_numpy",
        lambda batch, device, start=None: real(batch, "cpu", start))
    runner = tp.StreamRunner(
        cfg, device="cpu",
        on_chunk=lambda tags, res: results.extend(res))
    runner.mesh = (torch.device("cuda"),)
    return runner


def _recorded_plain(monkeypatch, mod):
    """Record (I, wide_order) of every call of a module's plain version."""
    name = "_reassign_plain" if mod is rk else "_marginal_plain"
    real = getattr(mod, name)
    calls = []

    def recorded(seed, batch, *args, **kw):
        calls.append((batch.weights.shape[2], kw.get("wide_order")))
        return real(seed, batch, *args, **kw)

    monkeypatch.setattr(mod, name, recorded)
    return calls


@pytest.mark.parametrize("algorithm", ["reassign", "marginal", "classes"])
def test_card_refuses_only_shallow_buckets_above_its_widest_kernel(
        monkeypatch, capsys, algorithm):
    """The card refuses no bucket now: on a CUDA device a bucket of 2,048
    isoforms and one of 512 each go to their kernel's wrapper once, and
    there to its wide route (B1w or B2w on a card; here, the tensors
    being the CPU's, its plain version in the wide kernel's summing
    order), and to nothing else: no narrow instance, no deep route.  The
    widest narrow instance is no wider than the wide kernels' first
    width."""
    from miso_tpu_torch.sampler import marginal_kernel as mk
    from miso_tpu_torch.sampler import wide

    assert max(rk.KERNEL_ISO) <= wide.WIDE_FROM <= 512
    assert max(rk.KERNEL_ISO) <= wide.WIDE_FROM_MARGINAL <= 512
    ev = wide_event(algorithm)
    key = tp._bucket_key(ev)
    assert key[0] == 512 and key[2] <= tp.DEEP_READS
    cfg = RunConfig(read_len=25, iters=20, burn_in=10, lag=5, chains=2,
                    algorithm=algorithm)
    results, went = [], []
    wrapper = ("run_batch_reassign" if algorithm == "reassign"
               else "run_batch_marginal")
    real = getattr(tp, wrapper)

    def counted(seed, batch, *args, **kw):
        went.append(tuple(batch.weights.shape))
        return real(seed, batch, *args, **kw)

    monkeypatch.setattr(tp, wrapper, counted)
    mine, other = ((rk, mk) if algorithm == "reassign" else (mk, rk))
    calls = _recorded_plain(monkeypatch, mine)
    runner = _runner_on_a_pretended_card(monkeypatch, cfg, results)
    before = (dict(deep.LAUNCHES), dict(mine.LAUNCHES), dict(other.LAUNCHES))
    try:
        runner._dispatch((2048, key[1], key[2]), [ev], [0])
        runner.add(ev)
        runner.add(ev)
        runner.finish()
    except BaseException:
        runner.abort()
        raise
    assert "wider than" not in capsys.readouterr().out
    # one launch of the bucket's own wrapper at each width, on the tensors
    # it was given (here the CPU's: its plain version, in the wide order),
    # and no deep route, no other kernel, no narrow instance in its place
    assert [w[1:] for w in went] == [(key[1], 2048), (key[1], 512)]
    assert calls == [(2048, True), (512, True)]
    assert deep.LAUNCHES == before[0]
    assert mine.LAUNCHES == dict(before[1], plain=before[1]["plain"] + 2)
    assert other.LAUNCHES == before[2]
    assert len(results) == 3
    for res in results:
        ticks = res["psi_ticks"]
        assert ticks.shape == (4, 300)
        assert np.all(np.abs(ticks.astype(np.int64).sum(1) - 10000) <= 300)
        assert np.isfinite(res["loglik"]).all()
        if algorithm == "reassign":
            assert float(np.sum(res["final_n"])) == float(ev.counts.sum())


def test_convergent_rounds_of_a_wide_bucket_take_the_wide_route(
        monkeypatch):
    """Convergent rounds go through the same wrapper (``run_sampler``):
    on a pretended card every round of a bucket of 512 isoforms reaches
    the wrapper's wide route (here its plain version in the wide summing
    order) and nothing else."""
    from miso_tpu_torch.sampler import marginal_kernel as mk

    ev = wide_event("reassign")
    cfg = RunConfig(read_len=25, iters=20, burn_in=10, lag=5, chains=2,
                    stop="convergent", max_iters=80)
    calls = _recorded_plain(monkeypatch, rk)
    results = []
    runner = _runner_on_a_pretended_card(monkeypatch, cfg, results)
    before = (dict(deep.LAUNCHES), dict(mk.LAUNCHES), dict(rk.LAUNCHES))
    try:
        runner.add(ev)
        runner.finish()
    except BaseException:
        runner.abort()
        raise
    assert calls and all(c == (512, True) for c in calls)
    assert rk.LAUNCHES == dict(before[2],
                               plain=before[2]["plain"] + len(calls))
    assert (dict(deep.LAUNCHES), dict(mk.LAUNCHES)) == before[:2]
    assert len(results) == 1 and results[0]["samples"].shape[1] == 300


def test_deep_bucket_of_any_width_passes_the_width_check(monkeypatch):
    """A deep REASSIGN bucket wider than every kernel instance is not
    refused on a CUDA device: the multinomial kernel takes any width."""
    ev, _ = _deep_event(n_base=100, scale=1)
    cfg = RunConfig(read_len=25, iters=20, burn_in=10, lag=5, chains=2)
    results = []
    runner = _runner_on_a_pretended_card(monkeypatch, cfg, results)
    before = deep.LAUNCHES["plain"]
    try:
        runner._dispatch((2048, tp._bucket_key(ev)[1], 2 * tp.DEEP_READS),
                         [ev], [0])
        runner.finish()
    except BaseException:
        runner.abort()
        raise
    assert deep.LAUNCHES["plain"] == before + 1 and len(results) == 1


def test_a_kernel_that_fails_is_never_rerouted(monkeypatch, capsys):
    """A bucket goes to its kernel on a CUDA device; when the kernel
    fails to build or launch the run raises: no plain version and no
    other route takes its place."""
    from miso_tpu_torch.sampler import marginal_kernel as mk

    def broken(*args, **kw):
        raise RuntimeError("nvcc failed (1)")

    monkeypatch.setattr(tp, "run_batch_marginal", broken)
    ev = simulated_event([100, 50, 100], [[1, 2, 3], [1, 3]], [0.3, 0.7],
                         100, 25, seed=4, algorithm="marginal")
    cfg = RunConfig(read_len=25, iters=20, burn_in=10, lag=5, chains=2,
                    algorithm="marginal")
    runner = _runner_on_a_pretended_card(monkeypatch, cfg, [])
    before = (dict(mk.LAUNCHES), dict(rk.LAUNCHES), dict(deep.LAUNCHES))
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            runner._dispatch(tp._bucket_key(ev), [ev], [0])
    finally:
        runner.abort()
    assert (dict(mk.LAUNCHES), dict(rk.LAUNCHES),
            dict(deep.LAUNCHES)) == before
    # the same for the wide kernels: a bucket of 2,048 isoforms whose
    # wrapper fails raises, and nothing else runs it
    for algorithm, name in (("reassign", "run_batch_reassign"),
                            ("marginal", "run_batch_marginal")):
        monkeypatch.setattr(tp, name, broken)
        wide_ev = simulated_event([100, 50, 100], [[1, 2, 3], [1, 3]],
                                  [0.3, 0.7], 100, 25, seed=4,
                                  algorithm=algorithm)
        key = tp._bucket_key(wide_ev)
        runner = _runner_on_a_pretended_card(
            monkeypatch, RunConfig(read_len=25, iters=20, burn_in=10, lag=5,
                                   chains=2, algorithm=algorithm), [])
        try:
            with pytest.raises(RuntimeError, match="nvcc failed"):
                runner._dispatch((2048, key[1], key[2]), [wide_ev], [0])
        finally:
            runner.abort()
        assert (dict(mk.LAUNCHES), dict(rk.LAUNCHES),
                dict(deep.LAUNCHES)) == before
    # a B2w plan the card refuses (here a cluster of 4 blocks with their
    # class rows in shared memory) raises through the wrapper after one
    # launch: no other plan, no cluster of 1, no plain version runs it
    from miso_tpu_torch import kernels
    from miso_tpu_torch.sampler import wide
    from miso_tpu_torch.testing import marginal_lane_batch

    calls = []

    class Refusing:
        def miso_marginal_wide(self, *args):
            calls.append(args)
            return 7          # the launch's error, as cudaLaunchKernelEx

        def miso_cuda_error_string(self, rc):
            return b"cluster out of resources"

    monkeypatch.setattr(kernels, "load", Refusing)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    batch = marginal_lane_batch(512, 300, 3, "cpu", C=256)
    plan = mk.wide_plan(3, 256, 512, 2)
    assert (plan.cluster, plan.weights) == (4, "shared")
    before = dict(mk.LAUNCHES)
    with pytest.raises(RuntimeError, match="wide marginal kernel launch.*"
                       "cluster out of resources"):
        mk._marginal_wide_cuda(0, batch, SamplerConfig(
            algorithm="marginal", iters=4, burn_in=0, lag=1, chains=2),
            mk._marginal_consts(batch), None, True)
    assert len(calls) == 1 and dict(mk.LAUNCHES) == before
    # threads, cluster, rows shared, shared bytes: the plan's, as given
    assert calls[0][-5:-1] == (plan.threads, 4, 1, wide.launch_bytes(
        plan, 256, 512))
    # and a CUDA tensor has no route but the kernel, B1 / B2 or their wide
    # forms by width: the wrappers choose by the tensors' device alone
    import inspect
    for wrapper, kernels, plain in (
            (mk.run_batch_marginal, ("_marginal_wide_cuda", "_marginal_cuda"),
             "_marginal_plain"),
            (rk.run_batch_reassign, ("_reassign_wide_cuda", "_reassign_cuda"),
             "_reassign_plain"),
            (deep.run_batch_multinomial, ("_multinomial_cuda",),
             "_multinomial_plain")):
        src = inspect.getsource(wrapper)
        cuda = src.index('dev.type == "cuda"')
        cpu = src.index('dev.type == "cpu"')
        assert cuda < cpu < src.index(plain)
        assert all(cuda < src.index(k) < cpu for k in kernels)


def test_fixed_uniform_gibbs_sums_exactly_and_ends_on_degenerate_p():
    """The fixed-uniform rule floor(n * ratio + u), clipped: every class
    sums exactly to its count (a million reads too), p of 0 and 1 and all
    mass on one isoform end where they must, a class of no compatible
    isoform draws nothing, and the draws are the rule's own."""
    u = rk.FIXED_U
    psi = torch.tensor([[0.5, 0.3, 0.2, 0.0],
                        [1.0, 0.0, 0.0, 0.0],
                        [0.0, 0.0, 1.0, 0.0]])
    W = torch.tensor([[1.0, 1.0, 1.0, 0.0],
                      [0.0, 0.4, 0.9, 0.0],
                      [0.0, 0.0, 0.0, 0.0],      # incompatible class
                      [0.2, 0.0, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 1.0]])     # only a padded isoform
    counts = torch.tensor([1_000_000.0, 37.0, 50.0, 3.0, 9.0])
    draws = gibbs_reassign(psi, W.expand(3, 5, 4), counts.expand(3, 5),
                           uniform=u)
    assert torch.equal(draws, draws.round()) and (draws >= 0).all()
    sums = draws.sum(-1)
    tot = (psi[:, None, :] * W).sum(-1)
    np.testing.assert_array_equal(
        sums.numpy(), torch.where(tot > 0, counts, 0.0).numpy())
    assert (draws[:, 2] == 0).all() and (draws[:, 4] == 0).all()
    # all of psi on isoform 0: class 0 goes there whole, class 1 (no
    # weight on isoform 0) draws nothing; all on isoform 2: p = (0, 0, 1)
    assert draws[1, 0].tolist() == [1_000_000.0, 0.0, 0.0, 0.0]
    assert draws[1, 1].sum() == 0 and draws[1, 3, 0] == 3.0
    assert draws[2, 0].tolist() == [0.0, 0.0, 1_000_000.0, 0.0]
    assert draws[2, 1].tolist() == [0.0, 0.0, 37.0, 0.0]
    # the first isoform's draw is the mean rounded by u
    ratio = (0.5 * 1.0) / (0.5 + 0.3 + 0.2)
    assert draws[0, 0, 0] == np.floor(np.float32(1e6 * ratio) + u)


def _on_card(t):
    """A CPU tensor whose device says CUDA: the wrappers route by it."""
    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    return t.as_subclass(OnCard)


def test_a_deep_bucket_on_a_card_goes_to_the_multinomial_kernel(
        monkeypatch):
    """On a CUDA device a deep REASSIGN bucket goes through the pipeline
    to ``_multinomial_cuda``, once, and to no plain version: here the
    batch's weights say CUDA and the stand-in launches the plain version
    on the CPU tensors, counted apart."""
    _, ev = _deep_event(scale=10)               # 20,000 reads
    went = []

    def kernel(seed, batch, cfg, consts, start_psi, fixed, plan=None):
        went.append((type(batch.weights).__name__, tuple(
            batch.weights.shape), start_psi is not None, fixed))
        plain = batch._replace(weights=batch.weights.as_subclass(
            torch.Tensor))
        return deep._multinomial_plain(seed, plain, cfg, consts, start_psi)

    monkeypatch.setattr(deep, "_multinomial_cuda", kernel)
    real = tmesh.batch_from_numpy

    def on_card(batch, device, start=None):
        b, sp = real(batch, "cpu", start)
        return b._replace(weights=_on_card(b.weights)), sp

    monkeypatch.setattr(tmesh, "batch_from_numpy", on_card)
    cfg = RunConfig(read_len=25, iters=20, burn_in=10, lag=5, chains=2)
    results = []
    runner = tp.StreamRunner(cfg, device="cpu",
                             on_chunk=lambda tags, res: results.extend(res))
    runner.mesh = (torch.device("cuda"),)
    before = dict(deep.LAUNCHES)
    try:
        runner.add(ev)
        runner.finish()
    except BaseException:
        runner.abort()
        raise
    key = tp._bucket_key(ev)
    assert key[2] > tp.DEEP_READS
    assert went == [("OnCard", (1, key[1], 2), False, False)]
    # the stand-in's plain launch is the only one; the wrapper made none
    assert deep.LAUNCHES["plain"] == before["plain"] + 1
    assert len(results) == 1
    assert float(np.sum(results[0]["final_n"])) == float(ev.counts.sum())


def test_run_batch_multinomial_routes_by_the_tensors_device(monkeypatch):
    """The wrapper sends a CUDA batch to the kernel with the fixed mode
    and GIVEN start it was given, and a CPU batch to the plain version."""
    ev, _ = _deep_event(n_base=100, scale=1)
    batch = class_batch([ev], "cpu")
    cfg = SamplerConfig(iters=4, burn_in=0, lag=1, chains=2)
    seen = []
    monkeypatch.setattr(deep, "_multinomial_cuda", lambda *a, **k:
                        seen.append(a[4:6]) or "kernel")
    start = torch.full((1, 2, 2), 0.5)
    card = batch._replace(weights=_on_card(batch.weights))
    assert deep.run_batch_multinomial(0, card, cfg, start_psi=start,
                                      fixed_uniform=rk.FIXED_U) == "kernel"
    assert seen[0][0] is start and seen[0][1] is True
    before = deep.LAUNCHES["plain"]
    res = deep.run_batch_multinomial(0, batch, cfg)
    assert deep.LAUNCHES["plain"] == before + 1 and len(seen) == 1
    assert res.psi_samples.shape == (1, 4, 2, 2)
    with pytest.raises(ValueError, match="fixed_uniform"):
        deep.run_batch_multinomial(0, batch, cfg, fixed_uniform=0.3)
