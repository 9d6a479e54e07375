"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs an NVIDIA GPU and skips without one.  The card's
machine has no JAX, so this file imports none, and runs there without
tests/conftest.py (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from miso_tpu_torch.sampler import deep
from miso_tpu_torch.sampler import marginal_kernel as mk
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler import wide
from miso_tpu_torch.sampler.mcmc import SamplerConfig
from miso_tpu_torch.testing import (PAIRED_GENE, WIDE_CLASS_SLOTS,
                                    cap_test_threads, lane_test_batch,
                                    marginal_lane_batch,
                                    multinomial_lane_batch, padded_batch,
                                    paired_event, wide_class_batch)

cap_test_threads()

pytestmark = pytest.mark.cuda

# f32 chains that follow the same path differ only by rounding (the
# tolerances of tests/test_pallas_interpret.py)
PSI_ATOL, LL_ATOL, N_ATOL = 2e-4, 2e-3, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_same_chain(got, ref):
    got, ref = got.to_numpy(), ref.to_numpy()
    np.testing.assert_allclose(got.psi_samples, ref.psi_samples, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_allclose(got.loglik, ref.loglik, rtol=0, atol=LL_ATOL)
    np.testing.assert_allclose(got.final_n, ref.final_n, rtol=0,
                               atol=N_ATOL)
    np.testing.assert_allclose(got.final_psi, ref.final_psi, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_array_equal(got.accepted, ref.accepted)


# (I, num_iso): every width the narrow kernel is built for, and the wide
# kernel's from wide.WIDE_FROM on, some with padded isoforms
WIDTHS = [(2, 2), (3, 3), (4, 3), (6, 5), (8, 8), (16, 9), (32, 17),
          (64, 33), (128, 70), (256, 130), (512, 300), (1024, 600),
          (2048, 1100)]


def _route(I, wide_from=wide.WIDE_FROM):
    """The LAUNCHES key of the kernel a bucket of I isoforms runs
    (MARGINAL: ``wide_from=wide.WIDE_FROM_MARGINAL``)."""
    return "wide" if I >= wide_from else "cuda"


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("I,num_iso", WIDTHS)
def test_kernel_matches_plain_fixed_uniform(cuda, I, num_iso, given):
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2)
    batch = lane_test_batch(I, num_iso, I, cuda)
    start = None
    if given:
        sp = np.zeros((2, 2, I), np.float32)
        sp[..., :num_iso] = np.random.default_rng(9).dirichlet(
            np.ones(num_iso), size=(2, 2))
        start = torch.from_numpy(sp).to(cuda)
    ref = rk._reassign_plain(0, batch, cfg, rk._event_consts(batch), start,
                             rk.FIXED_U)
    launches = dict(rk.LAUNCHES)
    got = rk.run_batch_reassign(0, batch, cfg, start_psi=start,
                                fixed_uniform=rk.FIXED_U)
    torch.cuda.synchronize()
    launches[_route(I)] += 1
    assert rk.LAUNCHES == launches
    _assert_same_chain(got, ref)


# every lane width and home of the weights the kernel can be laid out in
# at R = 16 (lane_test_batch), by isoform width: plain Python, the same
# list on every machine
LAYOUTS = [(I, num_iso, plan.T, plan.home)
           for I, num_iso in ((2, 2), (3, 3), (8, 5), (64, 33))
           for plan in rk.all_plans(2, 16, I, 2)]


def _plan(E, R, I, K, T, home):
    return next(p for p in rk.all_plans(E, R, I, K)
                if (p.T, p.home) == (T, home))


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("I,num_iso,T,home", LAYOUTS)
def test_kernel_matches_plain_in_every_layout(cuda, I, num_iso, T, home,
                                              given):
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2)
    batch = lane_test_batch(I, num_iso, I, cuda)
    consts = rk._event_consts(batch)
    start = None
    if given:
        sp = np.zeros((2, 2, I), np.float32)
        sp[..., :num_iso] = np.random.default_rng(9).dirichlet(
            np.ones(num_iso), size=(2, 2))
        start = torch.from_numpy(sp).to(cuda)
    ref = rk._reassign_plain(0, batch, cfg, consts, start, rk.FIXED_U)
    got = rk._reassign_cuda(0, batch, cfg, consts, start, True,
                            plan=_plan(2, 16, I, 2, T, home))
    torch.cuda.synchronize()
    _assert_same_chain(got, ref)


def test_layouts_cover_every_lane_width_and_home():
    for width in (2, 3, 8, 64):
        assert {(T, home) for I, _, T, home in LAYOUTS if I == width} == {
            (T, home) for T in rk.LANE_THREADS for home in rk.HOMES}


def test_philox_chain_is_the_same_in_every_layout(cuda):
    """One seed, one chain: psi, final_n and acceptance bit-equal for
    every lane width and home; only the read score's summing order, and
    with it the recorded log-likelihood's last bits, may differ."""
    ev = paired_event(*PAIRED_GENE, [0.6, 0.4], 400, 40, 250.0, 15.0,
                      seed=11)
    batch = padded_batch([ev] * 5, cuda)       # 5 events: a ragged grid
    E, R, I = batch.read_w.shape
    cfg = SamplerConfig(iters=300, burn_in=50, lag=5, chains=3)
    consts = rk._event_consts(batch)
    plans = rk.all_plans(E, R, I, cfg.chains)
    assert {p.T for p in plans} == set(rk.LANE_THREADS)
    assert {p.home for p in plans} == set(rk.HOMES)
    first = None
    for plan in plans:
        got = rk._reassign_cuda(17, batch, cfg, consts, None, False,
                                plan=plan).to_numpy()
        if first is None:
            first = got
            continue
        np.testing.assert_array_equal(got.psi_samples, first.psi_samples)
        np.testing.assert_array_equal(got.final_n, first.final_n)
        np.testing.assert_array_equal(got.accepted, first.accepted)
        np.testing.assert_allclose(got.loglik, first.loglik, rtol=0,
                                   atol=LL_ATOL)
    assert 0.05 < first.accepted.sum() / (E * cfg.iters * cfg.chains) < 0.95


def test_reads_are_padded_to_a_multiple_of_four(cuda):
    """R = 14: the wrapper adds two zero-weight reads, which count into
    no isoform."""
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2)
    batch = lane_test_batch(3, 3, 1, cuda)
    batch = batch._replace(read_w=batch.read_w[:, :14].contiguous(),
                           read_logscore=batch.read_logscore[:, :14]
                           .contiguous())
    ref = rk._reassign_plain(0, batch, cfg, rk._event_consts(batch), None,
                             rk.FIXED_U)
    got = rk.run_batch_reassign(0, batch, cfg, fixed_uniform=rk.FIXED_U)
    torch.cuda.synchronize()
    _assert_same_chain(got, ref)


def test_kernel_rejects_bad_input(cuda):
    cfg = SamplerConfig(iters=4, burn_in=0, lag=1, chains=2)
    batch = lane_test_batch(2, 2, 0, cuda)
    with pytest.raises(ValueError, match="read_w"):
        rk.run_batch_reassign(0, batch._replace(
            read_w=batch.read_w.double()), cfg)
    with pytest.raises(ValueError, match="start_psi"):
        rk.run_batch_reassign(0, batch, cfg, start_psi=torch.zeros(
            (2, 3, 2), device=cuda))
    # a plan the kernel cannot be laid out in: the launcher refuses it
    plan = rk.launch_plan(2, 16, 2, 2)._replace(lanes_per_block=3,
                                                threads=12)
    with pytest.raises(RuntimeError, match="reassign kernel launch"):
        rk._reassign_cuda(0, batch, cfg, rk._event_consts(batch), None,
                          True, plan=plan)


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("I,num_iso", WIDTHS + [(64, 60), (64, 64)])
def test_marginal_kernel_matches_plain_fixed_uniform(cuda, I, num_iso,
                                                     given):
    """B2, and B2w from wide.WIDE_FROM_MARGINAL isoforms on, at every
    width, with padded isoforms, an empty class and a padding event."""
    route = _route(I, wide.WIDE_FROM_MARGINAL)
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2,
                        algorithm="marginal")
    batch = marginal_lane_batch(I, num_iso, I, cuda)
    start = None
    if given:
        sp = np.zeros((3, 2, I), np.float32)
        sp[:2, :, :num_iso] = np.random.default_rng(9).dirichlet(
            np.ones(num_iso), size=(2, 2))
        start = torch.from_numpy(sp).to(cuda)
    ref = mk._marginal_plain(0, batch, cfg, mk._marginal_consts(batch),
                             start, mk.FIXED_U, wide_order=route == "wide")
    launches = dict(mk.LAUNCHES)
    got = mk.run_batch_marginal(0, batch, cfg, start_psi=start,
                                fixed_uniform=mk.FIXED_U)
    torch.cuda.synchronize()
    launches[route] += 1
    assert mk.LAUNCHES == launches
    _assert_same_chain(got, ref)


# every lane width by isoform width and class count (C = 4: a class a
# thread at T = 4; 5: no lane width divides it; 40: above the widest
# lane): plain Python, the same list on every machine
M_LAYOUTS = [(I, num_iso, C, plan.T)
             for I, num_iso in ((2, 2), (3, 3), (8, 5), (64, 33))
             for C in (4, 5, 40)
             for plan in mk.all_marginal_plans(3, C, I, 2)]


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("I,num_iso,C,T", M_LAYOUTS)
def test_marginal_kernel_matches_plain_in_every_plan(cuda, I, num_iso, C, T,
                                                     given):
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2,
                        algorithm="marginal")
    batch = marginal_lane_batch(I, num_iso, I, cuda, C=C)
    consts = mk._marginal_consts(batch)
    start = None
    if given:
        sp = np.zeros((3, 2, I), np.float32)
        sp[:2, :, :num_iso] = np.random.default_rng(9).dirichlet(
            np.ones(num_iso), size=(2, 2))
        start = torch.from_numpy(sp).to(cuda)
    plan = next(p for p in mk.all_marginal_plans(3, C, I, 2) if p.T == T)
    ref = mk._marginal_plain(0, batch, cfg, consts, start, mk.FIXED_U)
    got = mk._marginal_cuda(0, batch, cfg, consts, start, True, plan=plan)
    torch.cuda.synchronize()
    _assert_same_chain(got, ref)


def test_marginal_philox_chain_is_the_same_in_every_plan(cuda):
    """One seed, one chain: psi, loglik and acceptance bit-equal for
    every lane width (the score is summed in class order in all)."""
    batch = marginal_lane_batch(3, 3, 5, cuda, C=40)
    E, C, I = batch.weights.shape
    cfg = SamplerConfig(iters=300, burn_in=50, lag=5, chains=3,
                        algorithm="classes")
    consts = mk._marginal_consts(batch)
    first = None
    for plan in mk.all_marginal_plans(E, C, I, cfg.chains):
        got = mk._marginal_cuda(17, batch, cfg, consts, None, False,
                                plan=plan).to_numpy()
        if first is None:
            first = got
            continue
        np.testing.assert_array_equal(got.psi_samples, first.psi_samples)
        np.testing.assert_array_equal(got.loglik, first.loglik)
        np.testing.assert_array_equal(got.final_psi, first.final_psi)
        np.testing.assert_array_equal(got.accepted, first.accepted)
    real = first.accepted[:2] / (cfg.iters * cfg.chains)
    assert np.all((0.02 < real) & (real < 0.98))
    other = mk._marginal_cuda(18, batch, cfg, consts, None, False).to_numpy()
    assert not np.array_equal(other.psi_samples, first.psi_samples)


def test_marginal_kernel_rejects_bad_input(cuda):
    cfg = SamplerConfig(iters=4, burn_in=0, lag=1, chains=2,
                        algorithm="classes")
    batch = marginal_lane_batch(2, 2, 0, cuda)
    with pytest.raises(ValueError, match="weights"):
        mk.run_batch_marginal(0, batch._replace(
            weights=batch.weights.double()), cfg)
    with pytest.raises(ValueError, match="num_iso"):
        mk.run_batch_marginal(0, batch._replace(
            num_iso=batch.num_iso.long()), cfg)
    with pytest.raises(ValueError, match="start_psi"):
        mk.run_batch_marginal(0, batch, cfg, start_psi=torch.zeros(
            (3, 3, 2), device=cuda))
    with pytest.raises(ValueError, match="takes I in"):
        mk.run_batch_marginal(0, marginal_lane_batch(5, 5, 0, cuda), cfg)
    # a plan the kernel cannot be laid out in: the launcher refuses it
    plan = mk.marginal_plan(3, 4, 2, 2)._replace(T=8, lanes_per_block=3)
    with pytest.raises(RuntimeError, match="marginal kernel launch"):
        mk._marginal_cuda(0, batch, cfg, mk._marginal_consts(batch), None,
                          True, plan=plan)


@pytest.mark.parametrize("algorithm", ["reassign", "marginal"])
@pytest.mark.parametrize("iters", [24, 5000])
def test_kernels_match_plain_on_paired_events(cuda, algorithm, iters):
    """Paired-end tiles (tests/test_pallas.py:230-235): fragment-
    probability weights, log_iso_w = assscores near 11 and non-zero read
    scores, on a small schedule and on the stock 5000 x 6 one."""
    ev = paired_event(*PAIRED_GENE, [0.6, 0.4], 400, 40, 250.0, 15.0,
                      seed=11)
    batch = padded_batch([ev] * 2, cuda)
    cfg = (SamplerConfig(iters=24, burn_in=6, lag=3, chains=2,
                         algorithm=algorithm) if iters == 24
           else SamplerConfig(algorithm=algorithm))
    if algorithm == "reassign":
        ref = rk._reassign_plain(0, batch, cfg, rk._event_consts(batch),
                                 None, rk.FIXED_U)
        got = rk.run_batch_reassign(0, batch, cfg, fixed_uniform=rk.FIXED_U)
    else:
        ref = mk._marginal_plain(0, batch, cfg, mk._marginal_consts(batch),
                                 None, mk.FIXED_U)
        got = mk.run_batch_marginal(0, batch, cfg, fixed_uniform=mk.FIXED_U)
    torch.cuda.synchronize()
    _assert_same_chain(got, ref)


@pytest.mark.parametrize("algorithm", ["reassign", "marginal"])
def test_shards_on_two_streams_of_one_card_are_their_slices_alone(
        cuda, algorithm):
    """Both kernels over a mesh that names the card twice (one stream per
    entry): every shard bit-equal to its slice launched alone with its
    shard's chunk seed, and the shards together, under fixed uniforms,
    equal to one launch of the whole batch."""
    from miso_tpu_torch.parallel import mesh as tmesh
    from miso_tpu_torch.pipeline import chunk_seed

    def kernel(seed, b, cfg, start_psi=None, fixed_uniform=None):
        run = (rk.run_batch_reassign if cfg.algorithm == "reassign"
               else mk.run_batch_marginal)
        return run(seed, b, cfg, start_psi=start_psi,
                   fixed_uniform=fixed_uniform)

    cfg = SamplerConfig(iters=200, burn_in=50, lag=5, chains=4,
                        algorithm=algorithm)
    batch = (lane_test_batch(3, 3, 5, cuda, E=37, R=32)
             if algorithm == "reassign"
             else marginal_lane_batch(3, 3, 5, cuda))
    host = type(batch)(*(t.cpu().numpy() for t in batch))
    mesh = tmesh.make_event_mesh(["cuda:0", "cuda:0"])
    seeds = [chunk_seed(9, 0, 4, 8, 32, shard=k) for k in range(2)]
    res = tmesh.run_batch_sharded(seeds, host, cfg, mesh, kernel)
    parts = tmesh.shard_batch(host, mesh)
    for k, shard in enumerate(res.shards):
        alone = kernel(seeds[k], parts[k], cfg)
        for a, b in zip(shard.to_numpy(), alone.to_numpy()):
            np.testing.assert_array_equal(a, b)
    E = batch.weights.shape[0]
    fixed = tmesh.run_batch_sharded([0, 0], host, cfg, mesh, kernel,
                                    fixed_uniform=rk.FIXED_U).to_numpy()
    whole = kernel(0, batch, cfg, fixed_uniform=rk.FIXED_U).to_numpy()
    np.testing.assert_array_equal(fixed.psi_samples[:E], whole.psi_samples)
    np.testing.assert_array_equal(fixed.accepted[:E], whole.accepted)
    np.testing.assert_allclose(fixed.loglik[:E], whole.loglik, rtol=0,
                               atol=LL_ATOL)


# the wide kernels B1w and B2w in every block width of their plans, and
# with the lane arrays in scratch (shared_bytes 0), at 128 and 2,048
# isoforms
WIDE_PLANS = [(kind, I, num_iso, threads, arrays)
              for kind in wide.KINDS
              for I, num_iso in ((128, 70), (2048, 1100))
              for threads in wide.WIDE_THREADS
              for arrays in ("shared", "scratch")]


def _wide_case(kind, I, num_iso, device):
    """(batch, consts, plans, launcher, plain) of a wide kernel's check."""
    if kind == "reassign":
        batch = lane_test_batch(I, num_iso, I, device)
        return (batch, rk._event_consts(batch), rk.all_wide_plans(2, 16, I, 2),
                rk._reassign_wide_cuda, rk._reassign_plain)
    batch = marginal_lane_batch(I, num_iso, I, device, C=5)
    return (batch, mk._marginal_consts(batch),
            mk.all_wide_plans(3, 5, I, 2), mk._marginal_wide_cuda,
            mk._marginal_plain)


@pytest.mark.parametrize("kind,I,num_iso,threads,arrays", WIDE_PLANS)
def test_wide_kernel_matches_plain_in_every_plan(cuda, kind, I, num_iso,
                                                 threads, arrays):
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2,
                        algorithm=kind)
    batch, consts, plans, launch, plain = _wide_case(kind, I, num_iso, cuda)
    plan = next(p for p in plans if p.threads == threads)
    if arrays == "scratch":
        plan = plan._replace(shared_bytes=0)
    E = batch.weights.shape[0]
    sp = np.zeros((E, 2, I), np.float32)
    sp[:2, :, :num_iso] = np.random.default_rng(9).dirichlet(
        np.ones(num_iso), size=(2, 2))
    for start in (None, torch.from_numpy(sp).to(cuda)):
        ref = plain(0, batch, cfg, consts, start, rk.FIXED_U)
        got = launch(0, batch, cfg, consts, start, True, plan=plan)
        torch.cuda.synchronize()
        _assert_same_chain(got, ref)


# B2w in every cluster size and home of its class rows (C = 5 classes,
# some blocks of a cluster without rows), every block width, its lane
# arrays in shared memory and in scratch, at 128, 512 and 2,048 isoforms
B2W_CLUSTERS = [(I, num_iso, cluster, home)
                for I, num_iso in ((128, 70), (512, 300), (2048, 1100))
                for cluster in wide.CLUSTERS for home in wide.WEIGHT_HOMES]


@pytest.mark.parametrize("I,num_iso,cluster,home", B2W_CLUSTERS)
def test_marginal_wide_kernel_in_every_cluster_and_home(cuda, I, num_iso,
                                                        cluster, home):
    """Every plan of ``cluster`` blocks a lane with its rows in ``home``
    draws the chain of a block a lane with its rows in device memory, to
    the bit, and is the wide-order plain version within the tolerances,
    from AUTO and GIVEN starts."""
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2,
                        algorithm="marginal")
    batch, consts, plans, launch, plain = _wide_case("marginal", I,
                                                     num_iso, cuda)
    first = plans[0]
    assert (first.cluster, first.weights) == (1, "device")
    plans = [p for p in plans if (p.cluster, p.weights) == (cluster, home)]
    plans += [p._replace(shared_bytes=0) for p in plans if p.shared_bytes]
    E = batch.weights.shape[0]
    sp = np.zeros((E, 2, I), np.float32)
    sp[:2, :, :num_iso] = np.random.default_rng(9).dirichlet(
        np.ones(num_iso), size=(2, 2))
    for start in (None, torch.from_numpy(sp).to(cuda)):
        ref = plain(0, batch, cfg, consts, start, rk.FIXED_U,
                    wide_order=True)
        want = launch(0, batch, cfg, consts, start, True,
                      plan=first).to_numpy()
        for plan in plans:
            got = launch(0, batch, cfg, consts, start, True, plan=plan)
            torch.cuda.synchronize()
            for name, a, b in zip(want._fields, got.to_numpy(), want):
                np.testing.assert_array_equal(a, b, err_msg="%s %s" % (
                    name, plan))
            _assert_same_chain(got, ref)


@pytest.mark.parametrize("I,num_iso", [(64, 40), (128, 70), (384, 250),
                                       (512, 300), (2048, 1100)])
def test_wide_kernel_reads_classes(cuda, I, num_iso):
    """B1w on class tensors (``testing.wide_class_batch``, as run_sampler
    hands a wide bucket over) is the wide-order plain version on their
    expanded read tiles, to the bit, in every block width, in scratch
    and in tiles of its class table, from AUTO and GIVEN starts."""
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2)
    batch = wide_class_batch(I, num_iso, I, cuda)
    E, C, _ = batch.weights.shape
    R = WIDE_CLASS_SLOTS
    rw, rls = rk.expand_read_tensors(batch.weights, batch.log_read,
                                     batch.counts, R)
    tiles = batch._replace(read_w=rw, read_logscore=rls)
    consts = rk._event_consts(batch)
    plans = rk.all_wide_plans(E, R, I, 2, classes=C)
    plans += [p._replace(shared_bytes=0) for p in plans if p.shared_bytes]
    plans += [wide.tiled(plans[0], R, I, 2), wide.tiled(plans[2], R, I, 1)]
    sp = np.zeros((E, 2, I), np.float32)
    sp[..., :num_iso] = np.random.default_rng(9).dirichlet(
        np.ones(num_iso), size=(E, 2))
    for start in (None, torch.from_numpy(sp).to(cuda)):
        ref = rk._reassign_plain(0, tiles, cfg, consts, start, rk.FIXED_U,
                                 wide_order=True).to_numpy()
        for plan in plans:
            got = rk._reassign_wide_cuda(0, batch, cfg, consts, start, True,
                                         plan=plan, pad_reads=R).to_numpy()
            for name, a, b in zip(got._fields, got, ref):
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind", wide.KINDS)
def test_wide_philox_chain_is_the_same_in_every_plan(cuda, kind):
    """One seed, one chain: every output bit-equal in every block width
    (B2w: every cluster size and home of its class rows) and in scratch
    (every sum runs in one order whatever the block)."""
    cfg = SamplerConfig(iters=300, burn_in=50, lag=5, chains=3,
                        algorithm=kind)
    batch, consts, plans, launch, _ = _wide_case(kind, 128, 70, cuda)
    first = None
    for plan in plans + [p._replace(shared_bytes=0) for p in plans]:
        got = launch(17, batch, cfg, consts, None, False,
                     plan=plan).to_numpy()
        if first is None:
            first = got
            continue
        for a, b in zip(got, first):
            np.testing.assert_array_equal(a, b)
    other = launch(18, batch, cfg, consts, None, False).to_numpy()
    assert not np.array_equal(other.psi_samples, first.psi_samples)


# the multinomial kernel B3 at narrow and wide widths (2 to 128
# isoforms), every lane width
B3_WIDTHS = [(2, 2, 4), (3, 3, 5), (8, 5, 6), (16, 9, 6), (128, 70, 4)]


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("I,num_iso,C", B3_WIDTHS)
def test_multinomial_kernel_matches_plain_in_every_plan(cuda, I, num_iso, C,
                                                        given):
    cfg = SamplerConfig(iters=24, burn_in=6, lag=3, chains=2)
    batch = multinomial_lane_batch(I, num_iso, I, cuda, C=C, scale=300.0)
    consts = deep._event_consts(batch)
    start = None
    if given:
        sp = np.zeros((3, 2, I), np.float32)
        sp[:2, :, :num_iso] = np.random.default_rng(9).dirichlet(
            np.ones(num_iso), size=(2, 2))
        start = torch.from_numpy(sp).to(cuda)
    ref = deep._multinomial_plain(0, batch, cfg, consts, start, deep.FIXED_U)
    for plan in deep.all_multinomial_plans(3, C, I, 2):
        got = deep._multinomial_cuda(0, batch, cfg, consts, start, True,
                                     plan=plan)
        torch.cuda.synchronize()
        got, want = got.to_numpy(), ref.to_numpy()
        real = slice(0, 2)     # the padding event's loglik is not finite
        np.testing.assert_allclose(got.psi_samples, want.psi_samples,
                                   rtol=0, atol=PSI_ATOL)
        np.testing.assert_allclose(got.loglik[real], want.loglik[real],
                                   rtol=0, atol=LL_ATOL)
        np.testing.assert_allclose(got.final_n, want.final_n, rtol=0,
                                   atol=N_ATOL)
        np.testing.assert_array_equal(got.accepted, want.accepted)
