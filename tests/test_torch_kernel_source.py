"""The CUDA kernel sources, run on the CPU.

There is no ``nvcc`` and no card where these tests run, so a wrong index
or a wrong shuffle in ``miso_tpu_torch/csrc/*.cu`` would show only on the
card.  Here each source is compiled by the host's C++20 compiler against
``miso_tpu_torch/csrc/host_shim/cuda_runtime.h`` (a block's threads as
fibers, warp shuffles and votes through a barrier), loaded in the
kernels' place, and the port's own wrappers launch it on CPU tensors: the
REASSIGN and MARGINAL kernels in every layout of their launch plans,
against their plain versions under fixed uniforms with the card's
tolerances, and one Philox chain whatever the layout; their wide forms
B1w and B2w (``wide_kernel.cu``) likewise in every block width and with
their lane arrays in scratch, at 128 and 2,048 isoforms, B1w also on
class tensors (fewer classes than reads, empty and zero-weight classes,
padding reads, a table of many tiles) to the bit (``-k wide``);
the multinomial kernel B3 of the deep route likewise in every plan, its
binomial draws' moments and chi2, and its step-breakdown build.
What ``nvcc`` makes of the source, and every time, stay the card's to
show.
"""
import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

import miso_tpu_torch
from miso_tpu_torch import kernels
from miso_tpu_torch.sampler import deep
from miso_tpu_torch.sampler import marginal_kernel as mk
from miso_tpu_torch.sampler import reassign_kernel as rk
from miso_tpu_torch.sampler import wide
from miso_tpu_torch.sampler.mcmc import SamplerConfig
from miso_tpu_torch.testing import (BINOMIAL_REGIMES, PAIRED_GENE,
                                    binomial_batch, binomial_chi2,
                                    binomial_moments, cap_test_threads,
                                    class_batch, deepened, lane_test_batch,
                                    marginal_lane_batch,
                                    multinomial_lane_batch, padded_batch,
                                    paired_event, simulated_event)

cap_test_threads()

SHIM = os.path.join(kernels.CSRC, "host_shim")
# the tolerances of tests/test_torch_cuda.py
PSI_ATOL, LL_ATOL, N_ATOL = 2e-4, 2e-3, 1e-5
SMALL = dict(iters=24, burn_in=6, lag=3, chains=2)


def host_source(text):
    """A kernel source as the shim takes it: launches as calls, dynamic
    shared memory as a pointer."""
    def launch(m):
        grid, block, shared = [a.strip() for a in m.group(2).split(",")][:3]
        return "shim_launch(%s, %s, %s, %s, %s);" % (
            m.group(1), grid, block, shared, m.group(3))

    text, launches = re.subn(
        r"(\w+(?:<[^<>;]*>)?)<<<([^;]*?)>>>\(([^;]*?)\);", launch, text)
    assert launches >= 1
    return re.sub(r"extern __shared__ [^;]*?(\w+)\[\];",
                  r"float* \1 = shim_dynamic_shared();", text)


def host_build(work, names, defines=()):
    """csrc/``names`` built for the CPU against the shim into one
    library under ``work``; skips where no C++20 compiler is."""
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    probe = work / "probe.cpp"
    probe.write_text("#include <barrier>\nstd::barrier<> b(1);\n")
    flags = ["-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off", "-I", SHIM] + ["-D" + d for d in defines]
    if subprocess.run([cxx] + flags + [str(probe), "-o",
                                       str(work / "probe.so")],
                      capture_output=True).returncode != 0:
        pytest.skip("needs a C++20 compiler with <barrier>")
    sources = []
    for name in names:
        with open(os.path.join(kernels.CSRC, name)) as f:
            out = work / (name[:-3] + ".cpp")
            out.write_text(host_source(f.read()))
            sources.append(str(out))
    lib_path = str(work / "libmiso_kernels_host.so")
    built = subprocess.run([cxx] + flags + sources + ["-o", lib_path],
                           capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    return ctypes.CDLL(lib_path)


@pytest.fixture(scope="module")
def shim_library(tmp_path_factory):
    return kernels.bind(host_build(
        tmp_path_factory.mktemp("kernel_source"),
        sorted(n for n in os.listdir(kernels.CSRC) if n.endswith(".cu"))))


@pytest.fixture(scope="module")
def clocks_library(shim_library, tmp_path_factory):
    """B3's step-breakdown build (-DMISO_B3_CLOCKS) for the CPU."""
    return kernels.bind_b3_clocks(host_build(
        tmp_path_factory.mktemp("b3_clocks"), ["multinomial_kernel.cu"],
        ["MISO_B3_CLOCKS"]), shim_library)


@pytest.fixture(scope="module")
def b2w_clocks_library(shim_library, tmp_path_factory):
    """B2w's step-breakdown build (-DMISO_B2W_CLOCKS) for the CPU."""
    return kernels.bind_b2w_clocks(host_build(
        tmp_path_factory.mktemp("b2w_clocks"), ["wide_kernel.cu"],
        ["MISO_B2W_CLOCKS"]), shim_library)


@pytest.fixture
def on_cpu(shim_library, monkeypatch):
    """The wrappers' CUDA routes, launching the host build on CPU
    tensors."""
    monkeypatch.setattr(kernels, "load", lambda: shim_library)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return shim_library


# A cluster's blocks through the shim: each thread stores into the next
# block's shared memory (map_shared_rank), the cluster barrier (sync, and
# its two halves, arrive and wait), then reads what the block before
# stored, round after round.
CLUSTER_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void ring(int* out, int rounds, int halves) {
  extern __shared__ __align__(16) float box[];
  cg::cluster_group cl = cg::this_cluster();
  const unsigned r = cl.block_rank(), n = cl.num_blocks();
  for (int k = 0; k < rounds; ++k) {
    cl.map_shared_rank(box, (r + 1) % n)[threadIdx.x] =
        (float)(1000 * k + 100 * (int)r + (int)threadIdx.x);
    if (halves) {
      shim_cluster_arrive();
      shim_cluster_wait();
    } else {
      cl.sync();
    }
    out[(blockIdx.x * rounds + k) * blockDim.x + threadIdx.x] =
        (int)box[threadIdx.x] + 10000 * (int)n;
    cl.sync();
  }
}

extern "C" int run_ring(int* out, int blocks, int threads, int cluster,
                        int rounds, int halves) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1u, 1u);
  cfg.blockDim = dim3((unsigned)threads, 1u, 1u);
  cfg.dynamicSmemBytes = (size_t)threads * 4;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster == 0) {  // no cluster dimension: clusters of one block
    ring<<<blocks, threads, threads * 4>>>(out, rounds, halves);
    return (int)cudaGetLastError();
  }
  return (int)cudaLaunchKernelEx(&cfg, ring, out, rounds, halves);
}
"""


@pytest.mark.parametrize("cluster,halves", [(0, 0), (1, 0), (2, 0), (4, 0),
                                            (4, 1), (8, 1)])
def test_shim_runs_a_cluster_s_blocks_together(tmp_path, cluster, halves):
    """The shim's clusters, which B2w's checks here rest on: a block
    reads what the block before it in its cluster stored into its shared
    memory before the cluster barrier, every round (a launch without a
    cluster dimension: clusters of one block); a grid that clusters do
    not tile is refused."""
    src = tmp_path / "ring.cu"
    src.write_text(CLUSTER_PROBE)
    lib = host_build(tmp_path, [str(src)])
    lib.run_ring.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    blocks, threads, rounds = 2 * max(cluster, 1), 64, 3
    out = np.zeros((blocks, rounds, threads), np.int32)
    assert lib.run_ring(out.ctypes.data, blocks, threads, cluster, rounds,
                        halves) == 0
    b = np.arange(blocks)[:, None, None]
    k = np.arange(rounds)[None, :, None]
    t = np.arange(threads)[None, None, :]
    n = max(cluster, 1)
    before = (b % n - 1) % n
    np.testing.assert_array_equal(out, 10000 * n + 1000 * k + 100 * before
                                  + t)
    if cluster > 1:
        assert lib.run_ring(out.ctypes.data, blocks + 1, threads, cluster,
                            rounds, halves) != 0


@pytest.mark.parametrize("entry,source", [
    ("miso_reassign", "reassign_kernel.cu"),
    ("miso_marginal", "marginal_kernel.cu"),
    ("miso_multinomial", "multinomial_kernel.cu"),
    ("miso_reassign_wide", "wide_kernel.cu"),
    ("miso_marginal_wide", "wide_kernel.cu")])
def test_binding_declares_every_argument(shim_library, entry, source):
    """ctypes passes an argument it has no type for as a 32-bit int: one
    declared type too few and the stream pointer, the last argument, is
    cut."""
    with open(os.path.join(kernels.CSRC, source)) as f:
        params = re.search(r'extern "C" int %s\((.*?)\)\s*{' % entry,
                           f.read(), re.S).group(1)
    declared = getattr(shim_library, entry).argtypes
    assert len(declared) == params.count(",") + 1
    assert declared[-1] is ctypes.c_void_p      # the stream
    pointers = sum("*" in p for p in params.split(","))
    assert list(declared).count(ctypes.c_void_p) == pointers


def _assert_same_chain(got, ref):
    got, ref = got.to_numpy(), ref.to_numpy()
    np.testing.assert_allclose(got.psi_samples, ref.psi_samples, rtol=0,
                               atol=PSI_ATOL)
    # (a padding event's log-likelihood is NaN on both routes alike)
    np.testing.assert_allclose(got.loglik, ref.loglik, rtol=0, atol=LL_ATOL)
    np.testing.assert_allclose(got.final_n, ref.final_n, rtol=0,
                               atol=N_ATOL)
    np.testing.assert_allclose(got.final_psi, ref.final_psi, rtol=0,
                               atol=PSI_ATOL)
    np.testing.assert_array_equal(got.accepted, ref.accepted)


def _start(num_iso, E, K, I):
    sp = np.zeros((E, K, I), np.float32)
    sp[..., :num_iso] = np.random.default_rng(9).dirichlet(
        np.ones(num_iso), size=(E, K))
    return torch.from_numpy(sp)


# every lane width and home of the weights at R = 16, by isoform width:
# the vector loads (I <= 8) and the scalar ones (the narrowest lane only
# at 64 isoforms: a wider one shuffles 63 counts through the shim's
# barriers every step)
LAYOUTS = [(I, num_iso, plan.T, plan.home)
           for I, num_iso in ((2, 2), (3, 3), (8, 5), (16, 9), (64, 33))
           for plan in rk.all_plans(2, 16, I, 2)
           if I <= 16 or plan.T == 4]


@pytest.mark.parametrize("I,num_iso,T,home", LAYOUTS)
def test_reassign_source_matches_plain_in_every_layout(on_cpu, I, num_iso,
                                                       T, home):
    cfg = SamplerConfig(**SMALL)
    batch = lane_test_batch(I, num_iso, I, "cpu")
    consts = rk._event_consts(batch)
    plan = next(p for p in rk.all_plans(2, 16, I, 2)
                if (p.T, p.home) == (T, home))
    for start in (None, _start(num_iso, 2, 2, I)):
        ref = rk._reassign_plain(0, batch, cfg, consts, start, rk.FIXED_U)
        got = rk._reassign_cuda(0, batch, cfg, consts, start, True,
                                plan=plan)
        _assert_same_chain(got, ref)


def test_reassign_source_through_the_wrapper(on_cpu):
    """The public entry point on a tensor that claims no device: here
    only ``_reassign_cuda`` is rerouted, so call it as the wrapper does,
    with the plan the wrapper would choose, on reads that need padding
    to a multiple of four."""
    cfg = SamplerConfig(**SMALL)
    batch = lane_test_batch(3, 3, 1, "cpu")
    batch = batch._replace(read_w=batch.read_w[:, :14].contiguous(),
                           read_logscore=batch.read_logscore[:, :14]
                           .contiguous())
    consts = rk._event_consts(batch)
    launches = rk.LAUNCHES["cuda"]
    ref = rk._reassign_plain(0, batch, cfg, consts, None, rk.FIXED_U)
    got = rk._reassign_cuda(0, batch, cfg, consts, None, True)
    assert rk.LAUNCHES["cuda"] == launches + 1
    _assert_same_chain(got, ref)


def test_reassign_source_draws_one_philox_chain_in_every_layout(on_cpu):
    ev = paired_event(*PAIRED_GENE, [0.6, 0.4], 150, 40, 250.0, 15.0,
                      seed=11)
    batch = padded_batch([ev] * 3, "cpu")      # 3 events: a ragged grid
    E, R, I = batch.read_w.shape
    cfg = SamplerConfig(iters=60, burn_in=10, lag=5, chains=3)
    consts = rk._event_consts(batch)
    plans = rk.all_plans(E, R, I, cfg.chains)
    assert {(p.T, p.home) for p in plans} == {
        (T, h) for T in rk.LANE_THREADS for h in rk.HOMES}
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
    # a chain that moves, and counts every compatible read once
    assert 0 < first.accepted.sum() < E * cfg.iters * cfg.chains
    valid = (batch.read_w.sum(-1) > 0).sum(-1).numpy()
    np.testing.assert_array_equal(first.final_n.sum(-1),
                                  np.repeat(valid[:, None], 3, axis=1))
    # another seed, another chain
    other = rk._reassign_cuda(18, batch, cfg, consts, None, False,
                              plan=plans[0]).to_numpy()
    assert not np.array_equal(other.psi_samples, first.psi_samples)


def test_launcher_refuses_a_plan_it_cannot_lay_out(on_cpu):
    cfg = SamplerConfig(**SMALL)
    batch = lane_test_batch(2, 2, 0, "cpu")
    consts = rk._event_consts(batch)
    good = rk.launch_plan(2, 16, 2, 2)
    for bad in (good._replace(lanes_per_block=3, threads=12),
                good._replace(T=5),
                good._replace(home="shared", shared_bytes=good.shared_bytes
                              + 4)):
        with pytest.raises(RuntimeError, match="reassign kernel launch"):
            rk._reassign_cuda(0, batch, cfg, consts, None, True, plan=bad)


# (from wide.WIDE_FROM_MARGINAL isoforms on the wide kernel B2w, as the
# wrapper chooses, beside the plain version in B2w's order; 512 isoforms
# from the AUTO start alone: a GIVEN Dirichlet
# start puts the scores near 1,370, where the host's logf and torch's
# differ by more than the tolerance; on the card the two agree to the
# bit)
@pytest.mark.parametrize("I,num_iso,given", [
    (I, num_iso, given)
    for I, num_iso in ((2, 2), (3, 3), (8, 5), (64, 33), (128, 70),
                       (512, 300))
    for given in (False, True) if I < 512 or not given])
def test_marginal_source_matches_plain(on_cpu, I, num_iso, given):
    """B2 (B2w from wide.WIDE_FROM_MARGINAL isoforms on) with padded
    isoforms, an empty class and a padding event, in the plan the wrapper
    chooses."""
    cfg = SamplerConfig(algorithm="marginal", **SMALL)
    batch = marginal_lane_batch(I, num_iso, I, "cpu")
    consts = mk._marginal_consts(batch)
    start = None
    if given:
        start = torch.cat([_start(num_iso, 2, 2, I),
                           torch.zeros((1, 2, I))])
    route = "wide" if I >= wide.WIDE_FROM_MARGINAL else "cuda"
    ref = mk._marginal_plain(0, batch, cfg, consts, start, mk.FIXED_U,
                             wide_order=route == "wide")
    launches = dict(mk.LAUNCHES)
    launch = mk._marginal_wide_cuda if route == "wide" else mk._marginal_cuda
    got = launch(0, batch, cfg, consts, start, True)
    launches[route] += 1
    assert mk.LAUNCHES == launches
    _assert_same_chain(got, ref)


# every lane width by isoform width and class count: C = 4 (one class a
# thread at T = 4), 5 (no lane width divides it) and 40 (more classes
# than the widest lane has threads); 64 isoforms at the narrow lanes
# only: a wide lane shuffles 64 normals through the shim's barriers
# every step
M_LAYOUTS = [(I, num_iso, C, plan.T)
             for I, num_iso in ((2, 2), (3, 3), (8, 5), (64, 33))
             for C in (4, 5, 40)
             for plan in mk.all_marginal_plans(3, C, I, 2)
             if I <= 64 or plan.T <= 4]


@pytest.mark.parametrize("I,num_iso,C,T", M_LAYOUTS)
def test_marginal_source_matches_plain_in_every_plan(on_cpu, I, num_iso, C,
                                                     T):
    cfg = SamplerConfig(algorithm="marginal", **SMALL)
    batch = marginal_lane_batch(I, num_iso, I, "cpu", C=C)
    consts = mk._marginal_consts(batch)
    plan = next(p for p in mk.all_marginal_plans(3, C, I, 2) if p.T == T)
    given = torch.cat([_start(num_iso, 2, 2, I), torch.zeros((1, 2, I))])
    for start in (None, given):
        ref = mk._marginal_plain(0, batch, cfg, consts, start, mk.FIXED_U)
        got = mk._marginal_cuda(0, batch, cfg, consts, start, True,
                                plan=plan)
        _assert_same_chain(got, ref)


def test_marginal_source_draws_one_philox_chain_in_every_plan(on_cpu):
    batch = marginal_lane_batch(3, 3, 5, "cpu", C=5)   # 3 events, 9 lanes
    E, C, I = batch.weights.shape
    cfg = SamplerConfig(algorithm="classes", iters=61, burn_in=10, lag=5,
                        chains=3)
    consts = mk._marginal_consts(batch)
    plans = mk.all_marginal_plans(E, C, I, cfg.chains)
    assert [p.T for p in plans] == list(mk.LANE_THREADS)
    first = None
    for plan in plans:
        got = mk._marginal_cuda(17, batch, cfg, consts, None, False,
                                plan=plan).to_numpy()
        if first is None:
            first = got
            continue
        np.testing.assert_array_equal(got.psi_samples, first.psi_samples)
        np.testing.assert_array_equal(got.loglik, first.loglik)
        np.testing.assert_array_equal(got.final_psi, first.final_psi)
        np.testing.assert_array_equal(got.accepted, first.accepted)
    # a chain that moves on the real events; the padding event's proposals
    # change nothing and are all accepted
    real = first.accepted[:2]
    assert np.all(0 < real) and np.all(real < cfg.iters * cfg.chains)
    assert np.all(np.isfinite(first.loglik))
    np.testing.assert_array_equal(first.final_n, 0.0)
    # another seed, another chain
    other = mk._marginal_cuda(18, batch, cfg, consts, None, False,
                              plan=plans[0]).to_numpy()
    assert not np.array_equal(other.psi_samples, first.psi_samples)


@pytest.mark.parametrize("change", [
    dict(T=3), dict(T=64, lanes_per_block=2), dict(T=0),
    dict(T=8, lanes_per_block=3), dict(lanes_per_block=0),
    dict(T=4, lanes_per_block=64)])
def test_marginal_launcher_refuses_a_plan_it_cannot_lay_out(on_cpu, change):
    cfg = SamplerConfig(algorithm="marginal", **SMALL)
    batch = marginal_lane_batch(2, 2, 0, "cpu")
    consts = mk._marginal_consts(batch)
    bad = mk.marginal_plan(3, 4, 2, 2)._replace(**change)
    launches = mk.LAUNCHES["cuda"]
    with pytest.raises(RuntimeError, match="marginal kernel launch"):
        mk._marginal_cuda(0, batch, cfg, consts, None, True, plan=bad)
    assert mk.LAUNCHES["cuda"] == launches


# ------------------------------------------ the wide kernels B1w and B2w
WIDE = dict(iters=10, burn_in=2, lag=2, chains=2)


def _wide_case(kind, I, num_iso):
    """(batch, consts, plans, launcher, plain version) of a wide kernel's
    check: B1w on ``lane_test_batch`` (E=2, R=16 with padding reads), B2w
    on ``marginal_lane_batch`` (E=3 with a padding event, C=5 with an
    empty class)."""
    if kind == "reassign":
        batch = lane_test_batch(I, num_iso, I, "cpu")
        return (batch, rk._event_consts(batch), rk.all_wide_plans(2, 16, I, 2),
                rk._reassign_wide_cuda, rk._reassign_plain)
    batch = marginal_lane_batch(I, num_iso, I, "cpu", C=5)
    return (batch, mk._marginal_consts(batch), mk.all_wide_plans(3, 5, I, 2),
            mk._marginal_wide_cuda, mk._marginal_plain)


# every block width of wide_plan at 128 and 2,048 isoforms (70 and 1,100
# real), and the lane arrays in scratch (as the card takes them past its
# shared memory: here forced by a plan of no shared memory)
WIDE_PLANS = [(kind, I, num_iso, threads, "shared")
              for kind in wide.KINDS
              for I, num_iso in ((128, 70), (2048, 1100))
              for threads in wide.WIDE_THREADS] + [
    (kind, I, num_iso, 64, "scratch") for kind in wide.KINDS
    for I, num_iso in ((128, 70), (2048, 1100))]


@pytest.mark.parametrize("kind,I,num_iso,threads,arrays", WIDE_PLANS)
def test_wide_source_matches_plain_in_every_plan(on_cpu, kind, I, num_iso,
                                                 threads, arrays):
    """B1w / B2w against their plain versions in the wide summing order,
    under fixed uniforms, from the AUTO start (and a GIVEN one at 128
    isoforms)."""
    cfg = SamplerConfig(algorithm=kind, **WIDE)
    batch, consts, plans, launch, plain = _wide_case(kind, I, num_iso)
    # B2w: a block a lane, its rows in device memory (the clusters and
    # shared rows: test_marginal_wide_source_in_every_cluster_and_home)
    plan = next(p for p in plans if p.threads == threads
                and p.cluster == 1 and p.weights == "device")
    if kind == "reassign":
        assert plan.shared_bytes == 4 * wide.lane_floats(kind, 16, I,
                                                         plan.rows)
    else:
        assert plan.shared_bytes == wide.marginal_bytes(5, I)
    if arrays == "scratch":
        plan = plan._replace(shared_bytes=0)
    E = batch.weights.shape[0]
    starts = [None]
    if I == 128:
        starts.append(torch.cat([_start(num_iso, 2, 2, I),
                                 torch.zeros((E - 2, 2, I))]))
    for start in starts:
        ref = plain(0, batch, cfg, consts, start, rk.FIXED_U)
        got = launch(0, batch, cfg, consts, start, True, plan=plan)
        _assert_same_chain(got, ref)
        if kind == "reassign":
            if start is None:
                # a read a class: the class table's chain is the walk's
                # (from a GIVEN start the host's logf and torch's log
                # differ in the last bit; on the card they agree)
                _assert_bit_equal(got, ref)
            # every compatible read counted once, in every chain
            valid = (batch.read_w.sum(-1) > 0).sum(-1, keepdim=True)
            np.testing.assert_array_equal(
                got.final_n.sum(-1).numpy(), valid.expand(E, 2).numpy())


# B2w in every cluster size and home of its class rows (C = 5 classes:
# at a cluster of 4 the last block holds none), with its lane arrays in
# shared memory and in scratch, at 128 isoforms in every block width
# (one warp, two, four and more: the warps that draw ahead and sum the
# quadratics; a cluster of 4 to four warps), at 512 in the narrowest and
# the widest; a cluster of 8 (three blocks without rows) at 128.  The
# shim runs a cluster's threads one after another, so the schedule is
# short: six steps, three records.
CLUSTER_SHORT = dict(iters=6, burn_in=1, lag=2, chains=2)
CLUSTER_WIDTHS = {(128, 1): wide.WIDE_THREADS, (128, 2): wide.WIDE_THREADS,
                  (128, 4): (32, 64, 128), (128, 8): (32, 128),
                  (512, 1): (32, 512), (512, 2): (32, 512),
                  (512, 4): (32, 512)}
B2W_CLUSTER_PLANS = [(I, num_iso, cluster, home, arrays)
                     for I, num_iso in ((128, 70), (512, 300))
                     for cluster in (1, 2, 4)
                     for home in wide.WEIGHT_HOMES
                     for arrays in ("shared", "scratch")] + [
    (128, 70, 8, "shared", "shared")]


@pytest.mark.parametrize("I,num_iso,cluster,home,arrays", B2W_CLUSTER_PLANS)
def test_marginal_wide_source_in_every_cluster_and_home(
        on_cpu, I, num_iso, cluster, home, arrays):
    """B2w is the wide-order plain version to the bit under fixed
    uniforms in the block widths of a plan of ``cluster`` blocks a lane
    with its class rows in ``home`` (shared memory: every block its
    share, once for the launch) and its lane arrays in shared memory or
    scratch, from the AUTO start (and at 128 isoforms, arrays in shared
    memory, a GIVEN one: its logf's last bits differ from torch's from
    ~200 isoforms on, ROADMAP C.6)."""
    cfg = SamplerConfig(algorithm="marginal", **CLUSTER_SHORT)
    batch, consts, _, launch, plain = _wide_case("marginal", I, num_iso)
    plans = [p for p in mk.all_wide_plans(3, 5, I, 2)
             if p.cluster == cluster and p.weights == home]
    assert [p.threads for p in plans] == list(wide.WIDE_THREADS)
    for p in plans:
        assert p.shared_bytes == wide.marginal_bytes(5, I, cluster, home)
    plans = [p for p in plans if p.threads in CLUSTER_WIDTHS[I, cluster]]
    if arrays == "scratch":
        plans = [p._replace(shared_bytes=0) for p in plans]
    E = batch.weights.shape[0]
    starts = [None]
    if I == 128 and cluster <= 2 and arrays == "shared":
        starts.append(torch.cat([_start(num_iso, 2, 2, I),
                                 torch.zeros((E - 2, 2, I))]))
    for given in starts:
        ref = plain(0, batch, cfg, consts, given, rk.FIXED_U,
                    wide_order=True)
        for plan in plans:
            got = launch(0, batch, cfg, consts, given, True, plan=plan)
            if given is None:
                _assert_bit_equal(got, ref)
            # from a GIVEN start the host's logf and torch's log may
            # differ in the last bit; on the card they agree
            _assert_same_chain(got, ref)


def _assert_bit_equal(got, ref):
    for name, a, b in zip(got._fields, got.to_numpy(), ref.to_numpy()):
        np.testing.assert_array_equal(a, b, err_msg=name)


def _expanded(batch, R):
    """A class batch with its read tiles, as the plain version reads it."""
    rw, rls = rk.expand_read_tensors(batch.weights, batch.log_read,
                                     batch.counts, R)
    return batch._replace(read_w=rw, read_logscore=rls)


# B1w on class tensors (testing.wide_class_batch: 7 classes, 20 read
# slots, a class of no reads, one of zero weights whose reads straddle
# two groups of four, padding reads), as run_sampler hands a wide bucket
# over: every block width, the lane arrays in scratch, and tables of
# many tiles (two rows a tile in shared memory, one in scratch), also at
# 384 and 512 isoforms (rows of 3 and 4 chunks, which a warp takes four
# chunks at a time: at 384 one slot idles); at 64 isoforms (half a
# chunk), every block width; and
# launches whose reads walk (wide.walks): C = R, 16
# classes of a read each, and 16 classes in 20 slots, some of 2 and 3
# reads
B1W_CLASS_PLANS = [(128, 70, layout) for layout in (
    "widths", "scratch", "tiles", "C=R", "walks")] + [
    (64, 40, "widths"), (384, 250, "tiles"), (512, 300, "tiles")]
WALK_COUNTS = {"C=R": np.ones((2, 16)),
               "walks": [(2, 1, 1, 0, 3, 1, 1, 1, 2, 1, 1, 1, 1, 1, 1, 1),
                         (1, 3, 1, 1, 1, 2, 0, 1, 1, 1, 1, 2, 1, 1, 1, 1)]}


@pytest.mark.parametrize("I,num_iso,layout", B1W_CLASS_PLANS)
def test_wide_source_reads_classes(on_cpu, monkeypatch, I, num_iso,
                                   layout):
    """B1w on class tensors is the wide-order plain version on their
    expanded read tiles, to the bit from the AUTO start (from a GIVEN
    one within the card's tolerances: the host's logf is not torch's)
    and to the bit B1w on those tiles; every read with a compatible
    isoform counts once; the kernel's route expands no tile."""
    from miso_tpu_torch.testing import WIDE_CLASS_SLOTS, wide_class_batch

    cfg = SamplerConfig(**WIDE)
    counts = [WALK_COUNTS[layout]] if layout in WALK_COUNTS else []
    batch = wide_class_batch(I, num_iso, I, "cpu", *counts)
    E, C, _ = batch.weights.shape
    R = 16 if layout == "C=R" else WIDE_CLASS_SLOTS
    plans = rk.all_wide_plans(E, R, I, 2, classes=C)
    assert wide.walks(R, C, I) == (layout in WALK_COUNTS)
    assert all(p.rows == (1 if wide.walks(R, C, I) else min(C, R))
               for p in plans)
    plans = {"widths": plans, "C=R": plans[:1], "walks": plans[1:3],
             "scratch": [p._replace(shared_bytes=0) for p in plans[:2]],
             "tiles": [wide.tiled(plans[2], R, I, 2),
                       wide.tiled(plans[0], R, I, 1)._replace(
                           shared_bytes=0)]}[layout]
    consts = rk._event_consts(batch)
    tiles = _expanded(batch, R)
    valid = (tiles.read_w.sum(-1) > 0).sum(-1, keepdim=True)
    for start in (None, _start(num_iso, 2, 2, I)):
        ref = rk._reassign_plain(0, tiles, cfg, consts, start, rk.FIXED_U,
                                 wide_order=True)
        walk = rk._reassign_wide_cuda(0, tiles, cfg, consts, start, True,
                                      plan=plans[0])
        with monkeypatch.context() as m:
            m.setattr(rk, "expand_read_tensors", None)
            m.setattr(rk, "_read_tiles", None)
            got = [rk._reassign_wide_cuda(0, batch, cfg, consts, start,
                                          True, plan=plan, pad_reads=R)
                   for plan in plans]
        for res in got:
            _assert_bit_equal(res, walk)
            if start is None:
                _assert_bit_equal(res, ref)
            _assert_same_chain(res, ref)
            np.testing.assert_array_equal(res.final_n.sum(-1).numpy(),
                                          valid.expand(E, 2).numpy())


def test_wide_source_draws_one_philox_chain_from_classes_and_tiles(
        on_cpu):
    """One seed, one chain: B1w on a class batch and on its expanded
    read tiles (each a class of one read), in every block width, in
    scratch and in tiles of the class table, bit-equal; the reads past
    pad_reads count nowhere."""
    from miso_tpu_torch.testing import wide_class_batch

    cfg = SamplerConfig(iters=20, burn_in=5, lag=5, chains=2)
    batch = wide_class_batch(128, 70, 5, "cpu")
    consts = rk._event_consts(batch)
    R = 14                      # of event 0's 15 reads, 14 have a slot
    first = rk._reassign_wide_cuda(17, _expanded(batch, R), cfg, consts,
                                   None, False)
    plans = rk.all_wide_plans(2, 16, 128, 2, classes=7)
    for plan in plans + [plans[0]._replace(shared_bytes=0),
                         wide.tiled(plans[1], 16, 128, 3)]:
        got = rk._reassign_wide_cuda(17, batch, cfg, consts, None, False,
                                     plan=plan, pad_reads=R)
        _assert_bit_equal(got, first)
    np.testing.assert_array_equal(first.final_n.sum(-1).numpy(),
                                  [[9, 9], [13, 13]])
    assert first.accepted.sum() > 0


@pytest.mark.parametrize("kind", wide.KINDS)
def test_wide_source_draws_one_philox_chain_in_every_plan(on_cpu, kind):
    """One seed, one chain: every output bit-equal in every block width
    and in scratch, and for B2w in every cluster size and home of its
    class rows (a cluster's blocks draw their share of the normals into
    every block), the log-likelihood too (every sum runs in one order
    whatever the block); another seed, another chain."""
    cfg = SamplerConfig(algorithm=kind, iters=20, burn_in=5, lag=5,
                        chains=2)
    batch, consts, plans, launch, _ = _wide_case(kind, 128, 70)
    if kind == "marginal":
        # B2w: every block width a block a lane, rows in device memory;
        # every cluster size and home of the rows at 64 threads
        plans = [p for p in plans if p.cluster == 1 and p.weights == "device"
                 ] + [p for p in plans if p.threads == 64 and (
                     p.cluster, p.weights) != (1, "device")]
        assert len(plans) == len(wide.WIDE_THREADS) + 2 * len(
            wide.CLUSTERS) - 1
    first = None
    for plan in plans + [plans[0]._replace(shared_bytes=0)]:
        got = launch(17, batch, cfg, consts, None, False,
                     plan=plan).to_numpy()
        if first is None:
            first = got
            continue
        for a, b in zip(got, first):
            np.testing.assert_array_equal(a, b)
    assert first.accepted[:2].sum() > 0
    assert np.all(np.isfinite(first.psi_samples))
    other = launch(18, batch, cfg, consts, None, False,
                   plan=plans[0]).to_numpy()
    assert not np.array_equal(other.psi_samples, first.psi_samples)


@pytest.mark.parametrize("kind", wide.KINDS)
def test_wide_source_through_the_wrapper(on_cpu, kind):
    """The wide launcher as the wrapper calls it, in the plan
    ``wide_plan`` chooses, on reads that need padding to a multiple of
    four: counted once, as a wide launch."""
    cfg = SamplerConfig(algorithm=kind, **WIDE)
    batch, consts, _, launch, plain = _wide_case(kind, 128, 70)
    if kind == "reassign":
        batch = batch._replace(read_w=batch.read_w[:, :14].contiguous(),
                               read_logscore=batch.read_logscore[:, :14]
                               .contiguous())
    launches = dict(LAUNCHES_OF[kind])
    ref = plain(0, batch, cfg, consts, None, rk.FIXED_U)
    got = launch(0, batch, cfg, consts, None, True)
    launches["wide"] += 1
    launches["plain"] += 1
    assert LAUNCHES_OF[kind] == launches
    _assert_same_chain(got, ref)


LAUNCHES_OF = {"reassign": rk.LAUNCHES, "marginal": mk.LAUNCHES}


@pytest.mark.parametrize("kind", wide.KINDS)
@pytest.mark.parametrize("change", [
    dict(threads=48), dict(threads=1024), dict(threads=0),
    dict(shared_bytes=4)])
def test_wide_launcher_refuses_a_plan_it_cannot_lay_out(on_cpu, kind,
                                                        change):
    """A block of whole warps up to 512 threads, and the lane's arrays in
    shared memory of exactly their size (B2w: a cluster of 1, 2, 4 or 8
    blocks, and shared memory of exactly its layout for the plan's home
    of the rows): anything else is refused, not run, and not counted."""
    cfg = SamplerConfig(algorithm=kind, **WIDE)
    batch, consts, plans, launch, _ = _wide_case(kind, 128, 70)
    bads = [plans[0]._replace(**change)]
    if kind == "marginal":
        bads += [plans[0]._replace(**change, cluster=c) for c in (0, 3, 16)]
        bads.append(plans[0]._replace(**change, weights="shared"))
    launches = dict(LAUNCHES_OF[kind])
    for bad in bads:
        with pytest.raises(RuntimeError,
                           match="wide %s kernel launch" % kind):
            launch(0, batch, cfg, consts, None, True, plan=bad)
    assert LAUNCHES_OF[kind] == launches
    if kind == "marginal":
        # a cluster the launcher takes, with the bytes of another home
        for c in (1, 3):
            plan = plans[0]._replace(cluster=c, weights="shared")
            with pytest.raises(RuntimeError, match="wide marginal kernel"):
                launch(0, batch, cfg, consts, None, True, plan=plan)
        assert LAUNCHES_OF[kind] == launches


@pytest.mark.parametrize("kind", wide.KINDS)
def test_wide_launcher_refuses_a_launch_without_its_arrays(on_cpu, kind):
    """The lane arrays lie in shared memory or in scratch, never both and
    never neither: a launch with scratch and shared memory, or with
    neither, or asking for more shared memory than a block has, is
    refused, and so is a B1w table of no rows; B2w's shared memory is its
    layout's to the byte (term buffers, shared rows, lane arrays), its
    cluster 1, 2, 4 or 8 blocks and its rows' home 0 or 1; the source's
    size of a lane's arrays is wide.lane_floats's."""
    n = 16 if kind == "reassign" else 5
    batch, _, plans, _, _ = _wide_case(kind, 128, 70)
    rows = plans[0].rows
    for I in (2, 128, 2048, 8192):
        for r in ((0, 1, rows) if kind == "reassign" else (0,)):
            assert on_cpu.miso_wide_lane_floats(
                wide.KINDS.index(kind), n, I, r) == wide.lane_floats(
                    kind, n, I, r)
    assert wide.all_wide_plans(kind, 2, n, 8192, 2)[0].shared_bytes == 0
    E, I = batch.weights.shape[0], 128
    need = plans[0].shared_bytes
    scratch = torch.empty(E * 2 * 8 * wide.lane_floats(kind, n, I, rows))
    out = [torch.empty(m) for m in (E * I, E, E * 2, E * 2 * I, E * 2 * I)]
    consts = (rk._event_consts(batch) if kind == "reassign"
              else mk._marginal_consts(batch))
    # (scratch, shared bytes, B1w's rows or B2w's (cluster, rows shared))
    if kind == "reassign":
        cases = [(scratch, need, rows), (None, 0, rows),
                 (None, need - 4, rows),
                 (None, 4 * wide.lane_floats(kind, n, 8192, rows), rows),
                 (None, 4 * wide.lane_floats(kind, n, I, 0), 0)]
    else:
        assert need == wide.marginal_bytes(n, I)
        terms = wide.marginal_bytes(n, I, arrays=False)
        shared = wide.marginal_bytes(n, I, 2, "shared")
        cases = [(scratch, need, (1, 0)), (None, 0, (1, 0)),
                 (None, need - 4, (1, 0)), (scratch, 0, (1, 0)),
                 (None, wide.marginal_bytes(n, 8192), (1, 0)),
                 (None, need, (3, 0)), (None, need, (16, 0)),
                 (None, need, (0, 0)), (None, need, (1, 2)),
                 (None, need, (2, 1)), (None, shared, (1, 1)),
                 (scratch, terms, (1, 1))]
    for arrays, shared, r in cases:
        ptr = None if arrays is None else arrays.data_ptr()
        if kind == "reassign":
            cmap = rk.class_map(torch.ones((E, 16)), 16)
            rc = on_cpu.miso_reassign_wide(
                batch.read_w.data_ptr(), batch.read_logscore.data_ptr(),
                *[t.data_ptr() for t in cmap[:-1]], torch.ones(E).data_ptr(),
                consts[0].data_ptr(), consts[1].data_ptr(),
                batch.num_iso.data_ptr(), consts[5].data_ptr(), None,
                *[t.data_ptr() for t in out], ptr, E, 16, 16, 16, I, 2, 4,
                0, 1, 1, 0, 0, 1, 32, r, shared, None)
        else:
            rc = on_cpu.miso_marginal_wide(
                batch.weights.data_ptr(), batch.counts.data_ptr(),
                batch.num_iso.data_ptr(), consts[0].data_ptr(),
                consts[1].data_ptr(), None, *[t.data_ptr() for t in out[:3]],
                out[4].data_ptr(), ptr, E, 5, I, 2, 4, 0, 1, 1, 0, 0, 1, 32,
                *r, shared, None)
        assert rc != 0, (arrays is not None, shared, r)
    if kind == "marginal":
        # and the layouts it does take: the same calls, laid out right
        out = [torch.empty(m) for m in (E * 2 * I, E * 2, E * 2, E * 2 * I)]
        for arrays, shared, r in [(None, need, (1, 0)), (scratch, terms, (1, 0)),
                                  (None, wide.marginal_bytes(n, I, 2, "shared"),
                                   (2, 1))]:
            rc = on_cpu.miso_marginal_wide(
                batch.weights.data_ptr(), batch.counts.data_ptr(),
                batch.num_iso.data_ptr(), consts[0].data_ptr(),
                consts[1].data_ptr(), None, *[t.data_ptr() for t in out],
                None if arrays is None else arrays.data_ptr(),
                E, 5, I, 2, 4, 0, 1, 1, 0, 0, 1, 32, *r, shared, None)
            assert rc == 0, (arrays is not None, shared, r)


# ------------------------------------------------ the multinomial kernel B3
# every lane width by width and class count (I = 2, 3; C = 4 one class a
# slot from T = 4 on, C = 5 no lane width divides it; I = 16 and 128,
# narrow lanes only at 128), each with a padding event, counts of
# 3,000-6,000 reads, non-zero read scores, from AUTO and from a GIVEN
# start; the lane arrays in shared memory, and in scratch ("scratch":
# forced at I = 16, and I = 3,700, past the block's shared memory)
B3_PLANS = [(I, num_iso, C, plan.T, "shared")
            for I, num_iso, C in ((2, 2, 4), (3, 3, 5), (16, 9, 6),
                                  (128, 70, 4))
            for plan in deep.all_multinomial_plans(3, C, I, 2)
            if I <= 16 or plan.T <= 4] + [
    (16, 9, 6, 32, "scratch"), (16, 9, 6, 2, "scratch"),
    (3700, 5, 3, 32, "scratch")]


@pytest.mark.parametrize("I,num_iso,C,T,arrays", B3_PLANS)
def test_multinomial_source_matches_plain_in_every_plan(on_cpu, I, num_iso,
                                                        C, T, arrays):
    cfg = SamplerConfig(**SMALL)
    batch = multinomial_lane_batch(I, num_iso, I, "cpu", C=C, scale=100.0)
    consts = deep._event_consts(batch)
    plan = next(p for p in deep.all_multinomial_plans(3, C, I, 2)
                if p.T == T)
    if arrays == "scratch" and I <= 16:
        plan = plan._replace(shared_bytes=0)
    assert (plan.shared_bytes > 0) == (arrays == "shared")
    given = torch.cat([_start(num_iso, 2, 2, I), torch.zeros((1, 2, I))])
    for start in (None, given):
        ref = deep._multinomial_plain(0, batch, cfg, consts, start,
                                      deep.FIXED_U)
        got = deep._multinomial_cuda(0, batch, cfg, consts, start, True,
                                     plan=plan)
        _assert_same_chain(got, ref)
        # every compatible class's reads are placed, a padding event's
        # none
        compat = (batch.weights.sum(-1) > 0) * batch.counts
        np.testing.assert_array_equal(
            got.final_n.sum(-1).numpy(),
            compat.sum(-1, keepdim=True).expand(3, 2).numpy())


def test_multinomial_source_through_the_wrapper(on_cpu):
    """``_multinomial_cuda`` as the wrapper calls it, in the plan
    ``multinomial_plan`` chooses, counted once."""
    cfg = SamplerConfig(**SMALL)
    batch = multinomial_lane_batch(2, 2, 2, "cpu", C=4, scale=40.0)
    consts = deep._event_consts(batch)
    launches = deep.LAUNCHES["cuda"]
    ref = deep._multinomial_plain(0, batch, cfg, consts, None, deep.FIXED_U)
    got = deep._multinomial_cuda(0, batch, cfg, consts, None, True)
    assert deep.LAUNCHES["cuda"] == launches + 1
    _assert_same_chain(got, ref)


def test_multinomial_source_draws_one_philox_chain_in_every_plan(on_cpu):
    batch = multinomial_lane_batch(3, 3, 5, "cpu", C=5, scale=50.0)
    E, C, I = batch.weights.shape
    cfg = SamplerConfig(iters=61, burn_in=10, lag=5, chains=3)
    consts = deep._event_consts(batch)
    plans = deep.all_multinomial_plans(E, C, I, cfg.chains)
    assert [p.T for p in plans] == list(deep.LANE_THREADS)
    # a warp a lane (T = 32: 8 class slots of 4 threads that try a draw's
    # calls at once), lanes packed into warps (T < 32; T <= 8: one thread
    # a slot, its calls in turn), the lane arrays in shared memory and in
    # scratch
    scratch = [p._replace(shared_bytes=0) for p in plans if p.T in (1, 32)]
    first = None
    for plan in plans + scratch:
        got = deep._multinomial_cuda(17, batch, cfg, consts, None, False,
                                     plan=plan).to_numpy()
        if first is None:
            first = got
            continue
        np.testing.assert_array_equal(got.psi_samples, first.psi_samples)
        np.testing.assert_array_equal(got.final_n, first.final_n)
        np.testing.assert_array_equal(got.accepted, first.accepted)
        np.testing.assert_allclose(got.loglik, first.loglik, rtol=0,
                                   atol=LL_ATOL)
    real = first.accepted[:2]
    assert np.all(0 < real) and np.all(real < cfg.iters * cfg.chains)
    np.testing.assert_array_equal(first.final_n[:2].sum(-1), 3000.0)
    other = deep._multinomial_cuda(18, batch, cfg, consts, None, False,
                                   plan=plans[0]).to_numpy()
    assert not np.array_equal(other.final_n, first.final_n)


@pytest.mark.parametrize("check", ["moments", "chi2"])
def test_multinomial_source_draws_binomials_of_the_right_moments(on_cpu,
                                                                 check):
    """Each class's draw at a lane's psi, at n p below 10 (inversion) and
    above (BTRS), p below and above 1/2: the standardised draws of 256
    lanes have mean 0 and variance 1 within 5 and 6 standard errors;
    against the exact pmf, their randomised probability integral
    transforms in 8 equal bins give a chi2 of p-value above 1e-3
    (chip_smoke.py runs both at the card's sample size)."""
    batch = binomial_batch(64, "cpu")
    cfg = SamplerConfig(iters=0, burn_in=0, lag=1, chains=4)
    res = deep._multinomial_cuda(5, batch, cfg, deep._event_consts(batch),
                                 None, False)
    if check == "chi2":
        chi2 = binomial_chi2(batch, res, 8)
        assert [n for _, _, n in chi2] == [256] * len(BINOMIAL_REGIMES)
        assert all(p > 1e-3 for _, p, _ in chi2), chi2
        return
    moments, sums = binomial_moments(batch, res)
    assert sums
    for mean, var, lanes in moments:
        assert lanes == 256
        assert abs(mean) < 5 / np.sqrt(lanes), moments
        assert abs(var - 1.0) < 6 * np.sqrt(2.0 / lanes), moments


def test_multinomial_source_on_the_million_read_event(on_cpu):
    """tests/test_deep_events.py's event through B3: within 0.02 of the
    grid-exact mean, final_n summing to 1,000,000."""
    from exact_posterior import exact_posterior_mean_2iso

    ev = deepened(simulated_event([100, 50, 100], [[1, 2, 3], [1, 3]],
                                  [0.3, 0.7], 2000, 25, seed=4), 500)
    batch = class_batch([ev], "cpu")
    res = deep._multinomial_cuda(
        0, batch, SamplerConfig(iters=800, burn_in=200, lag=4, chains=4),
        deep._event_consts(batch), None, False).to_numpy()
    assert abs(float(res.flat_samples()[0, :, 0].mean())
               - exact_posterior_mean_2iso(ev)) < 0.02
    np.testing.assert_array_equal(res.final_n.sum(-1), 1_000_000.0)


# the million-read event of tests/test_deep_events.py (2 isoforms), and
# a deep event of 60 real isoforms in a bucket of 64 (20,000 reads), where
# B2's isoform sums in sequence left the reference's MARGINAL chain: B3
# sums the same way (``_seq_sum``), but REASSIGN's ratio has no sum of
# squares over sigma = 0.2 / k^2 for the rounding to grow through (at 60
# isoforms the plain version alone: B3's source follows it to the bit in
# every plan, held above at 16 and 128 isoforms, and takes two minutes
# here)
DEEP_JAX_CASES = {"2 isoforms": (2, 2000, 500), "60 isoforms": (60, 2000, 10)}


@pytest.mark.parametrize("case", sorted(DEEP_JAX_CASES))
def test_multinomial_source_and_plain_agree_with_the_jax_deep_route(
        on_cpu, case):
    """A deep event through the JAX package's deep route
    (``mcmc.run_batch(..., gibbs="multinomial")``), B3's plain version
    and (two isoforms) its source, each seeded, at
    tests/test_deep_events.py's schedule:
    each posterior mean within 0.01 of the JAX route's (the posterior's
    sd is about 0.001 at 10^6 reads, under 0.005 an isoform at 60), the
    two-isoform event's within 0.02 of the grid-exact mean, the share of
    accepted steps within 0.03 of the JAX route's, and every chain's
    final_n sums to the reads."""
    import jax
    from exact_posterior import exact_posterior_mean_2iso
    from miso_tpu.core.events import pad_events
    from miso_tpu.sampler import mcmc
    from miso_tpu_torch.testing import wide_event

    num_iso, n_reads, scale = DEEP_JAX_CASES[case]
    if num_iso == 2:
        ev = simulated_event([100, 50, 100], [[1, 2, 3], [1, 3]],
                             [0.3, 0.7], n_reads, 25, seed=4)
    else:
        ev = wide_event("reassign", num_iso=num_iso, n_reads=n_reads, seed=5)
    ev = deepened(ev, scale)
    reads = float(ev.counts.sum())
    pad = pad_events([ev], per_read=False)
    ref = mcmc.run_batch(
        jax.random.PRNGKey(0),
        mcmc.EventBatch(**{k: np.asarray(v) for k, v in pad.items()}),
        mcmc.SamplerConfig(iters=800, burn_in=200, lag=4, chains=4,
                           gibbs="multinomial"))
    ref_mean = np.asarray(ref.flat_samples())[0, :, :num_iso].mean(0)
    ref_acc = float(np.asarray(ref.accepted)[0]) / (800 * 4)
    exact = exact_posterior_mean_2iso(ev) if num_iso == 2 else None
    if exact is not None:
        assert abs(ref_mean[0] - exact) < 0.02
    batch = class_batch([ev], "cpu")
    cfg = SamplerConfig(iters=800, burn_in=200, lag=4, chains=4)
    consts = deep._event_consts(batch)
    runs = [deep._multinomial_plain(3, batch, cfg, consts)]
    if num_iso == 2:
        runs.append(deep._multinomial_cuda(3, batch, cfg, consts, None,
                                           False))
    for res in runs:
        res = res.to_numpy()
        mean = res.flat_samples()[0, :, :num_iso].mean(0)
        np.testing.assert_allclose(mean, ref_mean, rtol=0, atol=0.01)
        if exact is not None:
            assert abs(mean[0] - exact) < 0.02, (mean[0], exact)
        assert abs(res.accepted[0] / (800 * 4) - ref_acc) < 0.03
        np.testing.assert_array_equal(res.final_n.sum(-1), reads)


@pytest.mark.parametrize("change", [
    dict(T=3), dict(T=64, lanes_per_block=2), dict(T=0),
    dict(T=8, lanes_per_block=3), dict(lanes_per_block=0),
    dict(T=4, lanes_per_block=64)])
def test_multinomial_launcher_refuses_a_plan_it_cannot_lay_out(on_cpu,
                                                               change):
    cfg = SamplerConfig(**SMALL)
    batch = multinomial_lane_batch(2, 2, 0, "cpu")
    consts = deep._event_consts(batch)
    bad = deep.multinomial_plan(3, 4, 2, 2)._replace(**change)
    launches = deep.LAUNCHES["cuda"]
    with pytest.raises(RuntimeError, match="multinomial kernel launch"):
        deep._multinomial_cuda(0, batch, cfg, consts, None, True, plan=bad)
    assert deep.LAUNCHES["cuda"] == launches


@pytest.mark.parametrize("I,num_iso", [(2, 2), (16, 9)])
def test_multinomial_launcher_refuses_a_launch_without_scratch(on_cpu, I,
                                                               num_iso):
    """The lane arrays lie in shared memory or in scratch: a launch with
    neither (no scratch and less shared memory than the lanes take) is
    refused, not run; the source's size of a lane's arrays is
    deep.lane_floats's."""
    batch = multinomial_lane_batch(I, num_iso, 0, "cpu")
    E, C, I = batch.weights.shape
    out = [torch.empty(n) for n in (E * I, E, E * 2, E * 2 * I,
                                    E * 2 * I)]
    consts = deep._event_consts(batch)
    plan = deep.multinomial_plan(E, C, I, 2)
    for T in deep.LANE_THREADS:
        assert on_cpu.miso_multinomial_lane_floats(C, I, T) == \
            deep.lane_floats(C, I, T)
    for shared in (0, plan.shared_bytes - 4):
        rc = on_cpu.miso_multinomial(
            batch.weights.data_ptr(), batch.log_read.data_ptr(),
            batch.counts.data_ptr(), *[c.data_ptr() for c in consts], None,
            *[t.data_ptr() for t in out], None, E, C, I, 2, 4, 0, 1, 1, 0,
            0, 1, plan.T, plan.lanes_per_block, shared, None)
        assert rc != 0


def test_multinomial_step_breakdown_build_draws_the_same_chain(
        on_cpu, clocks_library, monkeypatch):
    """The step-breakdown build (-DMISO_B3_CLOCKS) changes no draw: its
    chain is the production build's, bit for bit; its sums count every
    step of every real lane, a round of tries and a try or more for every
    BTRS draw, at most one squeeze hit a draw, and stamps in every
    phase."""
    batch = multinomial_lane_batch(3, 3, 5, "cpu", C=5, scale=50.0)
    E, C, I = batch.weights.shape
    cfg = SamplerConfig(iters=61, burn_in=10, lag=5, chains=3)
    consts = deep._event_consts(batch)
    want = deep._multinomial_cuda(17, batch, cfg, consts, None, False)
    slots = kernels.source_enum("ClockSlot")
    sums = np.zeros(len(slots), np.uint64)
    assert clocks_library.miso_multinomial_clocks(sums.ctypes.data) == 0
    monkeypatch.setattr(kernels, "load", lambda: clocks_library)
    got = deep._multinomial_cuda(17, batch, cfg, consts, None, False)
    _assert_same_chain(got, want)
    np.testing.assert_array_equal(got.final_n.numpy(), want.final_n.numpy())
    assert clocks_library.miso_multinomial_clocks(sums.ctypes.data) == 0
    v = dict(zip(slots, sums.tolist()))
    assert v["kCntSteps"] == E * cfg.chains * cfg.iters
    btrs = v["kCntDraws"] - v["kCntInversion"]
    assert btrs > 0 and v["kCntInversion"] >= 0
    assert v["kCntTries"] >= btrs and v["kCntRounds"] >= btrs
    assert 0 < v["kCntSqueeze"] < btrs and v["kCntSlow"] > 0
    for name in ("kClkRandoms", "kClkMH", "kClkProbs", "kClkDraws",
                 "kClkButterfly"):
        assert v[name] > 0, name
    # the read clears them
    assert clocks_library.miso_multinomial_clocks(sums.ctypes.data) == 0
    assert not sums.any()


def test_marginal_wide_step_breakdown_build_draws_the_same_chain(
        on_cpu, b2w_clocks_library, monkeypatch):
    """B2w's step-breakdown build (-DMISO_B2W_CLOCKS) changes no draw:
    its chain is the production build's, bit for bit, in a plan of one
    block a lane and in one of a cluster; its sums count every step of
    every lane once and stamp every phase that lies on the lane's first
    thread's chain."""
    batch, consts, plans, _, _ = _wide_case("marginal", 128, 70)
    E = batch.weights.shape[0]
    cfg = SamplerConfig(algorithm="marginal", iters=21, burn_in=5, lag=4,
                        chains=2)
    slots = kernels.source_enum("B2wClock", "wide_kernel.cu")
    sums = np.zeros(len(slots), np.uint64)
    assert b2w_clocks_library.miso_marginal_wide_clocks(
        sums.ctypes.data) == 0
    for plan in _b2w_clock_plans(plans):
        want = mk._marginal_wide_cuda(17, batch, cfg, consts, None, False,
                                      plan=plan)
        with monkeypatch.context() as m:
            m.setattr(kernels, "load", lambda: b2w_clocks_library)
            got = mk._marginal_wide_cuda(17, batch, cfg, consts, None,
                                         False, plan=plan)
        _assert_bit_equal(got, want)
        assert b2w_clocks_library.miso_marginal_wide_clocks(
            sums.ctypes.data) == 0
        v = dict(zip(slots, sums.tolist()))
        assert v["kB2Steps"] == E * cfg.chains * cfg.iters, plan
        for name in ("kB2Exp", "kB2PsiSums", "kB2DivLog", "kB2Terms",
                     "kB2Quad", "kB2Sums", "kB2MH", "kB2Wait", "kB2Rows"):
            assert v[name] > 0, (name, plan)
    # the read clears them
    assert b2w_clocks_library.miso_marginal_wide_clocks(
        sums.ctypes.data) == 0
    assert not sums.any()


def _b2w_clock_plans(plans):
    """The plans the breakdown build is held in: the first block width,
    and a cluster of two where the plan has clusters."""
    out = [plans[0]]
    out += [p for p in plans if p.cluster == 2][:1]
    return out
