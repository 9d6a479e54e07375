"""`miso_torch --run` across hosts, on the CPU.

The cases of tests/test_multihost.py on the port's CLI: two
``miso_tpu_torch.cli.main --device cpu`` subprocesses rendezvous over a
``torch.distributed`` gloo group on localhost
(miso_tpu_torch/parallel/distributed.py), shard the gene catalog
disjointly and write one merged output tree with a summary per host.
Beside them the host axis of the chunk seeds (no two hosts share a
random stream; a single host draws what it drew before the axis
existed), ``host_shard`` against the JAX package's, and ``--prefilter``
narrowing a host's shard instead of replacing it.
"""
import glob
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import miso_tpu_torch.pipeline as tp
from miso_tpu.parallel import distributed as jdist
from miso_tpu_torch._host import RunConfig
from miso_tpu_torch.parallel import distributed as tdist
from miso_tpu_torch.testing import cap_test_threads, simulated_event

# a child interpreter takes the cap too
CHILD_THREADS = cap_test_threads()

N_EVENTS = 8
READ_LEN = 36


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    from miso_tpu_torch.io.index import index_gff
    from miso_tpu_torch.io.sam import open_alignments
    from miso_tpu_torch.testing import build_catalog_fixture

    root = tmp_path_factory.mktemp("torch_multihost")
    fix = build_catalog_fixture(str(root / "cat"), num_events=N_EVENTS,
                                reads_per_event=150, read_len=READ_LEN,
                                seed=3)
    idx = str(root / "index")
    index_gff(fix["gff"], idx)
    # pre-build the .bai so concurrent subprocesses never race on it
    bam = open_alignments(fix["bam"])
    list(bam.fetch(bam.references[0], 0, 1))
    settings = root / "fast.txt"
    settings.write_text("[sampler]\nburn_in = 100\nlag = 5\n"
                        "num_iters = 600\nnum_chains = 2\n")
    return {"root": root, "fix": fix, "idx": idx,
            "settings": str(settings)}


def _run_cli(args):
    env = dict(os.environ, **CHILD_THREADS)
    env.setdefault("PYTHONPATH", os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return subprocess.Popen(
        [sys.executable, "-m", "miso_tpu_torch.cli.main"] + args
        + ["--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _base_args(catalog, out):
    return ["--run", catalog["idx"], catalog["fix"]["bam"],
            "--output-dir", out, "--read-len", str(READ_LEN),
            "--settings-filename", catalog["settings"]]


def _communicate(procs):
    outputs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=420)
            outputs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outputs


def _summary_names(path):
    with open(path) as fh:
        next(fh)
        return [line.split("\t", 1)[0] for line in fh if line.strip()]


def test_two_process_run_merges_to_one_tree(catalog):
    """Two hosts, one catalog: disjoint shards, merged output, and the
    merged tree summarizes identically in layout to a single-host run."""
    fix = catalog["fix"]
    out = str(catalog["root"] / "out_multi")
    port = _free_port()
    procs = [_run_cli(_base_args(catalog, out) + [
        "--coordinator", "127.0.0.1:%d" % port,
        "--num-hosts", "2", "--host-id", str(hid)]) for hid in (0, 1)]
    outputs = _communicate(procs)
    assert all(p.returncode == 0 for p in procs), "\n----\n".join(outputs)

    shards = [int(re.search(r"Host shard: (\d+) genes", o).group(1))
              for o in outputs]
    assert all(s > 0 for s in shards)
    assert sum(shards) == N_EVENTS

    files = glob.glob(os.path.join(out, "chr*", "*.miso"))
    assert len(files) == N_EVENTS  # merged tree: every gene exactly once

    # each host quantified ONLY its shard, on the device it was given
    for o, s in zip(outputs, shards):
        m = re.search(r"Quantified (\d+) events \(\d+ skipped\) in \S+ on "
                      r"(\S+)", o)
        assert m and int(m.group(1)) == s and m.group(2) == "cpu"

    # the merged tree is a valid reference-layout sample dir: summarize
    # it with the port's summarizer and check the means against the truth
    from miso_tpu_torch.io.miso_file import summarize_sampler_results

    summ = str(catalog["root"] / "summ.miso_summary")
    assert summarize_sampler_results(out, summ) == N_EVENTS
    means = {}
    with open(summ) as fh:
        next(fh)
        for line in fh:
            fields = line.split("\t")
            means[fields[0]] = float(fields[1])
    truth = {"ev%d" % e: fix["true_psi"][e] for e in range(N_EVENTS)}
    errs = [abs(means[g] - truth[g]) for g in truth]
    assert np.mean(errs) < 0.06, (means, truth)

    # each host wrote its OWN run summary; together they cover the
    # catalog exactly once, each its round-robin shard of the sorted ids
    sfiles = sorted(glob.glob(os.path.join(out, "summary",
                                           "*.host*.miso_summary")))
    assert [os.path.basename(f) for f in sfiles] == [
        "out_multi.host0.miso_summary", "out_multi.host1.miso_summary"]
    ids = sorted("ev%d" % e for e in range(N_EVENTS))
    for hid, f in enumerate(sfiles):
        assert _summary_names(f) == sorted(ids[hid::2])


def test_single_host_without_flags_is_unchanged(catalog):
    """No coordinator flags -> no rendezvous, whole catalog on one host,
    one summary without a host label."""
    out = str(catalog["root"] / "out_single")
    p = _run_cli(_base_args(catalog, out))
    (o,) = _communicate([p])
    assert p.returncode == 0, o
    assert "Host shard" not in o
    assert len(glob.glob(os.path.join(out, "chr*", "*.miso"))) == N_EVENTS
    assert os.listdir(os.path.join(out, "summary")) == [
        "out_single.miso_summary"]


def test_host_started_alone_fails_at_the_rendezvous(catalog, monkeypatch):
    """A host whose peers never come fails at the start, when the
    rendezvous times out, and not after it has run its shard."""
    monkeypatch.setattr(tdist, "RENDEZVOUS_TIMEOUT", 3)
    out = str(catalog["root"] / "out_alone")
    from miso_tpu_torch.cli.main import main as torch_main
    with pytest.raises(Exception):
        torch_main(_base_args(catalog, out) + [
            "--coordinator", "127.0.0.1:%d" % _free_port(),
            "--num-hosts", "2", "--host-id", "1", "--device", "cpu"])
    assert not glob.glob(os.path.join(out, "chr*", "*.miso"))
    assert tdist.process_count() == 1


def test_prefilter_narrows_the_hosts_shard(tmp_path):
    """--prefilter with --num-hosts: a host runs the genes of ITS shard
    that pass the coverage filter, not every gene that passes."""
    from miso_tpu_torch.io.gff import write_gff
    from miso_tpu_torch.io.index import index_gff
    from miso_tpu_torch.io.sam import open_alignments
    from miso_tpu_torch.testing import make_se_catalog, simulate_catalog_bam

    rng = np.random.default_rng(5)
    genes, records, true_psi = make_se_catalog(N_EVENTS, rng)
    gff = str(tmp_path / "catalog.gff")
    write_gff(records, gff)
    bam = str(tmp_path / "catalog.bam")
    # reads for ev0 ... ev4 only: ev5, ev6, ev7 fail the filter
    simulate_catalog_bam(genes[:5], true_psi[:5], 150, READ_LEN, bam, rng)
    idx = str(tmp_path / "index")
    index_gff(gff, idx)
    alignments = open_alignments(bam)      # the .bai, before two hosts race
    list(alignments.fetch(alignments.references[0], 0, 1))
    settings = tmp_path / "fast.txt"
    settings.write_text("[sampler]\nburn_in = 20\nlag = 5\n"
                        "num_iters = 320\nnum_chains = 2\n")
    out = str(tmp_path / "out")
    port = _free_port()
    procs = [_run_cli(["--run", idx, bam, "--output-dir", out,
                       "--read-len", str(READ_LEN), "--settings-filename",
                       str(settings), "--prefilter", "--coordinator",
                       "127.0.0.1:%d" % port, "--num-hosts", "2",
                       "--host-id", str(hid)]) for hid in (0, 1)]
    outputs = _communicate(procs)
    assert all(p.returncode == 0 for p in procs), "\n----\n".join(outputs)
    text = outputs[1]
    assert "Host shard: 4 genes on this host" in text
    assert "Prefilter: 2 genes pass the coverage filter" in text
    files = glob.glob(os.path.join(out, "chr*", "*.miso"))
    assert sorted(os.path.basename(f) for f in files) == [
        "ev0.miso", "ev1.miso", "ev2.miso", "ev3.miso", "ev4.miso"]
    assert _summary_names(os.path.join(
        out, "summary", "out.host1.miso_summary")) == ["ev1", "ev3"]
    assert _summary_names(os.path.join(
        out, "summary", "out.host0.miso_summary")) == ["ev0", "ev2", "ev4"]


# -------------------------------------------------------- shard and seeds
@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_host_shard_matches_jax(count):
    items = ["g%02d" % i for i in range(17)]
    seen = []
    for pid in range(count):
        got = tdist.host_shard(items, pid, count)
        assert got == jdist.host_shard(items, process_id=pid,
                                       process_count=count)
        seen.extend(got)
    assert sorted(seen) == items


def test_initialize_reads_the_reference_env_names(monkeypatch):
    """The three env names of the JAX package; a run with any of them
    needs all three, and meets the others before it takes its shard."""
    import torch.distributed as dist

    met = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: met.append((backend, kw)))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: met.append("left"))
    assert tdist.initialize_distributed() is False
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)
    monkeypatch.setenv("MISO_NUM_HOSTS", "3")
    monkeypatch.setenv("MISO_HOST_ID", "2")
    # rank and count without a coordinator: no rendezvous, so no run
    with pytest.raises(ValueError, match="--coordinator"):
        tdist.initialize_distributed()
    assert not met and tdist.process_count() == 1
    monkeypatch.setenv("MISO_COORDINATOR_ADDRESS", "127.0.0.1:4321")
    try:
        assert tdist.initialize_distributed() is True
        assert (tdist.process_index(), tdist.process_count()) == (2, 3)
        assert tdist.host_shard(list(range(7))) == [2, 5]
        (backend, kw), = met
        assert backend == "gloo" and kw["rank"] == 2 and \
            kw["world_size"] == 3 and \
            kw["init_method"] == "tcp://127.0.0.1:4321"
    finally:
        tdist.shutdown()
    assert met[-1] == "left"
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)
    monkeypatch.setenv("MISO_HOST_ID", "3")
    with pytest.raises(ValueError, match="outside 0 ... 2"):
        tdist.initialize_distributed()
    assert tdist.process_count() == 1 and len(met) == 2
    # one host of one is no multi-host run
    try:
        assert tdist.initialize_distributed("127.0.0.1:4321", 1, 0) is False
    finally:
        tdist.shutdown()


# chunk_seed(seed, offset, pad_iso, pad_classes, pad_reads) as it was
# before the host axis: a single-host run must go on drawing these
SINGLE_HOST_SEEDS = {
    (0, 0, 2, 4, 320): 0x32fdb9054fdf76c5,
    (7, 4096, 3, 8, 1024): 0x5840537ae8dbd61d,
}


def test_no_two_hosts_share_a_chunk_seed():
    """No (host, shard, bucket, offset) pair shares a seed with another:
    neither across hosts nor across the shards of a host's mesh, and
    shard k of a single host never takes host k's seed."""
    buckets = [(2, 4, 320), (2, 4, 640), (3, 8, 320), (256, 64, 1024)]
    offsets = [0, 4096, 8192]
    per_host = []
    for host in (None, 0, 1, 2):
        for shard in (None, 0, 1, 2, 7):
            per_host.append({tp.chunk_seed(5, off, *b, host=host,
                                           shard=shard)
                             for b in buckets for off in offsets})
            assert len(per_host[-1]) == len(buckets) * len(offsets)
    for i in range(len(per_host)):
        for j in range(i + 1, len(per_host)):
            assert not per_host[i] & per_host[j]
    # a single host keeps the seeds it had before the axis existed
    for args, want in SINGLE_HOST_SEEDS.items():
        assert tp.chunk_seed(*args) == want


def test_runner_folds_the_host_id_into_its_streams(monkeypatch):
    """The same events and --seed on host 0 and host 1 of two draw
    different chains; without the flags the run is what it was."""
    ev = simulated_event([100, 50, 100], [[1, 2, 3], [1, 3]], [0.6, 0.4],
                         60, 25, seed=1)
    cfg = RunConfig(read_len=25, iters=60, burn_in=10, lag=5, chains=2)

    def ticks():
        return tp.run_events([ev] * 3, cfg, seed=0,
                             device="cpu")[0]["psi_ticks"]

    single = ticks()
    np.testing.assert_array_equal(single, ticks())
    by_host = []
    for hid in (0, 1):      # the rank and count a rendezvous leaves
        with monkeypatch.context() as m:
            m.setitem(tdist._STATE, "rank", hid)
            m.setitem(tdist._STATE, "count", 2)
            by_host.append(ticks())
    assert not np.array_equal(by_host[0], by_host[1])
    assert not np.array_equal(by_host[0], single)
    np.testing.assert_array_equal(single, ticks())
