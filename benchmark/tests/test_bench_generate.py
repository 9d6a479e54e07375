"""The generator: one seed, one sample; other seeds, the same sizes in
another order; a BAM the program reads back as generated."""
import numpy as np
import pytest

import generate
from conftest import PE_READS, SE_READS, tiny_cell, tiny_config


def sample(kind, seed):
    if kind == "se":
        cfg = tiny_config("se_events", 40)
        cell = tiny_cell("se_events_tiny", dict(SE_READS, median=300,
                                                sigma=1.0, cap=4000))
    else:
        cfg = tiny_config("genes_pe", 30)
        cell = tiny_cell("genes_pe_tiny", dict(PE_READS, median=200,
                                               sigma=1.0, cap=2000))
    return generate.make_sample(cfg, cell, seed)


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_a_seed_reproduces_its_sample(kind, tmp_path):
    a, b = sample(kind, 2 ** 31 + 5), sample(kind, 2 ** 31 + 5)
    for f in ("block_start", "block_len", "gene", "pair", "mate"):
        np.testing.assert_array_equal(getattr(a.reads, f),
                                      getattr(b.reads, f))
    generate.write_sample(a, str(tmp_path / "a"))
    generate.write_sample(b, str(tmp_path / "b"))
    for f in ("sample.bam", "sample.gff"):
        assert (tmp_path / "a" / f).read_bytes() == (
            tmp_path / "b" / f).read_bytes()


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_other_seeds_draw_the_same_sizes(kind):
    a, b = sample(kind, 1), sample(kind, -7)
    assert sorted(a.units) == sorted(b.units)
    assert not np.array_equal(a.units, b.units)
    assert sorted(np.diff(a.models.iso_off)) == sorted(
        np.diff(b.models.iso_off))
    la = a.models.part_end - a.models.part_start
    lb = b.models.part_end - b.models.part_start
    assert sorted(la) == sorted(lb)


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_the_bam_reads_back_as_generated(kind, tmp_path):
    from miso_tpu_torch.io.sam import IndexedBamReader

    s = generate.write_sample(sample(kind, 3), str(tmp_path))
    reader = IndexedBamReader(s.bam_path)
    got = [(r.pos, r.cigar_str, r.flag) for r in reader]
    assert len(got) == s.total_reads
    want_pos = s.reads.block_start[:, 0] - 1
    assert [g[0] for g in got] == want_pos.tolist()
    r = 0
    bs, bl = s.reads.block_start, s.reads.block_len
    for pos, cig, _ in got[:500]:
        ops = [bl[r, 0]]
        for b in range(1, bs.shape[1]):
            if bl[r, b]:
                ops += [bs[r, b] - bs[r, b - 1] - bl[r, b - 1], bl[r, b]]
        want = "".join("%d%s" % (v, "M" if i % 2 == 0 else "N")
                       for i, v in enumerate(ops))
        assert cig == want
        r += 1
