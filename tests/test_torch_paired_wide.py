"""Paired-end genes of more than 62 isoforms through the native batch
compile.

The paired matcher keys a read class by its per-isoform fragment-length
vector, not by an isoform bitmask, so ``compile_paired_end_many`` takes a
chromosome whose genes have any number of isoforms in one native call.
Its events must equal, to the last bit, the per-gene
``compile_paired_end`` on the same ``ChromPairs`` slice and the JAX
package's per-gene compile of the same genes; and a paired
``_CompileStream`` over such a catalog must compile no gene one at a
time, emitting the events it emitted when every gene went one at a time.
"""
import dataclasses
import itertools
import os

import numpy as np
import pytest

from miso_tpu.core import events as jev
from miso_tpu.core.gene import make_gene as jmake_gene
from miso_tpu.io import sam as jsam
from miso_tpu_torch import _host, native
from miso_tpu_torch.core import events as tev
from miso_tpu_torch.core.gene import make_gene
from miso_tpu_torch.core.simulate import simulate_paired_reads
from miso_tpu_torch.io import sam as sam_io
from miso_tpu_torch.io.gff import GFFRecord, write_gff
from miso_tpu_torch.io.index import get_gene_ids_to_filenames, index_gff
from miso_tpu_torch.io.sam import AlignedRead, write_bam
from miso_tpu_torch.testing import cap_test_threads

cap_test_threads()

CHROM = "chr1"
READ_LEN, MEAN_FRAG, FRAG_VAR = 40, 250.0, 225.0
MIN_READS = 20
# isoforms per gene along the chromosome: narrow genes between three
# past the single-end matcher's 62
WIDTHS = [2, 63, 3, 64, 2, 130, 4]
KW = dict(read_len=READ_LEN, mean_frag_len=MEAN_FRAG,
          frag_variance=FRAG_VAR, num_sds=4.0)


def _gene_shape(width):
    """(exon lengths, 1-based isoforms): outer exons of 300 nt around 12
    cassette exons; isoform k keeps a distinct set of one to three of
    them (12 + 66 + 220 sets)."""
    lens = [300] + [60 + 7 * j for j in range(12)] + [300]
    sets = [c for r in (1, 2, 3)
            for c in itertools.combinations(range(2, 14), r)]
    if width <= 4:
        sets = [(2,), (3, 5), (4, 7, 9), (6,)]
    return lens, [[1] + list(s) + [14] for s in sets[:width]]


def _gff_records(genes):
    records = []
    for gene in genes:
        gid = gene.label
        lo, hi = gene.genomic_span()
        records.append(GFFRecord(CHROM, "sim", "gene", lo, hi, None, "+",
                                 None, {"ID": [gid]}))
        for iso in gene.isoforms:
            iid = "%s.%s" % (gid, iso.label)
            records.append(GFFRecord(CHROM, "sim", "mRNA", lo, hi, None,
                                     "+", None,
                                     {"ID": [iid], "Parent": [gid]}))
            for pi in iso.parts:
                p = gene.parts[pi]
                records.append(GFFRecord(
                    CHROM, "sim", "exon", p.start, p.end, None, "+", None,
                    {"ID": ["%s.%s" % (iid, p.label)], "Parent": [iid]}))
    return records


@pytest.fixture(scope="module")
def wide_chrom(tmp_path_factory):
    """One chromosome of WIDTHS genes, its BAM, its index and both
    packages' scans of it."""
    root = tmp_path_factory.mktemp("paired_wide")
    rng = np.random.default_rng(19)
    genes, jgenes, reads = [], [], []
    for e, width in enumerate(WIDTHS):
        lens, isos = _gene_shape(width)
        kw = dict(chrom=CHROM, strand="+", label="g%d" % e,
                  offset=1 + e * 5000)
        gene = make_gene(lens, isos, **kw)
        genes.append(gene)
        jgenes.append(jmake_gene(lens, isos, **kw))
        psi = rng.dirichlet(np.ones(width))
        _, pos, cig = simulate_paired_reads(gene, psi, 400, READ_LEN,
                                            MEAN_FRAG, FRAG_VAR, rng=rng)
        for r in range(len(pos)):
            flag = 0x1 | 0x2 | (0x40 | 0x20 if r % 2 == 0
                                else 0x80 | 0x10)
            reads.append(AlignedRead(
                qname="g%d_p%d" % (e, r // 2), flag=flag, rname=CHROM,
                pos=int(pos[r]) - 1, mapq=255, cigar_str=cig[r],
                rlen=READ_LEN))
    reads.sort(key=lambda r: r.pos)
    bam = str(root / "wide.bam")
    write_bam(bam, [CHROM], [5000 * len(WIDTHS) + 1000], reads)
    gff = str(root / "wide.gff")
    write_gff(_gff_records(genes), gff)
    index = str(root / "index")
    index_gff(gff, index)
    scan = sam_io.open_alignments(bam).scan_chrom_columnar_paired(CHROM)
    jscan = jsam.open_alignments(bam).scan_chrom_columnar_paired(CHROM)
    assert scan is not None and jscan is not None
    assert native.load() is not None
    batch = tev.compile_paired_end_many(
        genes, [g.label for g in genes], scan, min_event_reads=MIN_READS,
        **KW)
    return dict(genes=genes, jgenes=jgenes, scan=scan, jscan=jscan,
                batch=batch, bam=bam, index=index, root=root)


def _assert_same_event(a, b, what):
    """Every field but the gene, bit for bit, and the counts= field."""
    def same(va, vb, where):
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, where
            np.testing.assert_array_equal(va, vb, err_msg=where)
        elif dataclasses.is_dataclass(va):
            for f in dataclasses.fields(va):
                same(getattr(va, f.name), getattr(vb, f.name),
                     "%s.%s" % (where, f.name))
        else:
            assert va == vb, where

    for f in dataclasses.fields(a):
        if f.name != "gene":
            same(getattr(a, f.name), getattr(b, f.name),
                 "%s.%s" % (what, f.name))
    assert a.counts_str() == b.counts_str(), what


def test_batch_compile_takes_a_chromosome_with_wide_genes(wide_chrom):
    batch = wide_chrom["batch"]
    assert batch is not None and len(batch) == len(WIDTHS)
    assert all(ev is not None for ev in batch)
    assert [ev.num_iso for ev in batch] == WIDTHS


@pytest.mark.parametrize("width", sorted(set(WIDTHS)))
def test_wide_gene_equals_per_gene_compile_of_both_packages(wide_chrom,
                                                            width):
    genes, scan, jscan = (wide_chrom["genes"], wide_chrom["scan"],
                          wide_chrom["jscan"])
    checked = 0
    for g, (gene, jgene, got) in enumerate(zip(
            genes, wide_chrom["jgenes"], wide_chrom["batch"])):
        if WIDTHS[g] != width:
            continue
        lo, hi = gene.genomic_span()
        pos, cig, npairs = scan.slice(lo - 1, hi)
        assert npairs >= MIN_READS and got.num_reads == npairs
        want = tev.compile_paired_end(gene, np.asarray(pos) + 1, list(cig),
                                      name=gene.label, **KW)
        _assert_same_event(got, want, gene.label)
        jpos, jcig, jnpairs = jscan.slice(lo - 1, hi)
        assert jnpairs == npairs
        jwant = jev.compile_paired_end(jgene, np.asarray(jpos) + 1,
                                       list(jcig), name=jgene.label, **KW)
        _assert_same_event(got, jwant, gene.label)
        checked += 1
    assert checked == WIDTHS.count(width)


def _stream_events(wide_chrom, monkeypatch, batch_path):
    """(events emitted, compile_one calls) of a paired _CompileStream
    over the chromosome's index; without the batch path every gene goes
    to compile_one, as a chromosome with a wide gene did before the
    paired matcher took any width."""
    if not batch_path:
        monkeypatch.setattr(native, "match_classes_paired_multi",
                            lambda *a, **k: None)
    calls = []
    one = _host._CompileStream.compile_one

    def counted(self, gene, out_name):
        calls.append(out_name)
        return one(self, gene, out_name)

    monkeypatch.setattr(_host._CompileStream, "compile_one", counted)
    ids = get_gene_ids_to_filenames(wide_chrom["index"])
    items = sorted(ids.items(), key=lambda kv: (kv[1], kv[0]))
    cfg = _host.RunConfig(read_len=READ_LEN, paired_end=True,
                          mean_frag_len=MEAN_FRAG, frag_variance=FRAG_VAR,
                          min_event_reads=MIN_READS)
    out = str(wide_chrom["root"] / ("out_%d" % batch_path))
    os.makedirs(out, exist_ok=True)
    emitted = []
    stream = _host._CompileStream(
        items, sam_io.open_alignments(wide_chrom["bam"]), cfg, out,
        verbose=False, emit=emitted.append)
    stream.run()
    monkeypatch.undo()
    return emitted, calls


def test_paired_stream_sends_no_wide_chromosome_gene_by_gene(
        wide_chrom, monkeypatch):
    got, calls = _stream_events(wide_chrom, monkeypatch, batch_path=True)
    assert calls == []
    assert sorted(ev.num_iso for ev in got) == sorted(WIDTHS)
    want, calls = _stream_events(wide_chrom, monkeypatch, batch_path=False)
    assert len(calls) == len(WIDTHS)
    assert [ev.name for ev in got] == [ev.name for ev in want]
    for a, b in zip(got, want):
        _assert_same_event(a, b, a.name)
