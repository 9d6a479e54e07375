"""Indexed annotation store: per-gene pickles by chromosome + shelve maps.

Directory-layout parity with misopy/index_gff.py:29-130:

  index_dir/
    chrN/<gene_id or compressed_id>.pickle   one dict {gene_id: {...}} each
    genes_to_filenames.shelve                gene id -> pickle path
    compressed_ids_to_genes.shelve           hash -> gene id (--compress-id)
    genes.gff                                gene records only
"""
from __future__ import annotations

import glob
import os
import pickle
import shelve
import time
from typing import Dict, Optional

from miso_tpu_torch.core.gene import Gene
from miso_tpu_torch.io.gff import (GFFDatabase, compress_event_name,
                             load_genes_from_gff, make_gene_from_records)


def index_gff(gff_filename: str, output_dir: str,
              compress_id: bool = False) -> bool:
    """Build the index; aborts (returns False) if already indexed
    (misopy/index_gff.py:143-147)."""
    if glob.glob(os.path.join(output_dir, "chr*")):
        print("%s appears to already be indexed. Aborting." % gff_filename)
        return False
    os.makedirs(output_dir, exist_ok=True)
    t1 = time.time()
    genes = load_genes_from_gff(gff_filename)
    print("  - Loaded %d genes from GFF (%.2fs)" % (len(genes), time.time() - t1))

    gene_id_to_filename: Dict[str, str] = {}
    compressed_to_gene: Dict[str, str] = {}
    chrom_batches: Dict[str, dict] = {}
    for gene_id, gene in genes.items():
        chrom = gene.chrom or "NA"
        chrom_dir_name = chrom if chrom.startswith("chr") else "chr%s" % chrom
        chrom_dir = os.path.join(output_dir, chrom_dir_name)
        os.makedirs(chrom_dir, exist_ok=True)
        # NOTE: per-gene caches (flat_exons etc.) are deliberately NOT
        # warmed before pickling -- unpickling many tiny numpy arrays
        # costs more than rebuilding them at compile time (measured)
        entry = {"gene_object": gene, "hierarchy": None}
        if compress_id:
            cid = compress_event_name(gene_id)
            compressed_to_gene[cid] = gene_id
            entry["compressed_id"] = cid
            fname = os.path.abspath(os.path.join(chrom_dir, "%s.pickle" % cid))
        else:
            fname = os.path.abspath(os.path.join(chrom_dir, "%s.pickle" % gene_id))
        with open(fname, "wb") as f:
            pickle.dump({gene_id: entry}, f, protocol=pickle.HIGHEST_PROTOCOL)
        gene_id_to_filename[gene_id] = fname
        chrom_batches.setdefault(chrom_dir, {})[gene_id] = entry

    # one batch pickle per chromosome dir: catalog-scale runs load each
    # chromosome's genes in ONE unpickle instead of thousands (the
    # per-gene pickles above stay -- they are the reference layout that
    # summarize/sashimi tools address directly, index_gff.py:78-99)
    for chrom_dir, batch in chrom_batches.items():
        with open(os.path.join(chrom_dir, _BATCH_NAME), "wb") as f:
            pickle.dump(batch, f, protocol=pickle.HIGHEST_PROTOCOL)
        tables = build_compile_tables(batch)
        with open(os.path.join(chrom_dir, _TABLES_NAME), "wb") as f:
            pickle.dump(tables, f, protocol=pickle.HIGHEST_PROTOCOL)

    with shelve.open(os.path.join(output_dir, "genes_to_filenames.shelve")) as sh:
        for k, v in gene_id_to_filename.items():
            sh[k] = v
    with shelve.open(os.path.join(output_dir,
                                  "compressed_ids_to_genes.shelve")) as sh:
        for k, v in compressed_to_gene.items():
            sh[k] = v

    # genes.gff: pass through gene records only (index_gff.py:120-130)
    genes_filename = os.path.join(output_dir, "genes.gff")
    with open(gff_filename) as gff_in, open(genes_filename, "w") as gff_out:
        for line in gff_in:
            if line.startswith("#"):
                continue
            fields = line.strip().split("\t")
            if len(fields) > 2 and fields[2] == "gene":
                gff_out.write(line)
    return True


def get_gene_ids_to_filenames(index_dir: str) -> Dict[str, str]:
    """gene id -> pickle filename map (gff_utils.py:89 semantics)."""
    path = os.path.join(index_dir, "genes_to_filenames.shelve")
    out: Dict[str, str] = {}
    with shelve.open(path, flag="r") as sh:
        for k in sh.keys():
            out[k] = sh[k]
    return out


def load_compressed_ids_to_genes(index_dir_or_file: str) -> Dict[str, str]:
    path = index_dir_or_file
    if os.path.isdir(path):
        path = os.path.join(path, "compressed_ids_to_genes.shelve")
    out: Dict[str, str] = {}
    with shelve.open(path, flag="r") as sh:
        for k in sh.keys():
            out[k] = sh[k]
    return out


class _IndexUnpickler(pickle.Unpickler):
    """Reads an index written by either package: a class pickled under
    the JAX package's name resolves to this package's copy of it, so an
    existing index needs no re-indexing and no import of that package."""

    def find_class(self, module, name):
        if module == "miso_tpu" or module.startswith("miso_tpu."):
            module = "miso_tpu_torch" + module[len("miso_tpu"):]
        return super().find_class(module, name)


def load_indexed_gene(pickle_filename: str) -> Dict[str, dict]:
    """Load one per-gene pickle ({gene_id: {'gene_object': Gene, ...}})."""
    with open(pickle_filename, "rb") as f:
        return _IndexUnpickler(f).load()


_BATCH_NAME = "_chrom_batch.pickle"
_TABLES_NAME = "_compile_tables.pickle"
_batch_cache: Dict[str, tuple] = {}


def _load_cached_pickle(chrom_dir: str, name: str):
    path = os.path.join(chrom_dir, name)
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    hit = _batch_cache.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    with open(path, "rb") as f:
        obj = _IndexUnpickler(f).load()
    # bound memory: keep at most ~2 chromosomes' worth (batch + tables)
    while len(_batch_cache) >= 4:
        _batch_cache.pop(next(iter(_batch_cache)))
    _batch_cache[path] = (mtime, obj)
    return obj


def load_chrom_batch(chrom_dir: str) -> Optional[Dict[str, dict]]:
    """The chromosome dir's batch pickle ({gene_id: entry}), or None if
    the index predates batch pickles.  Cached by (path, mtime) so the
    catalog walk and the compile producer share one unpickle."""
    return _load_cached_pickle(chrom_dir, _BATCH_NAME)


def load_compile_tables(chrom_dir: str) -> Optional[dict]:
    """The chromosome dir's precomputed compile tables, or None if the
    index predates them (older indexes still work via the per-gene
    path)."""
    return _load_cached_pickle(chrom_dir, _TABLES_NAME)


def build_compile_tables(batch: Dict[str, dict]) -> dict:
    """Whole-chromosome columnar compile tables from a batch of indexed
    genes: everything the batch event compiler
    (core/events.compile_single_end_many) needs, as a handful of flat
    arrays instead of 10^4 Python gene traversals per run --
    row[gene_id] indexes every per-gene array.

      span (n, 2)       genomic span (1-based inclusive)
      noiso (n,)        isoform count
      gidx (n,)         offset of the gene's exon_idx block (noiso+1
                        GLOBAL entries) in exon_idx
      iso_ofs (n,)      offset of the gene's isoforms in iso_lengths /
                        iso_num_exons
      exon_starts/ends  flat exon tables across all genes
    """
    import numpy as np

    row: Dict[str, int] = {}
    span_l, noiso_l, gidx_l, iso_ofs_l = [], [], [], []
    starts_l, ends_l, idx_l = [], [], []
    ilen_l, inex_l = [], []
    exon_base = row_base = iso_base = 0
    for g, (gene_id, entry) in enumerate(batch.items()):
        gene = entry["gene_object"]
        row[gene_id] = g
        s, e, idx = gene.flat_exons()
        span_l.append(gene.genomic_span())
        noiso_l.append(gene.num_isoforms)
        gidx_l.append(row_base)
        iso_ofs_l.append(iso_base)
        starts_l.append(s)
        ends_l.append(e)
        idx_l.append(idx + exon_base)
        ilen_l.append(gene.iso_lengths)
        inex_l.append(gene.iso_num_exons_all)
        exon_base += len(s)
        row_base += len(idx)
        iso_base += gene.num_isoforms
    z = np.zeros(0, np.int64)
    return {
        "row": row,
        "span": np.asarray(span_l, np.int64).reshape(-1, 2),
        "noiso": np.asarray(noiso_l, np.int64),
        "gidx": np.asarray(gidx_l, np.int64),
        "iso_ofs": np.asarray(iso_ofs_l, np.int64),
        "exon_starts": np.concatenate(starts_l) if starts_l else z,
        "exon_ends": np.concatenate(ends_l) if ends_l else z,
        "exon_idx": np.concatenate(idx_l) if idx_l else z,
        "iso_lengths": np.concatenate(ilen_l) if ilen_l else z,
        "iso_num_exons": np.concatenate(inex_l) if inex_l else z,
    }
