"""`exon_utils` -- constitutive-exon extraction from GFF.

Parity: misopy/exon_utils.py:42-130 (get_const_exons_from_mRNA /
get_const_exons_by_gene + GFF output).  The bedtools `tagBam` wrapper of
the reference is replaced by native interval tagging: pe_utils matches
reads to exons directly and --prefilter uses miso_tpu_torch.io.sanity.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

from miso_tpu_torch.io.gff import GFFDatabase, GFFRecord, write_gff


def get_const_exons_from_mrnas(db: GFFDatabase, mrnas: List[GFFRecord],
                               min_size: int = 0,
                               all_constitutive: bool = False
                               ) -> List[GFFRecord]:
    """Exons of the first mRNA present (same start/end/strand) in every
    other mRNA.  Ref: misopy/exon_utils.py:42-83."""
    const_exons: List[GFFRecord] = []
    if not mrnas:
        return const_exons
    gene_id = mrnas[0].get_parents()[0] if mrnas[0].get_parents() else None
    first_id = mrnas[0].get_id()
    exons = db.exons_by_mrna.get(first_id, [])
    for exon in exons:
        if exon.end - exon.start + 1 < min_size:
            continue
        is_const = True
        if not all_constitutive:
            for mrna in mrnas[1:]:
                others = db.exons_by_mrna.get(mrna.get_id(), [])
                if not any(o.start == exon.start and o.end == exon.end and
                           o.strand == exon.strand for o in others):
                    is_const = False
                    break
        if is_const:
            exon.attributes["GeneParent"] = [gene_id or "NA"]
            const_exons.append(exon)
    return const_exons


def get_const_exons_by_gene(gff_filename: str, output_dir: str,
                            min_size: int = 0,
                            all_constitutive: bool = False,
                            output_filename: str = None) -> str:
    """Extract constitutive exons for every gene into a GFF file.
    Ref: misopy/exon_utils.py:253+."""
    db = GFFDatabase(gff_filename)
    const_exons: List[GFFRecord] = []
    for gene_rec in db.genes:
        gid = gene_rec.get_id()
        mrnas = db.mrnas_by_gene.get(gid, [])
        const_exons.extend(
            get_const_exons_from_mrnas(db, mrnas, min_size=min_size,
                                       all_constitutive=all_constitutive))
    if output_filename is None:
        base = os.path.basename(gff_filename).rsplit(".", 1)[0]
        output_filename = os.path.join(
            output_dir, "%s.min_%d.const_exons.gff" % (base, min_size))
    os.makedirs(output_dir, exist_ok=True)
    write_gff(const_exons, output_filename)
    print("Outputting exons to file: %s" % output_filename)
    print("  - %d constitutive exons" % len(const_exons))
    return output_filename


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="exon_utils")
    p.add_argument("--get-const-exons", dest="gff", default=None,
                   help="GFF file to extract constitutive exons from.")
    p.add_argument("--min-exon-size", dest="min_size", type=int, default=0)
    p.add_argument("--all-constitutive", action="store_true", default=False)
    p.add_argument("--output-dir", dest="output_dir", default=None)
    args = p.parse_args(argv)
    if args.gff is None or args.output_dir is None:
        print("Need --get-const-exons GFF --output-dir DIR", file=sys.stderr)
        return 1
    get_const_exons_by_gene(
        os.path.abspath(os.path.expanduser(args.gff)),
        os.path.abspath(os.path.expanduser(args.output_dir)),
        min_size=args.min_size, all_constitutive=args.all_constitutive)
    return 0


if __name__ == "__main__":
    sys.exit(main())
