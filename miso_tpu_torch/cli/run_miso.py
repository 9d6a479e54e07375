"""`run_miso.py` -- worker-level CLI.

Flag parity: misopy/run_miso.py:306-490 (--compute-gene-psi,
--compute-genes-from-file, --summarize-samples, --compare-samples).
In the reference this is the per-batch worker the dispatcher forks; here
it fronts the same batched device pipeline (all listed genes become one
catalog), preserved for workflow compatibility.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="run_miso.py")
    p.add_argument("--compute-gene-psi", dest="compute_gene_psi", nargs=4,
                   default=None,
                   metavar=("GENE_IDS", "INDEXED_GFF", "BAM", "OUTPUT_DIR"))
    p.add_argument("--compute-genes-from-file", dest="genes_file", nargs=3,
                   default=None, metavar=("GENES_FILE", "BAM", "OUTPUT_DIR"))
    p.add_argument("--paired-end", dest="paired_end", nargs=2, type=float,
                   default=None, metavar=("MEAN", "SD"))
    p.add_argument("--read-len", dest="read_len", type=int, default=None)
    p.add_argument("--overhang-len", dest="overhang_len", type=int,
                   default=1)
    p.add_argument("--settings-filename", dest="settings_filename",
                   default=None)
    p.add_argument("--compare-samples", dest="samples_to_compare", nargs=3,
                   default=None)
    p.add_argument("--comparison-labels", dest="comparison_labels", nargs=2,
                   default=None)
    p.add_argument("--summarize-samples", dest="summarize_samples", nargs=2,
                   default=None)
    p.add_argument("--summary-label", dest="summary_label", default=None)
    p.add_argument("--use-compressed", dest="use_compressed", default=None)
    p.add_argument("--event-type", dest="event_type", default=None)
    p.add_argument("--use-cluster", action="store_true", default=False)
    p.add_argument("--chunk-jobs", dest="chunk_jobs", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--view-gene", dest="view_gene", default=None,
                   help="View the contents of an indexed gene/event "
                        "(.pickle filename), as misopy/run_miso.py:391.")
    p.add_argument("--device", default="cuda",
                   help="torch device of the sampler: 'cuda' (the CUDA "
                        "kernels, on every visible card; "
                        "CUDA_VISIBLE_DEVICES or 'cuda:N' restricts "
                        "it) or 'cpu' (their plain PyTorch versions).")
    return p


def _run_genes(gene_entries, bam, output_dir, args):
    """gene_entries: list of (gene_id, indexed pickle path)."""
    import numpy as np
    from miso_tpu_torch.io.index import load_indexed_gene
    from miso_tpu_torch.io.sam import (fetch_bam_reads_in_gene, open_alignments,
                                 sam_parse_reads)
    from miso_tpu_torch.io.settings import Settings
    from miso_tpu_torch.pipeline import (RunConfig, compile_gene_event,
                                   event_output_path, run_events,
                                   write_event_results)

    settings = Settings.load(args.settings_filename)
    paired = args.paired_end is not None
    cfg = RunConfig.from_settings(
        settings, args.read_len,
        overhang_len=args.overhang_len if not paired else 1,
        paired_end=paired,
        mean_frag_len=args.paired_end[0] if paired else None,
        frag_variance=(args.paired_end[1] ** 2) if paired else None)
    alignments = open_alignments(bam)
    events = []
    for gene_id, pickle_path in gene_entries:
        entry = load_indexed_gene(pickle_path)[gene_id]
        gene = entry["gene_object"]
        out_path = event_output_path(output_dir, gene, gene_id)
        if os.path.isfile(out_path):
            print("Output filename %s exists, not running MISO." % out_path)
            continue
        lo, hi = gene.genomic_span()
        raw = fetch_bam_reads_in_gene(alignments, gene.chrom, lo - 1, hi)
        reads, _ = sam_parse_reads(raw, paired_end=cfg.paired_end,
                                   strand_rule=cfg.strand_rule,
                                   target_strand=gene.strand)
        ev = compile_gene_event(gene, gene_id, reads, cfg)
        if ev is not None:
            events.append(ev)
    results = run_events(events, cfg, seed=args.seed, device=args.device)
    written = write_event_results(events, results, output_dir, cfg)
    print("Wrote %d events." % written)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.view_gene is not None:
        from miso_tpu_torch.cli.main import view_gene
        view_gene(args.view_gene)
        return 0
    if args.compute_gene_psi is not None:
        gene_ids, indexed_gff, bam, output_dir = args.compute_gene_psi
        if args.read_len is None:
            print("Error: must provide --read-len.", file=sys.stderr)
            return 1
        entries = [(g, os.path.abspath(os.path.expanduser(indexed_gff)))
                   for g in gene_ids.split(",")]
        os.makedirs(output_dir, exist_ok=True)
        return _run_genes(entries, os.path.abspath(bam),
                          os.path.abspath(output_dir), args)
    if args.genes_file is not None:
        genes_filename, bam, output_dir = args.genes_file
        if args.read_len is None:
            print("Error: must provide --read-len.", file=sys.stderr)
            return 1
        entries = []
        with open(genes_filename) as f:
            for line in f:
                fields = line.strip().split("\t")
                if len(fields) == 2:
                    entries.append((fields[0], fields[1]))
        os.makedirs(output_dir, exist_ok=True)
        return _run_genes(entries, os.path.abspath(bam),
                          os.path.abspath(output_dir), args)
    if args.summarize_samples is not None:
        from miso_tpu_torch.cli.summarize import main as summarize_main
        argv2 = ["--summarize-samples"] + list(args.summarize_samples)
        if args.summary_label:
            argv2 += ["--summary-label", args.summary_label]
        if args.use_compressed:
            argv2 += ["--use-compressed", args.use_compressed]
        return summarize_main(argv2)
    if args.samples_to_compare is not None:
        from miso_tpu_torch.cli.compare import main as compare_main
        argv2 = ["--compare-samples"] + list(args.samples_to_compare)
        if args.comparison_labels:
            argv2 += ["--comparison-labels"] + list(args.comparison_labels)
        if args.use_compressed:
            argv2 += ["--use-compressed", args.use_compressed]
        return compare_main(argv2)
    build_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
