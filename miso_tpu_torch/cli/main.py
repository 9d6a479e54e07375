"""`miso_torch` -- `miso --run` on one GPU through the PyTorch port.

The same flags as ``miso`` (``miso_tpu.cli.main.build_parser``) plus
``--device`` (default ``cuda``; a run that asks for CUDA where there is
none raises).  The port runs every single-device mode of ``miso --run``:
``--paired-end MEAN SD``, ``--algorithm reassign|marginal|classes``,
``--linear-start``, ``--convergent`` (with ``--convergent-growth``),
``--summary-only``, ``--pack-output`` and ``--profile DIR`` (a
``torch.profiler`` Chrome trace).  The multi-host flags raise
NotImplementedError naming the ROADMAP item that will add them.
"""
from __future__ import annotations

import os
import sys

from miso_tpu.cli import main as _miso


def build_parser():
    p = _miso.build_parser()
    p.prog = "miso_torch"
    p.add_argument("--device", default="cuda",
                   help="torch device of the sampler: 'cuda' (the CUDA "
                        "kernel) or 'cpu' (its plain PyTorch version).")
    return p


def main(argv=None) -> int:
    from miso_tpu.io.settings import Settings
    from miso_tpu_torch import __version__
    from miso_tpu_torch.pipeline import (RunConfig, compute_all_genes_psi,
                                         resolve_device)

    args = build_parser().parse_args(argv)
    if args.version:
        print("miso_tpu_torch v%s" % __version__)
        return 0
    if args.view_gene is not None:
        _miso.view_gene(args.view_gene)
        return 0
    if args.compute_genes_psi is None:
        print("Use --run INDEX_DIR READS --output-dir DIR --read-len N",
              file=sys.stderr)
        return 1
    if args.output_dir is None:
        print("Error: need --output-dir.", file=sys.stderr)
        return 1
    if args.read_len is None:
        print("Error: need --read-len.", file=sys.stderr)
        return 1
    if args.coordinator or args.num_hosts:
        raise NotImplementedError("not ported yet: --coordinator/"
                                  "--num-hosts (ROADMAP A.11)")
    device = resolve_device(args.device)

    for path, what in [(args.compute_genes_psi[0], "index directory"),
                       (args.compute_genes_psi[1], "reads file")]:
        p2 = os.path.abspath(os.path.expanduser(path))
        if not os.path.exists(p2):
            print("Error: %s %s does not exist." % (what, p2),
                  file=sys.stderr)
            return 1
    if args.settings_filename is not None and \
            not os.path.isfile(os.path.expanduser(args.settings_filename)):
        print("Error: settings file %s does not exist."
              % args.settings_filename, file=sys.stderr)
        return 1
    settings = Settings.load(args.settings_filename)
    index_dir, reads = args.compute_genes_psi
    # miso_tpu/cli/main.py:158-171
    paired = args.paired_end is not None
    overhang = 1
    if args.overhang_len is not None and not paired:
        overhang = args.overhang_len
    elif args.overhang_len is not None and paired:
        print("Warning: cannot use --overhang-len in paired-end mode. "
              "Using overhang = 1")
    cfg = RunConfig.from_settings(
        settings, args.read_len, overhang_len=overhang,
        algorithm=args.algorithm, paired_end=paired,
        mean_frag_len=args.paired_end[0] if paired else None,
        frag_variance=(args.paired_end[1] ** 2) if paired else None,
        **({"stop": "convergent"} if args.convergent else {}),
        **({"start": "linear"} if args.linear_start else {}),
        summary_only=args.summary_only, pack_output=args.pack_output,
        convergent_growth=args.convergent_growth)
    os.makedirs(args.output_dir, exist_ok=True)
    index_dir = os.path.abspath(os.path.expanduser(index_dir))
    reads = os.path.abspath(os.path.expanduser(reads))
    gene_ids = None
    if args.prefilter:
        from miso_tpu.io.sanity import get_ids_passing_filter
        gene_ids = get_ids_passing_filter(
            index_dir, reads, min_reads=settings.get_min_event_reads())
        print("Prefilter: %d genes pass the coverage filter"
              % len(gene_ids))
    compute_all_genes_psi(
        index_dir, reads, args.read_len,
        os.path.abspath(os.path.expanduser(args.output_dir)),
        cfg=cfg, settings=settings, seed=args.seed, gene_ids=gene_ids,
        device=device, profile_dir=args.profile_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
