"""`summarize_miso` CLI.  Flag parity: misopy/run_miso.py:441-460."""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="summarize_miso")
    p.add_argument("--summarize-samples", dest="summarize_samples", nargs=2,
                   default=None, metavar=("SAMPLES_DIR", "OUTPUT_DIR"))
    p.add_argument("--summary-label", dest="summary_label", default=None)
    p.add_argument("--use-compressed", dest="use_compressed", default=None)
    args = p.parse_args(argv)
    if args.summarize_samples is None:
        print("Need --summarize-samples SAMPLES_DIR OUTPUT_DIR",
              file=sys.stderr)
        return 1
    from miso_tpu_torch.io.miso_file import summarize_sampler_results
    samples_dir = os.path.abspath(os.path.expanduser(
        args.summarize_samples[0]))
    if not os.path.isdir(samples_dir):
        print("Error: samples directory %s does not exist." % samples_dir,
              file=sys.stderr)
        return 1
    output_dir = os.path.abspath(os.path.expanduser(
        args.summarize_samples[1]))
    label = args.summary_label or os.path.basename(
        os.path.normpath(samples_dir))
    summary_dir = os.path.join(output_dir, "summary")
    os.makedirs(summary_dir, exist_ok=True)
    summary_filename = os.path.join(summary_dir, "%s.miso_summary" % label)
    n = summarize_sampler_results(samples_dir, summary_filename,
                                  use_compressed=args.use_compressed)
    print("  - Summarized a total of %d events." % n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
