"""`sam_to_bam` CLI -- SAM to coordinate-sorted BAM, natively.
Parity: misopy/sam_to_bam.py:8-72 (which shells out to samtools; this
implementation uses the built-in BGZF/BAM encoder)."""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sam_to_bam")
    p.add_argument("--convert", nargs=2, default=None,
                   metavar=("SAM", "OUTPUT_DIR"))
    p.add_argument("--ref", default=None,
                   help="Accepted for compatibility (headerless SAM).")
    args = p.parse_args(argv)
    if args.convert is None:
        print("Need --convert SAM OUTPUT_DIR", file=sys.stderr)
        return 1
    from miso_tpu_torch.io.sam import sam_to_bam
    sam_path = os.path.abspath(os.path.expanduser(args.convert[0]))
    output_dir = os.path.abspath(os.path.expanduser(args.convert[1]))
    os.makedirs(output_dir, exist_ok=True)
    base = os.path.basename(sam_path)
    if base.endswith(".sam"):
        base = base[:-4]
    bam_path = os.path.join(output_dir, base + ".sorted.bam")
    print("Converting %s -> %s" % (sam_path, bam_path))
    sam_to_bam(sam_path, bam_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
