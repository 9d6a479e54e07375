"""`miso_zip` -- lossless zip/unzip of MISO output trees.
Parity: misopy/miso_zip.py:25-132 (zip after packing raw directories)."""
from __future__ import annotations

import argparse
import os
import sys
import zipfile


def zip_dir(dir_to_zip: str, output_filename: str) -> None:
    if not output_filename.endswith(".misozip"):
        output_filename += ".misozip"
    from miso_tpu_torch.cli.pack import pack_dir
    pack_dir(dir_to_zip)  # pack raw dirs into .miso_db first
    base = os.path.dirname(os.path.normpath(dir_to_zip))
    # compresslevel 1: ~3-4x faster archiving of multi-GB catalog trees
    # for a few percent larger (still standard, universally readable)
    # zip; the reference used the default level (misopy/miso_zip.py:25)
    with zipfile.ZipFile(output_filename, "w",
                         compression=zipfile.ZIP_DEFLATED,
                         compresslevel=1) as zf:
        for root, _dirs, files in os.walk(dir_to_zip):
            for f in files:
                full = os.path.join(root, f)
                zf.write(full, os.path.relpath(full, base))
    print("Zipped %s -> %s" % (dir_to_zip, output_filename))


def unzip_file(zip_filename: str, output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with zipfile.ZipFile(zip_filename) as zf:
        zf.extractall(output_dir)
    print("Unzipped %s -> %s" % (zip_filename, output_dir))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="miso_zip")
    p.add_argument("--compress", nargs=2, default=None,
                   metavar=("OUTPUT.misozip", "MISO_DIR"))
    p.add_argument("--uncompress", nargs=2, default=None,
                   metavar=("FILE.misozip", "OUTPUT_DIR"))
    args = p.parse_args(argv)
    if args.compress is not None:
        zip_dir(os.path.abspath(args.compress[1]),
                os.path.abspath(args.compress[0]))
        return 0
    if args.uncompress is not None:
        unzip_file(os.path.abspath(args.uncompress[0]),
                   os.path.abspath(args.uncompress[1]))
        return 0
    print("Need --compress or --uncompress", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
