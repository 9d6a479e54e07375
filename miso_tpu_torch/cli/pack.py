"""`miso_pack` -- pack raw .miso chromosome dirs into .miso_db SQLite files.
Parity: misopy/miso_pack.py:29-79."""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys


def pack_dir(miso_output_dir: str) -> int:
    from miso_tpu_torch.io import miso_db
    chrom_dirs = [d for d in glob.glob(os.path.join(miso_output_dir, "*"))
                  if miso_db.is_miso_unpacked_dir(d)]
    if not chrom_dirs:
        print("No unpacked MISO directories in %s" % miso_output_dir)
        return 0
    n = 0
    for d in chrom_dirs:
        out = os.path.join(miso_output_dir,
                           "%s%s" % (os.path.basename(d), miso_db.MISO_DB_EXT))
        print("Packing %s -> %s" % (d, out))
        if miso_db.miso_dir_to_db(d, out) is not None:
            shutil.rmtree(d)
            n += 1
    return n


def view_db(db_fname: str) -> int:
    """Print an event-name listing of a .miso_db file
    (misopy/miso_pack.py:102-112)."""
    from miso_tpu_torch.io import miso_db
    db_fname = os.path.abspath(os.path.expanduser(db_fname))
    if not os.path.isfile(db_fname):
        print("Error: %s does not exist." % db_fname, file=sys.stderr)
        return 1
    db = miso_db.MISODatabase(db_fname)
    names = db.get_all_event_names()
    print("Database contains %d events" % len(names))
    for name in names:
        print(name)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="miso_pack")
    p.add_argument("--pack", dest="pack_dir", default=None,
                   help="MISO output directory to pack.")
    p.add_argument("--view", dest="view_db", default=None,
                   help="View a MISO database (.miso_db file).")
    args = p.parse_args(argv)
    if args.pack_dir is None and args.view_db is None:
        print("Need --pack MISO_OUTPUT_DIR or --view FILE.miso_db",
              file=sys.stderr)
        return 1
    if args.pack_dir is not None:
        pack_dir(os.path.abspath(os.path.expanduser(args.pack_dir)))
    if args.view_db is not None:
        return view_db(args.view_db)
    return 0


if __name__ == "__main__":
    sys.exit(main())
