"""Wall times of the plain REASSIGN versions on the host's CPU: what
``miso_torch --run --device cpu`` runs in place of the kernels B1
(``reassign_kernel._reassign_plain``) and B3
(``deep._multinomial_plain``), at two isoforms and at a bucket of 512.

    python3 miso_tpu_torch/sampler/plain_times.py [--tree DIR] [--reps N]

``--tree DIR`` imports ``miso_tpu_torch`` from DIR, another checkout of
the repo, so that one script times two trees alike: run it once per
tree.  Each case runs ``run_batch_reassign`` or ``run_batch_multinomial``
on CPU tensors (the plain route) at 60 iterations x 2 chains, seeded;
the last line is a JSON object of the best of ``--reps`` wall times in
milliseconds per case.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

SE_GENE = ([100, 50, 100], [[1, 2, 3], [1, 3]])
SHORT = dict(iters=60, burn_in=20, lag=2, chains=2)


def cases():
    """(name, run) per case, the batches built on the CPU."""
    import numpy as np

    from miso_tpu_torch.sampler import deep
    from miso_tpu_torch.sampler import reassign_kernel as rk
    from miso_tpu_torch.sampler.mcmc import SamplerConfig
    from miso_tpu_torch.testing import (class_batch, deepened, padded_batch,
                                        simulated_event, wide_event)

    cfg = SamplerConfig(**SHORT)
    psi = np.random.default_rng(1).uniform(0.05, 0.95, 16)
    narrow = [simulated_event(*SE_GENE, [p, 1.0 - p], 300, 36, seed=100 + i)
              for i, p in enumerate(psi)]
    wide = [wide_event(num_iso=300, seed=3 + j) for j in range(4)]
    b1_narrow = padded_batch(narrow * 4, "cpu")              # E=64, I=2
    b1_wide = padded_batch(wide, "cpu")                      # E=4, I=512
    b3_narrow = class_batch([deepened(ev, 67) for ev in narrow], "cpu")
    b3_wide = class_batch([deepened(ev, 50) for ev in wide], "cpu")
    for name, batch, run in (
            ("B1 plain E=64 I=2", b1_narrow, rk.run_batch_reassign),
            ("B1 plain E=4 I=512", b1_wide, rk.run_batch_reassign),
            ("B3 plain E=16 I=2", b3_narrow, deep.run_batch_multinomial),
            ("B3 plain E=4 I=512", b3_wide, deep.run_batch_multinomial)):
        yield ("%s (R=%d, C=%d)" % (name, batch.read_w.shape[1],
                                    batch.weights.shape[1]),
               lambda batch=batch, run=run: run(3, batch, cfg))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="checkout to import miso_tpu_torch from")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    # this file's own directory is no place to import the package from
    sys.path[0] = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    import torch

    import miso_tpu_torch

    print("miso_tpu_torch from %s; torch %s, %d threads"
          % (os.path.dirname(miso_tpu_torch.__file__), torch.__version__,
             torch.get_num_threads()))
    out = {}
    for name, run in cases():
        best = float("inf")
        for _ in range(args.reps):
            t = time.perf_counter()
            run()
            best = min(best, 1e3 * (time.perf_counter() - t))
        out[name] = best
        print("  %-40s %10.1f ms" % (name, best))
    print(json.dumps({"plain_cpu_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
