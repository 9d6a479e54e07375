"""`test_miso_torch` -- self-test CLI of the PyTorch port.

Parity: misopy/test_miso.py (the reference ships an end-to-end unittest
pipeline as a console script) and miso_tpu/cli/test_miso.py's inline
check: one simulated 500-read event through ``run_batch_reassign`` on
``--device`` (default ``cuda``: the CUDA kernel; ``cpu``: its plain
version).  The port's test files (``tests/test_torch_*.py``) hold it
against the JAX package and need that package; this command needs the
port alone.
"""
from __future__ import annotations

import argparse
import sys


def smoke(device) -> int:
    """The inline check: posterior mean of a psi = 0.6 event."""
    import numpy as np
    from miso_tpu_torch.core.events import compile_single_end, pad_events
    from miso_tpu_torch.core.gene import make_gene
    from miso_tpu_torch.core.simulate import simulate_reads
    from miso_tpu_torch.pipeline import resolve_device
    from miso_tpu_torch.sampler.mcmc import SamplerConfig, batch_from_numpy
    from miso_tpu_torch.sampler.reassign_kernel import run_batch_reassign

    dev = resolve_device(device)
    g = make_gene([100, 50, 100], [[1, 2, 3], [1, 3]])
    _, pos, cig = simulate_reads(g, [0.6, 0.4], 500, 25,
                                 np.random.default_rng(0))
    ev = compile_single_end(g, pos, cig, read_len=25)
    batch, _ = batch_from_numpy(pad_events([ev]), dev)
    res = run_batch_reassign(
        0, batch, SamplerConfig(iters=500, burn_in=100, lag=5, chains=2))
    mean = float(res.flat_samples()[0][:, 0].mean())
    ok = 0.3 < mean < 0.9
    print("smoke test on %s: posterior mean %.3f -> %s"
          % (dev, mean, "OK" if ok else "FAIL"))
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="test_miso_torch")
    p.add_argument("--device", default="cuda",
                   help="torch device of the inline check: 'cuda' or 'cpu'.")
    args = p.parse_args(argv)
    return smoke(args.device)


if __name__ == "__main__":
    sys.exit(main())
