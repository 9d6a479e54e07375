#!/usr/bin/env python3
"""The control of a cell's correctness check: the plain reference, put in
the program's place and computed one precision below the configuration's
(bfloat16 for its float32), judged by the same numbers as a run.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's sample at the cell's size, reads back
the events a run on that seed would (``check.pick_events``) and prints
one JSON line: the widest gaps, in reference sds, between the bfloat16
posterior and the float64 one, beside the cell's limits.  A control that
stays within the limits shows a check that could not tell the precision
down from the reference.  The benchmark's own runs never run it.
"""
import argparse
import json
import sys

def control_numbers(cell: dict, seed: int, device: str = "cpu") -> dict:
    """The control's readings of the gaps on one seed (the exact numbers
    read 0: the control writes what the reference works out)."""
    import numpy as np
    import torch

    import check
    import generate

    sample = generate.make_sample(cell["config_data"], cell, seed)
    S = check.retained(sample.config)
    lo_i, hi_i = check.ci_indices(S)
    out = {"missing": 0, "classes": 0, "header": 0, "summary": 0}
    K = sample.config["sampler"]["num_chains"]
    for _, g in check.pick_events(sample, seed, cell["check"]["events"], 1):
        algo = check.algorithm(cell)
        ref = check.Reference(sample, g, seed + g, algo, device=device)
        low = check.Reference(sample, g, seed + g + 1, algo, device=device,
                              dtype=torch.bfloat16, chains=K)
        cols = range(low.num_iso)
        mean = np.asarray(low.post["mean"], np.float64)
        ci = [(low.quantile((lo_i + 1) / S, j),
               low.quantile((hi_i + 1) / S, j)) for j in cols]
        pg, cg = check.gaps(ref, mean, ci, check.MISO_Q, check.MISO_Q, S, K)
        keys = (("psi_gap_sd", "ci_gap_sd") if ref.exact
                else ("psi_chain_z", "ci_chain_z"))
        for k, v in zip(keys, (pg, cg)):
            out[k] = max(out.get(k, -np.inf), float(v))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    import check
    import run
    cell = run.load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        nums = control_numbers(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": device, "control": nums,
                          "limits": cell["limits"],
                          "fails": not check.within(nums, cell["limits"])}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
