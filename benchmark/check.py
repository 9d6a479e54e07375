"""Whether what the timed jobs wrote is correct.

Every job's summary is read whole; a sample of events drawn from the
seed, with the deepest and the widest gene in it, is read back from the
``.miso`` files and held against the plain reference
(``reference/``), which works out each event's read classes and Ψ
posterior again from the generated reads and gene models.

The numbers, each with a limit of its own (the cell's ``limits``):

- ``missing``: events due (enough reads, two isoforms or more) with no
  summary row or no ``.miso`` file, and rows of events not due;
- ``classes``: sampled events whose read classes and counts, as the
  timed path's host compile handed them to the sampler (``compiled``),
  differ from the reference's: each class's match on every isoform
  (single-end) or fragment length on it (paired-end, where the
  ``.miso`` header prints no more than zeros), or no such event;
- ``header``: sampled events whose read classes and counts, sampler
  settings, sample count, sample rows or assigned counts differ from the
  reference;
- ``summary``: sampled events whose summary mean or interval is not what
  their own ``.miso`` samples give;
- ``psi_gap_sd``: over two-isoform events, the widest gap between an
  event's posterior mean and the exact one, less the output's rounding,
  in posterior sds;
- ``ci_gap_sd``: the same for the 95 % interval's ends;
- ``psi_chain_z``, ``ci_chain_z``: over events of more isoforms, whose
  chains at the configuration's length stay near their start, the same
  gaps against the reference's replica of MISO's chain, in sds of a
  mean (or interval end) over the program's chains.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np

from reference import compat, posterior

MISO_Q = 0.5e-4        # half a unit of a .miso sample's last digit
SUMMARY_Q = 0.5e-2     # half a unit of a summary value's last digit
DEEPEST = 3            # the deepest events are always read back
REPLICA_CHAINS = 48    # chains of the reference's replica of MISO's chain


def retained(cfg: dict) -> int:
    s = cfg["sampler"]
    return ((s["num_iters"] - s["burn_in"]) // s["lag"]) * s["num_chains"]


def ci_indices(n: int):
    """Chen-Shao order-statistic indices of the 95 % interval
    (misopy credible_intervals.py)."""
    return int(round(0.025 * n)) - 1, int(round(0.975 * n)) - 1


def due(sample) -> np.ndarray:
    """Genes a run has to quantify: two isoforms or more and at least
    min_event_reads reads (pairs)."""
    m = sample.models
    n_iso = np.diff(m.iso_off)
    return (n_iso >= 2) & (
        sample.units >= sample.config["sampler"]["min_event_reads"])


def read_summary(out_dir: str) -> Dict[str, List[str]]:
    rows = {}
    sdir = os.path.join(out_dir, "summary")
    for fn in os.listdir(sdir) if os.path.isdir(sdir) else []:
        with open(os.path.join(sdir, fn)) as f:
            f.readline()
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) > 1:
                    rows[parts[0]] = parts
    return rows


def read_miso(path: str):
    """(header fields, samples (S, I)) of a .miso file."""
    with open(path) as f:
        head = f.readline().lstrip("#").rstrip("\n")
        f.readline()
        body = f.read()
    fields = {}
    for part in head.split("\t"):
        k, _, v = part.partition("=")
        fields[k] = v
    lines = body.split("\n")
    lines = [ln for ln in lines if ln]
    psi = np.array([[float(x) for x in ln.split("\t")[0].split(",")]
                    for ln in lines]).reshape(len(lines), -1)
    return fields, psi


def parse_counts(text: str) -> Dict[tuple, int]:
    """``(1,0):43,(1,1):24`` -> {(1, 0): 43, (1, 1): 24}, summing
    classes that print alike."""
    out: Dict[tuple, int] = {}
    for key, n in re.findall(r"\(([^)]*)\):(\d+)", text):
        t = tuple(int(v) for v in key.split(","))
        out[t] = out.get(t, 0) + int(n)
    return out


def assigned_total(text: str) -> int:
    return sum(int(p.split(":")[1]) for p in text.split(",") if p)


def fmt_equal(text: str, value: float) -> bool:
    """``text`` is ``value`` as '%.2f' prints it (a value within 1e-9 of
    a rounding tie may print either way)."""
    if "%.2f" % value == text:
        return True
    frac = abs(value * 100 - np.floor(value * 100) - 0.5)
    return frac < 1e-7 and abs(float(text) - value) <= 0.0051


class Reference:
    """The reference's view of one gene, computed once per run."""

    def __init__(self, sample, g: int, seed: int, algorithm: str,
                 device="cpu", dtype=None, chains: int = REPLICA_CHAINS):
        import torch
        dtype = dtype or torch.float64
        uk, counts = compat.classes(compat.class_keys(sample, g))
        self.classes = compat.class_table(uk, counts)
        self.header = compat.header_classes(sample, uk, counts)
        b, n, a = posterior.class_terms(sample, g, uk, counts, algorithm)
        self.matched = int(n.sum())
        self.num_iso = sample.models.num_iso(g)
        self.exact = self.num_iso == 2
        if self.exact:
            self.post = posterior.grid_posterior(b, n, a, dtype=dtype)
        else:
            self.post = posterior.miso_chains(
                b, n, a, seed, sample.config["sampler"], device=device,
                dtype=dtype, chains=chains)

    def quantile(self, q: float, iso: int) -> float:
        if self.exact:
            return posterior.grid_quantile(self.post, q, iso)
        return float(np.quantile(self.post["records"][:, :, iso], q))

    def chain_quantile_sd(self, q: float, iso: int) -> float:
        return float(np.quantile(self.post["records"][:, :, iso], q,
                                 axis=1).std(ddof=1))


def algorithm(cell: dict) -> str:
    return cell.get("run", {}).get(
        "algorithm", cell["config_data"]["sampler"]["algorithm"]
        if "config_data" in cell else "reassign")


def pick_events(sample, seed: int, n_events: int, n_jobs: int):
    """(job, gene) pairs to read back: the deepest genes, the widest, and
    the rest drawn from the seed among the genes due."""
    from generate import rng_for
    rng = rng_for(seed, 0xC4EC)
    cand = np.flatnonzero(due(sample))
    if len(cand) == 0:
        return []
    n_iso = np.diff(sample.models.iso_off)
    deep = cand[np.argsort(sample.units[cand], kind="stable")[::-1]]
    chosen = [int(g) for g in deep[:DEEPEST]] + [
        int(cand[np.argmax(n_iso[cand])])]
    rest = rng.permutation(cand)
    chosen += [int(g) for g in rest if int(g) not in chosen]
    chosen = list(dict.fromkeys(chosen))[:n_events]
    return [(int(rng.integers(n_jobs)), g) for g in chosen]


def gaps(ref: Reference, mean_prog: np.ndarray, ci_prog, q_mean: float,
         q_ci: float, n_samples: int, prog_chains: int):
    """(psi gap, ci gap) of one event.  Two isoforms: in sds of the exact
    posterior.  More: in sds of a mean over the program's chains, from
    the spread of the replica's chains (floored at the output's 1e-4)."""
    isos = [0] if ref.num_iso == 2 else range(ref.num_iso)
    lo_i, hi_i = ci_indices(n_samples)
    psi_gap = ci_gap = -np.inf
    if not ref.exact:
        K = ref.post["records"].shape[0]
        spread = np.sqrt(1.0 / prog_chains + 1.0 / K)
    for j in isos:
        if ref.exact:
            sd = sd_q = max(float(ref.post["sd"][j]), 1e-12)
        else:
            sd = max(float(ref.post["chain_sd"][j]) * spread, 1e-4)
        psi_gap = max(psi_gap, (abs(mean_prog[j] - ref.post["mean"][j])
                                - q_mean) / sd)
        for ci_val, idx in zip(ci_prog[j], (lo_i, hi_i)):
            q = (idx + 1) / n_samples
            if not ref.exact:
                sd_q = max(ref.chain_quantile_sd(q, j) * spread, 1e-4)
            ci_gap = max(ci_gap, (abs(ci_val - ref.quantile(q, j)) - q_ci)
                         / sd_q)
    return psi_gap, ci_gap


def check(sample, jobs: List[dict], cell: dict, seed: int,
          device="cpu", reference_dtype=None, log=None,
          compiled=None) -> Dict[str, float]:
    """The numbers above for ``jobs`` (each {'out_dir': ...}) of one run;
    ``compiled`` maps (job, event name) to the classes the run's compile
    made ((C, I) keys, (C,) counts)."""
    cfg = sample.config
    names = np.array(sample.models.name)
    want = set(names[due(sample)].tolist())
    summary_only = cell["run"].get("summary_only", False)
    S = retained(cfg)
    numbers = {"missing": 0, "classes": 0, "header": 0, "summary": 0,
               "psi_gap_sd": -np.inf, "ci_gap_sd": -np.inf,
               "psi_chain_z": -np.inf, "ci_chain_z": -np.inf}
    rows = []
    for job in jobs:
        got = read_summary(job["out_dir"])
        rows.append(got)
        numbers["missing"] += len(want - set(got)) + len(set(got) - want)
        if not summary_only:
            have = set()
            for d in os.listdir(job["out_dir"]):
                p = os.path.join(job["out_dir"], d)
                if d not in ("summary", "logs") and os.path.isdir(p):
                    have.update(f[:-5] for f in os.listdir(p)
                                if f.endswith(".miso"))
            numbers["missing"] += len(want - have)
    refs: Dict[int, Reference] = {}
    worst: Dict[str, str] = {}
    picks = pick_events(sample, seed, cell["check"]["events"], len(jobs))
    from generate import CHROMS
    for job_i, g in picks:
        name = str(names[g])
        row = rows[job_i].get(name)
        if row is None:
            continue            # counted under missing
        if g not in refs:
            refs[g] = Reference(sample, g, seed + g, algorithm(cell),
                                device=device, dtype=reference_dtype)
        ref = refs[g]
        I = ref.num_iso
        got = (compiled or {}).get((job_i, name))
        if got is None or compat.class_table(*got) != ref.classes:
            numbers["classes"] += 1
        bad = parse_counts(row[5]) != ref.header or (
            assigned_total(row[6]) != ref.matched)
        if summary_only:
            vals = [np.array([float(v) for v in row[k].split(",")])
                    for k in (1, 2, 3)]
            if I == 2:
                vals = [np.array([v[0], 1 - v[0]]) for v in vals]
            mean_p, ci_p = vals[0], list(zip(vals[1], vals[2]))
            qm = qc = SUMMARY_Q
        else:
            path = os.path.join(jobs[job_i]["out_dir"],
                                CHROMS[sample.models.chrom[g]],
                                name + ".miso")
            if not os.path.isfile(path):
                continue        # counted under missing
            head, psi = read_miso(path)
            s = cfg["sampler"]
            bad = bad or parse_counts(head.get("counts", "")) != ref.header
            bad = bad or assigned_total(
                head.get("assigned_counts", "")) != ref.matched
            bad = bad or (head.get("iters"), head.get("burn_in"),
                          head.get("lag")) != tuple(
                str(s[k]) for k in ("num_iters", "burn_in", "lag"))
            bad = bad or psi.shape != (S, I) or np.abs(
                psi.sum(1) - 1).max() > I * MISO_Q + 1e-9
            if psi.shape != (S, I):
                numbers["header"] += 1
                continue
            mean_p = psi.mean(0)
            srt = np.sort(psi, 0)
            lo_i, hi_i = ci_indices(S)
            ci_p = list(zip(srt[lo_i], srt[hi_i]))
            qm = qc = MISO_Q
            # the summary row from the samples, as summarize_miso does
            cols = [0] if I == 2 else list(range(I))
            want_txt = [mean_p[cols], srt[lo_i, cols], srt[hi_i, cols]]
            got_txt = [row[k].split(",") for k in (1, 2, 3)]
            if any(len(a) != len(b) or not all(
                    fmt_equal(t, v) for t, v in zip(a, b))
                    for a, b in zip(got_txt, want_txt)):
                numbers["summary"] += 1
        numbers["header"] += int(bad)
        pg, cg = gaps(ref, mean_p, ci_p, qm, qc, S,
                      cfg["sampler"]["num_chains"])
        keys = (("psi_gap_sd", "ci_gap_sd") if ref.exact
                else ("psi_chain_z", "ci_chain_z"))
        for key, v in zip(keys, (pg, cg)):
            if v > numbers[key]:
                numbers[key] = v
                worst[key] = "%s (%d isoforms, %d reads)" % (
                    name, I, ref.matched)
    gap_keys = ("psi_gap_sd", "ci_gap_sd", "psi_chain_z", "ci_chain_z")
    if not worst:
        for k in gap_keys:          # nothing read back: not correct
            numbers[k] = float("inf")
    for k in gap_keys:              # no event of this kind: no gap
        numbers[k] = max(numbers[k], 0.0)
    if log is not None:
        for k, v in worst.items():
            print("widest %s at %s" % (k, v), file=log)
    return numbers


def within(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers.get(k, -np.inf) <= limits[k] for k in limits)
