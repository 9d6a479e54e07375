"""Two-sample differential comparison -> `.miso_bf` output.

Format parity: misopy/hypothesis_test.py:182-345
(output_samples_comparison): 18 header fields, 2-decimal quantization,
`<label1>_vs_<label2>/bayes-factors/<label1>_vs_<label2>.miso_bf` layout.
"""
from __future__ import annotations

import os
from decimal import Decimal
from typing import List, Optional, Tuple

import numpy as np

from miso_tpu_torch.io.miso_file import (MISOSamples, get_gene_info_from_params,
                                   get_isoforms_from_header)
from miso_tpu_torch.stats.bayes import compute_bayes_factors
from miso_tpu_torch.stats.intervals import format_credible_intervals

BF_HEADER_FIELDS = [
    "event_name",
    "sample1_posterior_mean", "sample1_ci_low", "sample1_ci_high",
    "sample2_posterior_mean", "sample2_ci_low", "sample2_ci_high",
    "diff", "bayes_factor", "isoforms",
    "sample1_counts", "sample1_assigned_counts",
    "sample2_counts", "sample2_assigned_counts",
    "chrom", "strand", "mRNA_starts", "mRNA_ends",
]


def output_samples_comparison(
    sample1_dir: str,
    sample2_dir: str,
    output_dir: str,
    alpha: float = 0.95,
    sample_labels: Optional[Tuple[str, str]] = None,
    use_compressed: Optional[str] = None,
) -> str:
    """Compare two MISO output directories; returns the .miso_bf path."""
    sample1_obj = MISOSamples(sample1_dir, use_compressed=use_compressed)
    sample2_obj = MISOSamples(sample2_dir, use_compressed=use_compressed)
    if sample_labels is None:
        sample1_label = os.path.basename(os.path.normpath(sample1_dir))
        sample2_label = os.path.basename(os.path.normpath(sample2_dir))
    else:
        sample1_label, sample2_label = sample_labels
    pair = "%s_vs_%s" % (sample1_label, sample2_label)
    bf_output_dir = os.path.join(output_dir, pair, "bayes-factors")
    os.makedirs(bf_output_dir, exist_ok=True)
    output_filename = os.path.join(bf_output_dir, "%s.miso_bf" % pair)

    # chunked, parallel-loaded, batch-computed: the per-event scalar
    # loop (load two .miso files, fit per-isoform scalar KDEs) was the
    # reference's shape (hypothesis_test.py:182-345) and bound
    # catalog-scale comparisons by the text parse; here a thread pool
    # overlaps the file loads and each chunk's KDE/CI/mean statistics
    # compute in one numpy pass over stacked (E, N, I) tensors.
    from concurrent.futures import ThreadPoolExecutor

    num_compared = 0
    names = sample1_obj.all_event_names
    # 256-event chunks + one loader per core measured fastest on a
    # 2-core host (finer chunks pipeline loads/stats better; extra
    # workers thrash)
    CHUNK = 256
    workers = max(2, min(4, os.cpu_count() or 4))
    chunks = [names[lo:lo + CHUNK] for lo in range(0, len(names), CHUNK)]
    with open(output_filename, "w") as out, \
            ThreadPoolExecutor(max_workers=workers) as pool:
        out.write("\t".join(BF_HEADER_FIELDS) + "\n")

        B = 32  # events per load future (per-event futures cost ~80us
        #         of executor overhead each at catalog scale)

        def load_batch(obj, sub):
            return [obj.get_event_samples(nm) for nm in sub]

        def submit(sub):
            fs = []
            for lo in range(0, len(sub), B):
                fs.append(pool.submit(load_batch, sample1_obj,
                                      sub[lo:lo + B]))
                fs.append(pool.submit(load_batch, sample2_obj,
                                      sub[lo:lo + B]))
            return fs

        # double-buffered: chunk k+1's file loads (GIL-released native
        # parse on the pool) overlap chunk k's batch statistics (numpy
        # on this thread) -- serialized they each idle a core
        pending = submit(chunks[0]) if chunks else None
        for i, sub in enumerate(chunks):
            cur = pending
            pending = submit(chunks[i + 1]) if i + 1 < len(chunks) \
                else None
            res = [f.result() for f in cur]
            s1s = [x for j in range(0, len(res), 2) for x in res[j]]
            s2s = [x for j in range(1, len(res), 2) for x in res[j]]
            for fields in _comparison_rows(sub, s1s, s2s, alpha):
                num_compared += 1
                out.write("\t".join(fields) + "\n")
    print("Compared a total of %d events." % num_compared)
    return output_filename


def _batch_ci(stack: np.ndarray, alpha: float):
    """Chen-Shao order-statistic bounds for stacked samples (E, N, I)
    -> (lo (E, I), hi (E, I)).  Same index arithmetic (and the same
    loud small-n error) as stats/intervals.py."""
    from miso_tpu_torch.stats.intervals import ci_bound_indices

    n = stack.shape[1]
    bounds = ci_bound_indices(n, alpha)
    if bounds is None:
        raise ValueError("Too few samples for credible interval (n=%d)" % n)
    lo, hi = bounds
    # np.partition places EXACTLY the sorted-order elements at the two
    # requested indices (identical values to a full sort) in O(n)
    srt = np.partition(stack, (lo, hi), axis=1)
    return srt[:, lo, :], srt[:, hi, :]


def _comparison_rows(names, s1s, s2s, alpha: float):
    """Comparison rows for one chunk, in input order.  Events sharing
    (N1, N2, I) shapes batch through one numpy/KDE pass; odd shapes
    (truncated files, isoform-count mismatches) fall back to the
    scalar path, whose output the batch path matches byte-for-byte
    (tests/test_differential.py)."""
    from miso_tpu_torch.stats.bayes import batch_bayes_factors

    groups: dict = {}
    rows: dict = {}
    for j, (nm, s1, s2) in enumerate(zip(names, s1s, s2s)):
        if s1 is None or s2 is None:
            continue
        if (s1.samples.shape[1] != s2.samples.shape[1]
                or s1.samples.shape[0] < 2 or s2.samples.shape[0] < 2):
            rows[j] = _comparison_fields(nm, s1, s2, alpha)
            continue
        groups.setdefault((s1.samples.shape, s2.samples.shape),
                          []).append(j)
    for idxs in groups.values():
        A = np.stack([s1s[j].samples for j in idxs])
        B = np.stack([s2s[j].samples for j in idxs])
        bf = batch_bayes_factors(A, B)
        mean1, mean2 = A.mean(axis=1), B.mean(axis=1)
        lo1, hi1 = _batch_ci(A, alpha)
        lo2, hi2 = _batch_ci(B, alpha)
        for t, j in enumerate(idxs):
            rows[j] = _fields_from_stats(
                names[j], s1s[j], s2s[j], mean1[t], lo1[t], hi1[t],
                mean2[t], lo2[t], hi2[t], bf[t])
    return [rows[j] for j in sorted(rows)]


def _ci_fields(event_name: str, mean, lo, hi, num_iso: int) -> List[str]:
    """format_credible_intervals' output from precomputed statistics
    (misopy/credible_intervals.py:4-28 formatting rules)."""
    if num_iso > 2:
        return [event_name, ",".join("%.2f" % v for v in mean),
                ",".join("%.2f" % v for v in lo),
                ",".join("%.2f" % v for v in hi)]
    return [event_name, "%.2f" % mean[0], "%.2f" % lo[0],
            "%.2f" % hi[0]]


def _fields_from_stats(event_name, s1, s2, mean1, lo1, hi1,
                       mean2, lo2, hi2, bf) -> List[str]:
    """One .miso_bf row from batch-computed statistics; field-for-field
    the same construction as _comparison_fields below."""
    num_isoforms = s1.samples.shape[1]
    ci1 = _ci_fields(event_name, mean1, lo1, hi1, num_isoforms)
    ci2 = _ci_fields(event_name, mean2, lo2, hi2, num_isoforms)
    if num_isoforms == 2:
        m1 = Decimal(str(mean1[0])).quantize(Decimal("0.01"))
        m2 = Decimal(str(mean2[0])).quantize(Decimal("0.01"))
        posterior_diff = "%.2f" % (m1 - m2)
        bayes_factor = "%.2f" % bf[0]
        mean1_str, mean2_str = str(m1), str(m2)
    else:
        posterior_diff = ",".join("%.2f" % v for v in (mean1 - mean2))
        bayes_factor = ",".join("%.2f" % max(v, 0) for v in bf)
        mean1_str, mean2_str = ci1[1], ci2[1]
    gene_info = get_gene_info_from_params(s1.params)
    return [
        event_name,
        mean1_str, ci1[2], ci1[3],
        mean2_str, ci2[2], ci2[3],
        posterior_diff, bayes_factor,
        get_isoforms_from_header(s1.header),
        s1.counts_info["counts"], s1.counts_info["assigned_counts"],
        s2.counts_info["counts"], s2.counts_info["assigned_counts"],
        gene_info["chrom"], gene_info["strand"],
        gene_info["mRNA_starts"], gene_info["mRNA_ends"],
    ]


def _comparison_fields(event_name: str, s1, s2, alpha: float) -> List[str]:
    samples1, samples2 = s1.samples, s2.samples
    num_isoforms = samples1.shape[1]
    bf = compute_bayes_factors(samples1, samples2)

    mean1 = samples1.mean(axis=0)
    mean2 = samples2.mean(axis=0)
    ci1 = format_credible_intervals(event_name, samples1,
                                    confidence_level=alpha)
    ci2 = format_credible_intervals(event_name, samples2,
                                    confidence_level=alpha)
    if num_isoforms == 2:
        # 2-decimal quantization exactly as the reference
        # (hypothesis_test.py:301-307 uses Decimal.quantize)
        m1 = Decimal(str(mean1[0])).quantize(Decimal("0.01"))
        m2 = Decimal(str(mean2[0])).quantize(Decimal("0.01"))
        posterior_diff = "%.2f" % (m1 - m2)
        bayes_factor = "%.2f" % bf[0]
        mean1_str, mean2_str = str(m1), str(m2)
    else:
        posterior_diff = ",".join("%.2f" % v for v in (mean1 - mean2))
        bayes_factor = ",".join("%.2f" % max(v, 0) for v in bf)
        mean1_str, mean2_str = ci1[1], ci2[1]

    gene_info = get_gene_info_from_params(s1.params)
    return [
        event_name,
        mean1_str, ci1[2], ci1[3],
        mean2_str, ci2[2], ci2[3],
        posterior_diff, bayes_factor,
        get_isoforms_from_header(s1.header),
        s1.counts_info["counts"], s1.counts_info["assigned_counts"],
        s2.counts_info["counts"], s2.counts_info["assigned_counts"],
        gene_info["chrom"], gene_info["strand"],
        gene_info["mRNA_starts"], gene_info["mRNA_ends"],
    ]
