"""The host half of the ``miso --run`` pipeline.

Verbatim copies of ``miso_tpu/pipeline.py`` objects, importing the
port's own host modules:
RunConfig (:45-104), chrom_output_dir / event_output_path (:107-113),
compile_gene_event (:116-146), _LazyResult (:196-218),
_ci_bound_indices (:298-303), _write_event / _iter_bodies /
_write_events_batch (:810-873), _pack_events_batch (:876-904),
write_event_results (:907-924) and _CompileStream (:927-1302).  Their home imports jax at module level
(pipeline.py:42), so they live here and not in a file of the same name.
tests/test_torch_pipeline.py checks that each copy still equals its
original.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from miso_tpu_torch.core.events import (CompiledEvent, compile_paired_end,
                                        compile_paired_end_many,
                                        compile_single_end,
                                        compile_single_end_many)
from miso_tpu_torch.core.gene import Gene
from miso_tpu_torch.io import sam as sam_io
from miso_tpu_torch.io.index import load_indexed_gene
from miso_tpu_torch.io.miso_file import write_miso_file
from miso_tpu_torch.io.settings import Settings


@dataclasses.dataclass
class RunConfig:
    read_len: int
    overhang_len: int = 1
    paired_end: bool = False
    mean_frag_len: Optional[float] = None
    frag_variance: Optional[float] = None
    num_sds: float = 4.0
    iters: int = 5000
    burn_in: int = 500
    lag: int = 10
    chains: int = 6
    algorithm: str = "reassign"
    min_event_reads: int = 20
    strand_rule: Optional[str] = None
    max_batch_events: int = 4096
    filter_read_len: Optional[int] = None  # drop reads of other lengths
    # 'auto' -> fused XLA scan (fastest measured); 'pallas' selects the
    # fused Pallas kernel; 'xla' forces the scan
    backend: str = "auto"
    # chain start: 'auto' (miso.c:348 AUTO) or 'linear' (MISO_START_LINEAR,
    # miso.c:410-443: NNLS deconvolution seeds every chain)
    start: str = "auto"
    # stop rule: 'fixed' (MISO_STOP_FIXEDNO, the reference CLI default,
    # miso_sampler.py:211) or 'convergent' (R-hat <= 1.1 with the
    # 3*noIter - 2*burnIn adaptive extension, miso.c:903-928)
    stop: str = "fixed"
    max_iters: int = 500000
    # convergent-mode extension factor g: unconverged events continue
    # with iters' = iters + g*(iters - burn_in) (g=2 is the reference
    # rule noIter' = 3*noIter - 2*burnIn, miso.c:920-928; smaller
    # opt-in values extend stragglers in cheaper increments under the
    # same R-hat test)
    convergent_growth: float = 2.0
    # skip .miso sample bodies entirely: posterior mean + Chen-Shao CIs
    # compute ON DEVICE and only the per-event summary payload (a few
    # bytes/event instead of ~10 KB of quantized samples) leaves the
    # chip -- the TPU-first replacement for run-then-summarize
    # (misopy/samples_utils.py:263-329 re-reads every .miso file)
    summary_only: bool = False
    # stream events into per-chromosome .miso_db sqlite DURING the run
    # instead of writing the .miso text tree and re-packing it with
    # miso_pack afterwards (misopy/miso_pack.py:29-79)
    pack_output: bool = False

    @classmethod
    def from_settings(cls, settings: Settings, read_len: int, **kw):
        sp = settings.get_sampler_params()
        return cls(
            read_len=read_len,
            iters=kw.pop("iters", sp["num_iters"]),
            burn_in=kw.pop("burn_in", sp["burn_in"]),
            lag=kw.pop("lag", sp["lag"]),
            chains=kw.pop("chains", sp["num_chains"]),
            min_event_reads=kw.pop("min_event_reads",
                                   settings.get_min_event_reads()),
            strand_rule=kw.pop("strand_rule", settings.get_strand_param()),
            stop=kw.pop("stop", settings.get_stop_rule()),
            max_iters=kw.pop("max_iters", settings.get_max_iters()),
            **kw)


def chrom_output_dir(output_dir: str, chrom: Optional[str]) -> str:
    return os.path.join(output_dir, chrom if chrom else "NA")


def event_output_path(output_dir: str, gene: Gene, name: str) -> str:
    return os.path.join(chrom_output_dir(output_dir, gene.chrom),
                        "%s.miso" % name)


def compile_gene_event(
    gene: Gene,
    name: str,
    reads: Tuple[Sequence[int], Sequence[str]],
    cfg: RunConfig,
) -> Optional[CompiledEvent]:
    """Compile one gene's reads into an event; None if skipped."""
    positions, cigars = reads
    if gene.num_isoforms < 2:
        return None
    num_units = len(positions) // 2 if cfg.paired_end else len(positions)
    if num_units == 0 or num_units < cfg.min_event_reads:
        return None
    # +1: 0-based alignment positions -> 1-based matcher coordinates
    # (miso_sampler.py:284)
    pos1 = np.asarray(positions, dtype=np.int64) + 1
    # PackedCigars pass through untouched (the native matcher consumes
    # the packed buffer zero-copy); only plain sequences are listified
    cig = cigars if hasattr(cigars, "buf") else list(cigars)
    if cfg.paired_end:
        ev = compile_paired_end(
            gene, pos1, cig, read_len=cfg.read_len,
            mean_frag_len=cfg.mean_frag_len, frag_variance=cfg.frag_variance,
            num_sds=cfg.num_sds, overhang=cfg.overhang_len, name=name)
    else:
        ev = compile_single_end(
            gene, pos1, cig, read_len=cfg.read_len,
            overhang=cfg.overhang_len, name=name, algorithm=cfg.algorithm)
    if not ev.any_compatible:
        return None
    return ev


class _LazyResult(dict):
    """Per-event result dict whose float 'samples'/'loglik' arrays
    materialize on first access from the quantized device payload.
    The streamed .miso writer consumes 'psi_ticks'/'score_cents'
    directly (they ARE the output precision), so catalog runs never
    build the float arrays at all; run_events consumers still see the
    float API unchanged."""

    def __missing__(self, key):
        if key == "samples":
            t = self["psi_ticks"]          # (S, I) uint16
            if t.shape[1] == 2:
                c0 = t[:, 0].astype(np.float64) / 1e4
                v = np.stack([c0, 1.0 - c0], axis=-1)
            else:
                v = t.astype(np.float32) / 1e4
            self[key] = v
            return v
        if key == "loglik":
            v = self["score_cents"].astype(np.float64) / 100.0
            self[key] = v
            return v
        raise KeyError(key)


def _ci_bound_indices(num_samples: int,
                      confidence_level: float = 0.95):
    """(lo, hi) sorted-sample indices, or None if the sample count is
    too small for the interval (the shared Chen-Shao rule)."""
    from miso_tpu_torch.stats.intervals import ci_bound_indices
    return ci_bound_indices(num_samples, confidence_level)


def _write_event(output_dir: str, cfg: RunConfig, ev: CompiledEvent,
                 res: dict, body: bytes = None) -> None:
    """The single shared per-event .miso writer (every writing path --
    batch writer, streamed chunks, write_event_results -- routes here:
    ONE place to change the output contract).  Sample data resolves in
    preference order: a preformatted `body` (the batch formatter),
    the quantized device payload (psi_ticks/score_cents), then the
    float arrays (convergent results, wide-score fallbacks)."""
    path = event_output_path(output_dir, ev.gene, ev.name)
    samples = loglik = ticks = cents = None
    if body is None:
        ticks = res.get("psi_ticks")
        cents = res.get("score_cents")
        if ticks is None or cents is None:
            ticks = cents = None
            samples, loglik = res["samples"], res["loglik"]
    write_miso_file(
        path, ev, samples, loglik,
        # convergent stopping records the per-event final schedule
        iters=res.get("iters", cfg.iters),
        burn_in=res.get("burn_in", cfg.burn_in), lag=cfg.lag,
        percent_accept=res["percent_accept"], final_n=res["final_n"],
        psi_ticks=ticks, score_cents=cents, body=body)


def _iter_bodies(evs, results):
    """(ev, res, body-or-None) for a chunk slice, batch-formatting the
    sample bodies: ONE _format_quantized call covers every
    same-isoform-count event in the slice (per-event numpy formatting
    overhead -- ~20 small array ops each -- dominated the write phase
    at catalog scale).  Events without the quantized payload
    (convergent results, wide-score fallbacks) yield body=None."""
    from miso_tpu_torch.io.miso_file import _format_quantized

    groups: Dict[Tuple[int, int], list] = {}
    rest = []
    for ev, res in zip(evs, results):
        if res is None:
            continue
        t = res.get("psi_ticks")
        c = res.get("score_cents")
        if t is not None and c is not None:
            groups.setdefault((t.shape[1], t.shape[0]), []).append(
                (ev, res))
        else:
            rest.append((ev, res))
    for (k, S), items in groups.items():
        T = np.stack([r["psi_ticks"] for _, r in items]
                     ).astype(np.int64).reshape(-1, k)
        C = np.stack([r["score_cents"] for _, r in items]).reshape(-1)
        blob, off = _format_quantized(T, C, C < 0, return_offsets=True)
        for j, (ev, res) in enumerate(items):
            yield ev, res, blob[off[j * S]:off[(j + 1) * S]]
    for ev, res in rest:
        yield ev, res, None


def _write_events_batch(output_dir: str, cfg: RunConfig, evs, results
                        ) -> int:
    written = 0
    for ev, res, body in _iter_bodies(evs, results):
        _write_event(output_dir, cfg, ev, res, body=body)
        written += 1
    return written


def _pack_events_batch(packer, cfg: RunConfig, evs, results) -> int:
    """Stream a chunk slice straight into per-chromosome sqlite
    (`--pack-output`): same header/body bytes as the .miso writer, no
    text tree, no re-pack pass.  Ref: misopy/miso_db.py:144-193."""
    from miso_tpu_torch.io.miso_file import (_format_quantized,
                                       _format_sample_block,
                                       event_header_str)

    n = 0
    for ev, res, body in _iter_bodies(evs, results):
        if body is None:
            t = res.get("psi_ticks")
            c = res.get("score_cents")
            if t is not None and c is not None:
                cents = np.asarray(c, np.int64)
                body = _format_quantized(np.asarray(t, np.int64),
                                         cents, cents < 0)
            else:
                body = _format_sample_block(
                    np.asarray(res["samples"], np.float64),
                    np.asarray(res["loglik"], np.float64))
        header = (event_header_str(
            ev, res.get("iters", cfg.iters),
            res.get("burn_in", cfg.burn_in), cfg.lag,
            res["percent_accept"], res["final_n"])
            + "sampled_psi\tlog_score\n")
        packer.add(ev.gene.chrom, ev.name, header, body.decode())
        n += 1
    return n


def write_event_results(
    events: List[CompiledEvent],
    results: List[Optional[dict]],
    output_dir: str,
    cfg: RunConfig,
    workers: int = 4,
) -> int:
    def write_one(pair):
        _write_event(output_dir, cfg, *pair)
        return 1

    todo = [(ev, res) for ev, res in zip(events, results)
            if res is not None]
    if workers > 1 and len(todo) > 64:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return sum(pool.map(write_one, todo))
    return sum(map(write_one, todo))


class _CompileStream:
    """The host compile producer: walks the indexed catalog in
    per-chromosome-directory groups, loads gene pickles (one batch
    pickle per chromosome when the index provides it), runs the
    whole-chromosome columnar scan + ONE native batch match+collapse
    call per (chromosome, strand) group, and emits CompiledEvents.

    Falls back per-gene (compile_gene_event) for paired-end data,
    non-native alignments, genes missing from the batch call, or
    chromosomes absent from the BAM.
    """

    def __init__(self, items, alignments, cfg: RunConfig, output_dir: str,
                 verbose: bool, emit, workers: int = 1, done=None):
        self.items = items
        self.alignments = alignments
        self.cfg = cfg
        self.output_dir = output_dir
        self.verbose = verbose
        self.emit = emit
        # event names already present in packed output (--pack-output
        # resume); the .miso skip rule checks the filesystem instead
        self.done = done
        # the settings num_processors knob (settings.py:148), applied to
        # the PER-GENE fallback only: the native batch path is faster
        # single-threaded (one C call per chromosome), but non-native
        # readers (text SAM, no C++ toolchain) compile per gene and
        # scale with threads (region fetches release the GIL)
        self.workers = max(1, workers)
        self.skipped = 0
        # resume skips only (existing outputs), distinct from rule
        # skips: gates (and scopes) the summary backfill -- on shared
        # multi-host output trees only THIS host's skipped events may
        # be backfilled, or per-host summaries would overlap
        self.resume_skipped = 0
        self.resume_skipped_names: list = []
        # set by the consumer on its error path: the producer stops at
        # the next gene/subgroup instead of compiling the rest of the
        # catalog into a drain loop
        self.stop = False

        import collections
        from concurrent.futures import ThreadPoolExecutor
        self.scan_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.scan_lock = threading.Lock()
        self.scan_method = ("scan_chrom_columnar_paired" if cfg.paired_end
                           else "scan_chrom_columnar")
        # paired chromosome scans never depend on the target strand
        # (fr-firststrand only reorders mates), so one scan per
        # chromosome serves both strands; single-end stranded scans are
        # per-strand
        self.strandless = (cfg.paired_end
                           or cfg.strand_rule in (None, "fr-unstranded"))
        # 2 workers: the next chromosome's scan runs beside the current
        # one's tail instead of queueing behind it
        self.prefetcher = ThreadPoolExecutor(max_workers=2)
        self.scan_futures: Dict[object, object] = {}
        self.chrom_next: Dict[str, str] = {}

    # ------------------------------------------------------- chrom scans
    def _scan_raw(self, chrom, strand):
        try:
            return getattr(self.alignments, self.scan_method)(
                chrom, given_read_len=self.cfg.filter_read_len,
                strand_rule=self.cfg.strand_rule,
                target_strand=None if self.strandless else strand)
        except KeyError:
            return KeyError  # sentinel: chrom absent from the BAM

    def chrom_scan(self, chrom, strand):
        if not hasattr(self.alignments, self.scan_method):
            return None
        key = (chrom, None if self.strandless else strand)
        with self.scan_lock:
            if key in self.scan_cache:
                self.scan_cache.move_to_end(key)
                hit = self.scan_cache[key]
                if hit is KeyError:  # cached BAM-absent chromosome
                    raise KeyError(chrom)
                return hit
            fut = self.scan_futures.pop(key, None)
            if fut is None:
                fut = self.prefetcher.submit(self._scan_raw, chrom, strand)
            # prefetch the NEXT chromosome while this one resolves /
            # compiles (strandless keys only: stranded keys are
            # per-gene, so the next gene's strand is unknown here)
            nxt = self.chrom_next.get(chrom)
            if (self.strandless and nxt is not None
                    and (nxt, None) not in self.scan_futures
                    and (nxt, None) not in self.scan_cache):
                self.scan_futures[(nxt, None)] = self.prefetcher.submit(
                    self._scan_raw, nxt, None)
        scan = fut.result()
        with self.scan_lock:
            self.scan_cache[key] = scan
            while len(self.scan_cache) > 4:
                self.scan_cache.popitem(last=False)
        if scan is KeyError:
            raise KeyError(chrom)
        return scan

    # --------------------------------------------------------- per gene
    def compile_one(self, gene: Gene, out_name: str):
        """Per-gene fallback: region ingest + compile_gene_event."""
        cfg = self.cfg
        alignments = self.alignments
        lo, hi = gene.genomic_span()
        if hasattr(alignments, "fetch_columnar"):
            # columnar ingest: native batch decode (and native qname
            # pairing for paired-end) straight to (positions, cigars),
            # no per-read Python objects.
            col = None
            try:
                scan = self.chrom_scan(gene.chrom, gene.strand)
                if scan is not None:
                    col = scan.slice(lo - 1, hi)
                elif cfg.paired_end:
                    col = alignments.fetch_columnar_paired(
                        gene.chrom, lo - 1, hi,
                        given_read_len=cfg.filter_read_len,
                        strand_rule=cfg.strand_rule,
                        target_strand=gene.strand)
                else:
                    col = alignments.fetch_columnar(
                        gene.chrom, lo - 1, hi,
                        given_read_len=cfg.filter_read_len,
                        strand_rule=cfg.strand_rule,
                        target_strand=gene.strand)
            except KeyError:
                pass  # chr-prefix fallback below
            if col is not None:
                return compile_gene_event(gene, out_name, col[:2], cfg)
        raw = sam_io.fetch_bam_reads_in_gene(
            alignments, gene.chrom, lo - 1, hi)
        reads, _ = sam_io.sam_parse_reads(
            raw, paired_end=cfg.paired_end, strand_rule=cfg.strand_rule,
            target_strand=gene.strand,
            given_read_len=cfg.filter_read_len)
        return compile_gene_event(gene, out_name, reads, cfg)

    # ------------------------------------------------------------- main
    def run(self) -> None:
        items = self.items
        # group consecutive items by per-chromosome pickle directory
        groups: List[Tuple[str, list]] = []
        for gene_id, fname in items:
            d = os.path.dirname(fname)
            if not groups or groups[-1][0] != d:
                groups.append((d, []))
            groups[-1][1].append((gene_id, fname))

        # chromosome visit order for the prefetcher: resolved lazily as
        # groups are visited (dir names may carry an added 'chr' prefix,
        # io/index.py:41, so they cannot key the prefetch); seeded here
        # from one gene per group so prefetch spans group boundaries
        chrom_seq: List[str] = []
        for d, group in groups:
            gid, fn = group[0]
            try:
                # ONE per-gene pickle per group (not the batch pickle:
                # loading every chromosome's batch upfront would defeat
                # the chromosome-at-a-time streaming)
                g = load_indexed_gene(fn)[gid]["gene_object"]
                if g.chrom and g.chrom not in chrom_seq:
                    chrom_seq.append(g.chrom)
            except Exception:
                pass
        self.chrom_next = {c: chrom_seq[i + 1]
                           for i, c in enumerate(chrom_seq[:-1])}

        try:
            # pickle loads for group k+1 prefetch on the pool while
            # group k compiles (the per-chromosome batch unpickle is a
            # measurable slice of the 50k compile wall)
            entry_fut = (self.prefetcher.submit(self._entries, *groups[0])
                         if groups else None)
            for idx, (d, group) in enumerate(groups):
                if self.stop:
                    break
                entries = entry_fut.result()
                entry_fut = (self.prefetcher.submit(
                    self._entries, *groups[idx + 1])
                    if idx + 1 < len(groups) else None)
                self._run_group(d, group, entries)
        finally:
            # cancel any unconsumed prefetch (e.g. every output of its
            # chromosome already existed) so a whole-chromosome scan
            # does not keep running beside device sampling
            self.prefetcher.shutdown(wait=False, cancel_futures=True)

    def _entries(self, d: str, group):
        """(gene_id, entry) pairs for one directory group -- one batch
        unpickle per chromosome when the index has it (io/index.py),
        per-gene pickles otherwise."""
        from miso_tpu_torch.io.index import load_chrom_batch
        batch = load_chrom_batch(d)
        out = []
        for gene_id, fname in group:
            entry = None
            if batch is not None:
                entry = batch.get(gene_id)
            if entry is None:
                entry = load_indexed_gene(fname)[gene_id]
            out.append((gene_id, entry))
        return out

    def _run_group(self, d: str, group, entries=None) -> None:
        cfg = self.cfg
        # resolve genes + output names; apply the resume skip rule.
        # One listdir per output chromosome dir instead of an isfile
        # per event (50k isfile calls cost ~1s of the compile wall);
        # within one run each event is processed once, so a snapshot
        # taken at group start is exact.
        existing_cache: Dict[object, set] = {}

        def existing(chrom) -> set:
            s = existing_cache.get(chrom)
            if s is None:
                try:
                    s = set(os.listdir(
                        chrom_output_dir(self.output_dir, chrom)))
                except OSError:
                    s = set()
                existing_cache[chrom] = s
            return s

        todo: List[Tuple[Gene, str, str]] = []
        if entries is None:
            entries = self._entries(d, group)
        for gene_id, entry in entries:
            gene: Gene = entry["gene_object"]
            # --compress-id indexes name outputs by the hashed ID
            # (index_gff.py:80-99; summarize/compare map back via
            # --use-compressed)
            out_name = entry.get("compressed_id") or gene_id
            if (out_name + ".miso" in existing(gene.chrom)
                    or (self.done is not None
                        and out_name in self.done)):
                out_path = event_output_path(self.output_dir, gene,
                                             out_name)
                if self.verbose:
                    print("Output filename %s exists, not running MISO."
                          % out_path)
                self.skipped += 1
                self.resume_skipped += 1
                self.resume_skipped_names.append(out_name)
                continue
            todo.append((gene, out_name, gene_id))
        if not todo:
            return

        if cfg.paired_end:
            # paired batch path: ONE native paired match+collapse call
            # per chromosome against the columnar pair scan (paired
            # scans are strandless; fr-firststrand only reorders mates)
            from miso_tpu_torch.io.index import load_compile_tables
            tables = load_compile_tables(d)
            trow = tables["row"] if tables is not None else {}
            rest: List[Tuple[Gene, str, str]] = []
            chrom = todo[0][0].chrom
            sub = []
            for item in todo:
                if item[0].chrom != chrom or chrom is None:
                    rest.append(item)
                else:
                    sub.append(item)
            done = False
            try:
                scan = self.chrom_scan(chrom, None)
            except KeyError:
                scan = None  # absent from BAM: per-gene fallback
            if scan is not None and hasattr(scan, "p1"):
                rows = None
                if tables is not None and all(
                        gid in trow for _, _, gid in sub):
                    rows = [trow[gid] for _, _, gid in sub]
                evs = compile_paired_end_many(
                    [g for g, _, _ in sub], [nm for _, nm, _ in sub],
                    scan, read_len=cfg.read_len,
                    mean_frag_len=cfg.mean_frag_len,
                    frag_variance=cfg.frag_variance,
                    num_sds=cfg.num_sds, overhang=cfg.overhang_len,
                    min_event_reads=cfg.min_event_reads,
                    tables=tables if rows is not None else None,
                    rows=rows)
                if evs is not None:
                    for ev in evs:
                        if ev is None:
                            self.skipped += 1
                        else:
                            self.emit(ev)
                    done = True
            if not done:
                rest.extend(sub)
            todo = rest
        else:
            # batch path: ONE native match+collapse call per
            # (chromosome, strand) subgroup against the columnar scan,
            # driven by the index's precomputed compile tables when
            # available (zero per-gene Python assembly)
            from miso_tpu_torch.io.index import load_compile_tables
            tables = load_compile_tables(d)
            trow = tables["row"] if tables is not None else {}
            by_strand: Dict[object, list] = {}
            rest: List[Tuple[Gene, str]] = []
            chrom = todo[0][0].chrom
            for gene, name, gene_id in todo:
                if gene.chrom != chrom or gene.chrom is None:
                    rest.append((gene, name, gene_id))
                else:
                    skey = None if self.strandless else gene.strand
                    by_strand.setdefault(skey, []).append(
                        (gene, name, gene_id))
            for skey, sub in sorted(by_strand.items(),
                                    key=lambda kv: str(kv[0])):
                done = False
                try:
                    scan = self.chrom_scan(chrom, skey)
                except KeyError:
                    scan = None  # absent from BAM: per-gene fallback
                if scan is not None:
                    rows = None
                    if tables is not None and all(
                            gid in trow for _, _, gid in sub):
                        rows = [trow[gid] for _, _, gid in sub]
                    evs = compile_single_end_many(
                        [g for g, _, _ in sub], [n for _, n, _ in sub],
                        scan, read_len=cfg.read_len,
                        overhang=cfg.overhang_len,
                        algorithm=cfg.algorithm,
                        min_event_reads=cfg.min_event_reads,
                        tables=tables if rows is not None else None,
                        rows=rows)
                    if evs is not None:
                        for ev in evs:
                            if ev is None:
                                self.skipped += 1
                            else:
                                self.emit(ev)
                        done = True
                if not done:
                    rest.extend(sub)
            todo = rest

        if self.workers > 1 and len(todo) > 16:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                # bounded windows, not one map over the whole group:
                # Executor.map submits everything eagerly, so a whole
                # chromosome's CompiledEvents would buffer in futures
                # and defeat the consumer queue's backpressure.  map
                # preserves order within each window, so emitted event
                # order (and with it PRNG chunk keys) stays
                # deterministic.
                window = self.workers * 8
                for lo in range(0, len(todo), window):
                    if self.stop:
                        return
                    for ev in pool.map(
                            lambda t: self.compile_one(t[0], t[1]),
                            todo[lo:lo + window]):
                        if ev is None:
                            self.skipped += 1
                        else:
                            self.emit(ev)
            return
        for gene, name, _gid in todo:
            if self.stop:
                return
            ev = self.compile_one(gene, name)
            if ev is None:
                self.skipped += 1
            else:
                self.emit(ev)
