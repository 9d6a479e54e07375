"""Times of the REASSIGN and MARGINAL kernels at wide isoform widths on
one CUDA card: what ``wide.WIDE_FROM`` is chosen from.

    python3 miso_tpu_torch/sampler/wide_times.py [--tree DIR] [--reps N]
    python3 miso_tpu_torch/sampler/wide_times.py --plans [--reps N]
    python3 miso_tpu_torch/sampler/wide_times.py --mix [--reps N]
    python3 miso_tpu_torch/sampler/wide_times.py --marginal [--tree DIR]
    python3 miso_tpu_torch/sampler/wide_times.py --buckets [--tree DIR]

``--tree DIR`` imports ``miso_tpu_torch`` from DIR, another checkout of
the repo (a tree whose narrow kernels B1 and B2 still have instances of
these widths), so that one script times two trees alike: run it once
per tree, in one call to the card.  At I = 16 ... 2,048 isoforms (genes
of 9, 17, 40, 70, 150, 300, 600 and 1,100 isoforms, 400 simulated reads
each, four genes tiled to E = 4, 64 and, up to 128 isoforms, 2,048
events) it times, by CUDA events: the wrapper (``run_batch_reassign``,
``run_batch_marginal``: the route the tree takes at that width, where it
has one) and, where the tree has them, the wide kernels B1w and B2w
launched directly -- B1w on the genes' (R, I) read tiles (a class a
read) and, where the tree's B1w reads class tensors, on the genes'
classes as the pipeline hands them over ("wide classes"); at 1000
iterations x 6 chains, 100 x 6 at E = 2,048.  Before timing a wide
kernel it holds it against its plain version under fixed uniforms (24
iterations x 2 chains, E = 4) and raises where they differ.  The last
line is a JSON object of the best of ``--reps`` times in milliseconds
per case.

``--plans`` times instead B1w and B2w in every block width of their
plans (32 ... 512 threads a lane; B2w also in every cluster size and
home of its class rows, where the tree's B2w has them) at I = 16, 128,
512 and 2,048 (E = 4 events, 1000 iterations x 6 chains): B1w at R = 16
and 416 reads (``lane_test_batch``, a class a read), B2w at C = 4, 64
and 256 classes (``marginal_lane_batch``, E = 3): how a lane's step time
splits between the Gibbs sweep over the reads and the rest; and, where
the tree's B1w reads class tensors, B1w on the classes of four genes of
300 and of 1,100 isoforms (I = 512 and 2,048).

``--marginal`` times B2w as the tree's wrapper launches it (its own
plan) at I = 64, 128, 512 and 2,048 isoforms (60 % of them real), C =
64 and 256 classes (single-end and paired-end class counts), on the two
real events of ``marginal_lane_batch`` tiled to E = 4, 64 and 2,048
events, at 1000 x 6 (100 x 6 at 2,048), after holding it against its
plain version under fixed uniforms at E = 4; at 2,048 events also in
every block width of its plan's layout: what ``wide.marginal_plan``
rests on.  Run it on the parent's tree and on this one in one call
(``--tree``), in turns.

``--buckets`` times B2w through the tree's wrapper on ``chip_smoke.py``'s
wide buckets, four genes of 300 and of 1,100 isoforms
(``testing.wide_event``, seeds 3 ... 6; I = 512 and 2,048) at stock
settings, 5000 iterations x 6 chains.

``--mix`` times B1w's two forms on class tensors of every class share:
four events (``testing.wide_class_batch``) of R = 416 read slots spread
evenly over C = R/8 ... R classes, at I = 64, 128, 256 and 512 (genes
of 40, 70, 150 and 300 isoforms), tiled to E = 4, 64 and, up to 128
isoforms, 2,048
events, with the class table in the plan's tiles ("table") and, where
they differ and it fits a block, whole ("whole") and in tiles of four
rows ("four"), and with every read walking ("walk"), each forced by
``wide.WALK_ABOVE``; and, at 64 isoforms, the
wrapper's narrow route B1 on the same classes (the expansion to read
tiles included): what ``wide.walks`` and ``wide.WIDE_FROM`` are chosen
from.  The two forms are held bit-equal under fixed uniforms first.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

WIDTHS = ((16, 9), (32, 17), (64, 40), (128, 70), (256, 150), (512, 300),
          (1024, 600), (2048, 1100))
QUICK = dict(iters=1000, burn_in=100, lag=10, chains=6)
FULL_CARD = dict(iters=100, burn_in=10, lag=10, chains=6)
CHECK = dict(iters=24, burn_in=6, lag=3, chains=2)
# (copies of the four genes, schedule, widest I): E = 4, 64, 2,048
TILES = ((1, QUICK, 2048), (16, QUICK, 2048), (512, FULL_CARD, 128))


def wide_gene_event(algorithm, num_iso, seed):
    """A gene of ``num_iso`` isoforms, 400 reads: ``testing.wide_event``
    built from ``simulated_event`` alone, which every tree has."""
    import numpy as np

    from miso_tpu_torch.testing import simulated_event

    middle = max(9, (num_iso - 1).bit_length())
    subsets = [[1] + [2 + b for b in range(middle) if m >> b & 1]
               + [middle + 2] for m in range(num_iso)]
    psi = np.random.default_rng(seed).dirichlet(np.ones(num_iso))
    return simulated_event([60] * (middle + 2), subsets, psi, 400, 25,
                           seed=seed, algorithm=algorithm)


def timed(fn, reps):
    """Best milliseconds of fn() over reps runs, by CUDA events, after
    one run that is not timed."""
    import torch

    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1))
    return best


def check(name, got, ref):
    """Raise unless a kernel's result is its plain version's (the
    tolerances of tests/test_torch_cuda.py)."""
    import numpy as np

    got, ref = got.to_numpy(), ref.to_numpy()
    errs = {f: float(np.abs(getattr(got, f) - getattr(ref, f)).max(
        initial=0.0)) for f in ("psi_samples", "loglik", "final_n",
                                "final_psi")}
    ok = (errs["psi_samples"] <= 2e-4 and errs["final_psi"] <= 2e-4
          and errs["loglik"] <= 2e-3 and errs["final_n"] <= 1e-5
          and np.array_equal(got.accepted, ref.accepted))
    print("  check %-28s %s  %s" % (name, "ok" if ok else "DIFFERS", errs))
    if not ok:
        raise AssertionError("wide kernel disagrees with its plain version "
                             "at %s" % name)


def reads_classes(rk):
    """Whether the tree's B1w reads class tensors (``pad_reads``)."""
    launch = getattr(rk, "_reassign_wide_cuda", None)
    return (launch is not None
            and "pad_reads" in inspect.signature(launch).parameters)


def class_case(evs):
    """(class batch, read slots R) of genes as the pipeline hands their
    bucket to B1w: the class tensors, and the read slots of their read
    tiles."""
    from miso_tpu_torch.testing import class_batch, padded_batch

    return (class_batch(evs, "cuda"),
            padded_batch(evs, "cuda").read_w.shape[1])


def plan_times(reps):
    """{case: ms} of B1w and B2w in every block width (``--plans``)."""
    from miso_tpu_torch.sampler import marginal_kernel as mk
    from miso_tpu_torch.sampler import reassign_kernel as rk
    from miso_tpu_torch.sampler.mcmc import SamplerConfig
    from miso_tpu_torch.testing import lane_test_batch, marginal_lane_batch

    out = {}
    if reads_classes(rk):
        cfg = SamplerConfig(**QUICK)
        for I, num_iso in ((512, 300), (2048, 1100)):
            b, R = class_case([wide_gene_event("reassign", num_iso, 3 + j)
                               for j in range(4)])
            consts = rk._event_consts(b)
            C = b.weights.shape[1]
            row = []
            for plan in rk.all_wide_plans(4, R + (-R) % 4, I, cfg.chains,
                                          classes=C):
                label = "reassign classes I=%d C=%d threads=%d" % (
                    I, C, plan.threads)
                out[label] = timed(lambda: rk._reassign_wide_cuda(
                    1, b, cfg, consts, None, False, plan=plan, pad_reads=R),
                    reps)
                row.append("%d: %.2f" % (plan.threads, out[label]))
            print("  reassign classes I=%d C=%d R=%d, %d x %d, ms by threads "
                  "a lane: %s" % (I, C, R, cfg.iters, cfg.chains,
                                  "  ".join(row)), flush=True)
    for kind in ("reassign", "marginal"):
        cfg = SamplerConfig(algorithm=kind, **QUICK)
        for I in (16, 128, 512, 2048):
            for n in ((16, 416) if kind == "reassign" else (4, 64, 256)):
                num_iso = max(2, I * 6 // 10)
                if kind == "reassign":
                    b = lane_test_batch(I, num_iso, 3, "cuda", E=4, R=n)
                    consts = rk._event_consts(b)
                    launch = rk._reassign_wide_cuda
                    plans = rk.all_wide_plans(4, n, I, cfg.chains)
                else:
                    b = marginal_lane_batch(I, num_iso, 3, "cuda", C=n)
                    consts = mk._marginal_consts(b)
                    launch = mk._marginal_wide_cuda
                    plans = mk.all_wide_plans(3, n, I, cfg.chains)
                row = []
                for plan in plans:
                    label = "%s I=%d %s=%d %s" % (
                        kind, I, "R" if kind == "reassign" else "C", n,
                        plan_tag(plan))
                    out[label] = timed(lambda: launch(
                        1, b, cfg, consts, None, False, plan=plan), reps)
                    row.append("%s: %.2f" % (plan_tag(plan), out[label]))
                print("  %s I=%d %s=%d, %d x %d, ms by threads a lane: %s"
                      % (kind, I, "R" if kind == "reassign" else "C", n,
                         cfg.iters, cfg.chains, "  ".join(row)), flush=True)
    return out


def plan_tag(plan):
    """A plan's block width and, where it has them, B2w's cluster and
    the home of its class rows."""
    tag = "threads=%d" % plan.threads
    if getattr(plan, "cluster", None) is not None and plan.rows == 0:
        tag += " cluster=%d rows=%s" % (plan.cluster, plan.weights)
    return tag


MARGINAL_WIDTHS = (64, 128, 512, 2048)
MARGINAL_CLASSES = (64, 256)
# (copies of the four events, schedule): E = 4, 64, 2,048 at every width
MARGINAL_TILES = ((1, QUICK), (16, QUICK), (512, FULL_CARD))


def marginal_times(reps):
    """{case: ms} of B2w in the tree's own plan (``--marginal``)."""
    import torch

    from miso_tpu_torch.sampler import marginal_kernel as mk
    from miso_tpu_torch.sampler import wide
    from miso_tpu_torch.sampler.mcmc import EventBatch, SamplerConfig
    from miso_tpu_torch.testing import marginal_lane_batch

    out = {}
    short = SamplerConfig(algorithm="marginal", **CHECK)
    for I in MARGINAL_WIDTHS:
        for C in MARGINAL_CLASSES:
            two = marginal_lane_batch(I, I * 6 // 10, 3, "cuda", C=C)
            pick = torch.tensor([0, 1, 0, 1], device=two.weights.device)
            base = EventBatch(*[t.index_select(0, pick).contiguous()
                                for t in two])
            consts = mk._marginal_consts(base)
            ref = mk._marginal_plain(0, base, short, consts, None,
                                     mk.FIXED_U, wide_order=True)
            check("marginal I=%d C=%d" % (I, C), mk._marginal_wide_cuda(
                0, base, short, consts, None, True), ref)
            for tiles, schedule in MARGINAL_TILES:
                cfg = SamplerConfig(algorithm="marginal", **schedule)
                b = EventBatch(*[t.repeat(tiles, *[1] * (t.dim() - 1))
                                 .contiguous() for t in base])
                E = b.weights.shape[0]
                bc = mk._marginal_consts(b)
                label = "marginal I=%d C=%d E=%d" % (I, C, E)
                out[label] = timed(lambda: mk._marginal_wide_cuda(
                    5, b, cfg, bc, None, False), reps)
                plan = wide.wide_plan("marginal", E, C, I, cfg.chains)
                print("  %-30s %d x %d  %9.2f ms  (plan %s)" % (
                    label, cfg.iters, cfg.chains, out[label],
                    plan_tag(plan)), flush=True)
                if tiles == MARGINAL_TILES[-1][0] and hasattr(plan,
                                                              "cluster"):
                    out.update(width_times(b, cfg, bc, plan, label, reps))
    return out


def width_times(b, cfg, consts, plan, label, reps):
    """{case: ms} of B2w in every block width of ``plan``'s layout (its
    cluster, the home of its rows and of its lane arrays)."""
    from miso_tpu_torch.sampler import marginal_kernel as mk

    E, C, I = b.weights.shape
    out, row = {}, []
    for p in mk.all_wide_plans(E, C, I, cfg.chains):
        if (p.cluster, p.weights, p.shared_bytes > 0) != (
                plan.cluster, plan.weights, plan.shared_bytes > 0):
            continue
        key = "%s threads=%d" % (label, p.threads)
        out[key] = timed(lambda: mk._marginal_wide_cuda(
            5, b, cfg, consts, None, False, plan=p), reps)
        row.append("%d: %.2f" % (p.threads, out[key]))
    print("  %-30s by threads a lane: %s" % (label, "  ".join(row)),
          flush=True)
    return out


def bucket_times(reps):
    """{case: ms} of B2w at chip_smoke.py's wide buckets (``--buckets``)."""
    from miso_tpu_torch.sampler import marginal_kernel as mk
    from miso_tpu_torch.sampler.mcmc import SamplerConfig
    from miso_tpu_torch.testing import padded_batch, wide_event

    out = {}
    stock = SamplerConfig(algorithm="marginal")
    for gene_iso in (300, 1100):
        b = padded_batch([wide_event("marginal", num_iso=gene_iso, seed=3 + j)
                          for j in range(4)], "cuda")
        label = "marginal 4 x %d isoforms I=%d C=%d" % (
            gene_iso, b.weights.shape[2], b.weights.shape[1])
        out[label] = timed(lambda: mk.run_batch_marginal(3, b, stock), reps)
        print("  %-40s %d x %d  %9.2f ms" % (label, stock.iters,
                                             stock.chains, out[label]),
              flush=True)
    return out


MIX_WIDTHS = ((64, 40), (128, 70), (256, 150), (512, 300))
MIX_READS = 416
MIX_CLASSES = (52, 104, 156, 208, 260, 312, 416)


def mix_times(reps):
    """{case: ms} of B1w's table and walk forms, and B1 at 64 isoforms,
    over the class shares of ``MIX_CLASSES`` (``--mix``)."""
    import torch

    from miso_tpu_torch.sampler import reassign_kernel as rk
    from miso_tpu_torch.sampler import wide
    from miso_tpu_torch.sampler.mcmc import EventBatch, SamplerConfig
    from miso_tpu_torch.testing import wide_class_batch

    def forced(walk, fn):
        # every launch of fn walks (share 0) or builds its table
        saved = wide.WALK_ABOVE
        wide.WALK_ABOVE = (0.0, 0.0) if walk else (float("inf"),) * 2
        try:
            return fn()
        finally:
            wide.WALK_ABOVE = saved

    R, out = MIX_READS, {}
    short = SamplerConfig(**CHECK)
    for I, num_iso in MIX_WIDTHS:
        for C in MIX_CLASSES:
            counts = [[R // C + (c < R % C) for c in range(C)]] * 4
            base = wide_class_batch(I, num_iso, 3, "cuda", counts=counts)
            consts = rk._event_consts(base)
            # the table whole, in tiles of four rows, and the walk
            plan = forced(False, lambda: rk.wide_plan(4, R, I, short.chains,
                                                      classes=C))
            forms = [forced(walk, lambda: rk._reassign_wide_cuda(
                0, base, short, consts, None, True, plan=p, pad_reads=R))
                for walk, p in ((False, plan), (False, wide.tiled(
                    plan, R, I, 4)), (True, None))]
            for other in forms[1:]:
                for name, a, b in zip(forms[0]._fields, forms[0], other):
                    if not torch.equal(a, b):
                        raise AssertionError("B1w's forms differ in %s at "
                                             "I=%d C=%d" % (name, I, C))
            for tiles, schedule, widest in TILES:
                if I > widest:
                    continue
                cfg = SamplerConfig(**schedule)
                b = EventBatch(*[t.repeat(tiles, *[1] * (t.dim() - 1))
                                 .contiguous() for t in base])
                bc = rk._event_consts(b)
                label = "I=%d C=%d E=%d" % (I, C, b.weights.shape[0])
                line = "  %-22s R=%d %d x %d" % (label, R, cfg.iters,
                                                 cfg.chains)
                if I in rk.KERNEL_ISO and I < wide.WIDE_FROM:
                    out[label + " B1"] = timed(lambda: rk.run_batch_reassign(
                        5, b, cfg, pad_reads=R), reps)
                    line += "  B1 %9.2f ms" % out[label + " B1"]
                E = b.weights.shape[0]
                plan = forced(False, lambda: rk.wide_plan(
                    E, R, I, cfg.chains, classes=C))
                whole = wide.tiled(plan, R, I, C)
                forms = [("table", False, plan), ("walk", True, None)]
                if plan.rows < C and 0 < whole.shared_bytes <= wide.MAX_SHARED:
                    forms.insert(1, ("whole", False, whole))
                if 4 < plan.rows < C or (C > 4 and whole.shared_bytes
                                         > wide.MAX_SHARED):
                    forms.insert(1, ("four", False,
                                     wide.tiled(plan, R, I, 4)))
                for form, walk, p in forms:
                    out[label + " " + form] = forced(walk, lambda: timed(
                        lambda: rk._reassign_wide_cuda(
                            5, b, cfg, bc, None, False, plan=p,
                            pad_reads=R), reps))
                    line += "  %s %9.2f ms" % (form, out[label + " " + form])
                line += "  (table: %d rows a tile)" % plan.rows
                print(line, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="checkout to import miso_tpu_torch from")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--plans", action="store_true",
                    help="time B1w and B2w in every block width instead")
    ap.add_argument("--mix", action="store_true",
                    help="time B1w's table and walk (and B1 at 64 "
                    "isoforms) over class shares instead")
    ap.add_argument("--marginal", action="store_true",
                    help="time B2w in its own plan over widths, class "
                    "counts and events instead")
    ap.add_argument("--buckets", action="store_true",
                    help="time B2w at chip_smoke.py's wide buckets at "
                    "stock settings instead")
    args = ap.parse_args(argv)
    # this file's own directory is no place to import the package from
    sys.path[0] = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    import torch

    import miso_tpu_torch
    from miso_tpu_torch import kernels
    from miso_tpu_torch.sampler import marginal_kernel as mk
    from miso_tpu_torch.sampler import reassign_kernel as rk
    from miso_tpu_torch.sampler.mcmc import EventBatch, SamplerConfig
    from miso_tpu_torch.testing import padded_batch

    if not torch.cuda.is_available():
        print("wide_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels.load()
    print("miso_tpu_torch from %s; card %s; build %s s"
          % (os.path.dirname(miso_tpu_torch.__file__), card,
             kernels.BUILD_INFO["seconds"]))
    if args.plans:
        print(json.dumps({"card": card, "plans_ms": plan_times(args.reps)}))
        return 0
    if args.mix:
        print(json.dumps({"card": card, "mix_ms": mix_times(args.reps)}))
        return 0
    if args.buckets:
        print(json.dumps({"card": card, "tree": os.path.dirname(
            miso_tpu_torch.__file__), "buckets_ms": bucket_times(
                args.reps)}))
        return 0
    if args.marginal:
        print(json.dumps({"card": card, "tree": os.path.dirname(
            miso_tpu_torch.__file__), "marginal_ms": marginal_times(
                args.reps)}))
        return 0
    wide_b1 = getattr(rk, "_reassign_wide_cuda", None)
    wide_b2 = getattr(mk, "_marginal_wide_cuda", None)
    classes = reads_classes(rk)
    out = {}
    for algorithm in ("reassign", "marginal"):
        mod = rk if algorithm == "reassign" else mk
        launch_wide = wide_b1 if mod is rk else wide_b2
        consts_of = (rk._event_consts if mod is rk
                     else mk._marginal_consts)
        run = rk.run_batch_reassign if mod is rk else mk.run_batch_marginal
        short = SamplerConfig(algorithm=algorithm, **CHECK)
        for I, num_iso in WIDTHS:
            narrow = I in rk.KERNEL_ISO
            if launch_wide is None and not narrow:
                continue      # the tree has no kernel of this width
            evs = [wide_gene_event(algorithm, num_iso, 3 + j)
                   for j in range(4)]
            base = padded_batch(evs, "cuda")
            if base.weights.shape[2] != I:
                raise AssertionError("%d isoforms pad to %d, not %d" % (
                    num_iso, base.weights.shape[2], I))
            if launch_wide is not None:
                consts = consts_of(base)
                plain = (rk._reassign_plain if mod is rk
                         else mk._marginal_plain)
                ref = plain(0, base, short, consts, None, mod.FIXED_U,
                            wide_order=True)
                check("%s I=%d" % (algorithm, I),
                      launch_wide(0, base, short, consts, None, True), ref)
            cbase = None
            if launch_wide is not None and mod is rk and classes:
                cbase, R = class_case(evs)
                check("%s classes I=%d" % (algorithm, I),
                      launch_wide(0, cbase, short, rk._event_consts(cbase),
                                  None, True, pad_reads=R), ref)
            for tiles, schedule, widest in TILES:
                if I > widest:
                    continue
                cfg = SamplerConfig(algorithm=algorithm, **schedule)
                b = EventBatch(*[t.repeat(tiles, *[1] * (t.dim() - 1))
                                 .contiguous() for t in base])
                E, n = b.weights.shape[0], (b.read_w.shape[1] if mod is rk
                                            else b.weights.shape[1])
                label = "%s I=%d E=%d" % (algorithm, I, E)
                line = "  %-24s %s=%d %d x %d" % (
                    label, "R" if mod is rk else "C", n, cfg.iters,
                    cfg.chains)
                if narrow or launch_wide is None:
                    out[label + " wrapper"] = timed(
                        lambda: run(5, b, cfg), args.reps)
                    line += "  wrapper %10.2f ms" % out[label + " wrapper"]
                if launch_wide is not None:
                    consts = consts_of(b)
                    out[label + " wide"] = timed(
                        lambda: launch_wide(5, b, cfg, consts, None,
                                            False), args.reps)
                    line += "  wide %10.2f ms" % out[label + " wide"]
                if cbase is not None:
                    cb = EventBatch(*[t.repeat(tiles, *[1] * (t.dim() - 1))
                                      .contiguous() for t in cbase])
                    cconsts = rk._event_consts(cb)
                    out[label + " wide classes"] = timed(
                        lambda: launch_wide(5, cb, cfg, cconsts, None, False,
                                            pad_reads=R), args.reps)
                    line += "  wide classes (C=%d) %10.2f ms" % (
                        cb.weights.shape[1], out[label + " wide classes"])
                print(line, flush=True)
    print(json.dumps({"card": card, "tree": os.path.dirname(
        miso_tpu_torch.__file__), "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
