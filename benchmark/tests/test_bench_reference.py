"""The plain reference against a tiny CPU run of compute_all_genes_psi on
a generated sample: it agrees, and it fails an output perturbed after
the run."""
import os
import shutil

import numpy as np
import pytest

import check
import generate
import run
from conftest import PE_READS, SE_READS, tiny_cell, tiny_config


def run_program(kind, tmp_path):
    import torch
    from miso_tpu_torch._host import RunConfig
    from miso_tpu_torch.io.index import index_gff
    from miso_tpu_torch.pipeline import compute_all_genes_psi

    torch.set_num_threads(2)
    if kind == "se":
        cfg, cell = (tiny_config("se_events", 10),
                     tiny_cell("se_events_tiny", SE_READS))
    else:
        cfg = tiny_config("genes_pe", 6,
                          isoforms={"min": 3, "max": 4, "power": 2.5})
        cell = tiny_cell("genes_pe_tiny", PE_READS)
    s = generate.write_sample(generate.make_sample(cfg, cell, 99),
                              str(tmp_path / "sample"))
    index_gff(s.gff_path, str(tmp_path / "index"))
    sp, rd = cfg["sampler"], cfg["reads"]
    fr = rd.get("fragment")
    rc = RunConfig(read_len=rd["read_len"], paired_end=rd["paired_end"],
                   mean_frag_len=fr and fr["mean"],
                   frag_variance=fr and fr["sd"] ** 2,
                   iters=sp["num_iters"], burn_in=sp["burn_in"],
                   lag=sp["lag"], chains=sp["num_chains"])
    out = str(tmp_path / "out")
    compiled = run.Compiled(s.models.name)
    compiled.job = 0
    compiled.install()
    try:
        compute_all_genes_psi(str(tmp_path / "index"), s.bam_path,
                              rd["read_len"], out, cfg=rc, seed=5,
                              verbose=False, device="cpu")
    finally:
        compiled.uninstall()
    return s, cell, out, compiled.events


@pytest.fixture(scope="module", params=["se", "pe"])
def program_run(request, tmp_path_factory):
    return run_program(request.param,
                       tmp_path_factory.mktemp(request.param))


def perturbed(out, tmp_path, edit):
    """A copy of ``out`` with every .miso file passed through ``edit``."""
    dst = str(tmp_path / "perturbed")
    shutil.copytree(out, dst)
    for d, _, files in os.walk(dst):
        for f in files:
            if f.endswith(".miso"):
                p = os.path.join(d, f)
                with open(p) as fh:
                    text = fh.read()
                with open(p, "w") as fh:
                    fh.write(edit(text))
    return dst


def test_the_reference_agrees_with_the_program(program_run):
    s, cell, out, compiled = program_run
    cell = dict(cell, check={"events": 12})
    nums = check.check(s, [{"out_dir": out}], cell, 1, compiled=compiled)
    assert check.within(nums, cell["limits"]), nums


def test_classes_moved_at_the_compile_fail(program_run):
    s, cell, out, compiled = program_run
    cell = dict(cell, check={"events": 12})
    moved = {}
    for key, (keys, counts) in compiled.items():
        counts = counts.copy()
        ok = np.flatnonzero((keys > 0).any(1))
        other = [j for j in ok[1:] if counts[j] != counts[ok[0]]]
        if other:                    # two classes swap reads, totals kept
            counts[ok[0]], counts[other[0]] = counts[other[0]], counts[ok[0]]
        moved[key] = (keys, counts)
    nums = check.check(s, [{"out_dir": out}], cell, 1, compiled=moved)
    assert nums["classes"] > 0 and not check.within(nums, cell["limits"])
    nums = check.check(s, [{"out_dir": out}], cell, 1)
    assert nums["classes"] > 0, "no compiled classes must read as wrong"


def test_a_count_altered_in_a_header_fails(program_run, tmp_path):
    s, cell, out, compiled = program_run
    cell = dict(cell, check={"events": 12})

    def edit(text):
        head, _, rest = text.partition("\n")
        i = head.index("counts=") + len("counts=")
        j = head.index(":", i) + 1
        k = j
        while head[k].isdigit():
            k += 1
        return head[:j] + str(int(head[j:k]) + 1) + head[k:] + "\n" + rest

    nums = check.check(s, [{"out_dir": perturbed(out, tmp_path, edit)}],
                       cell, 1, compiled=compiled)
    assert nums["header"] > 0 and not check.within(nums, cell["limits"])


def test_samples_moved_off_the_posterior_fail(program_run, tmp_path):
    s, cell, out, compiled = program_run
    cell = dict(cell, check={"events": 12})

    def edit(text):
        head, _, rest = text.partition("\n")
        cols, _, body = rest.partition("\n")
        rows = []
        for ln in body.splitlines():
            psi, _, score = ln.partition("\t")
            v = np.array([float(x) for x in psi.split(",")])
            v = 0.5 * v + 0.5 / len(v)       # halfway to uniform
            rows.append(",".join("%.4f" % x for x in v) + "\t" + score)
        return head + "\n" + cols + "\n" + "\n".join(rows) + "\n"

    nums = check.check(s, [{"out_dir": perturbed(out, tmp_path, edit)}],
                       cell, 1, compiled=compiled)
    lim = cell["limits"]
    assert (nums["psi_gap_sd"] > lim["psi_gap_sd"]
            or nums["psi_chain_z"] > lim["psi_chain_z"]), nums
    assert not check.within(nums, lim)


def test_a_missing_event_fails(program_run, tmp_path):
    s, cell, out, compiled = program_run
    dst = perturbed(out, tmp_path, lambda t: t)
    victim = sorted(f for d, _, fs in os.walk(dst) for f in fs
                    if f.endswith(".miso"))[0]
    for d, _, fs in os.walk(dst):
        if victim in fs:
            os.remove(os.path.join(d, victim))
    nums = check.check(s, [{"out_dir": dst}], cell, 1, compiled=compiled)
    assert nums["missing"] == 1
