"""Helpers of the benchmark's own tests: the benchmark's modules on the
path, and tiny cells run in a copy of the benchmark beside the program.

Run from the repository's root:  python -m pytest benchmark/tests -q
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)

def load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def tiny_config(base: str, events: int, **gene_model) -> dict:
    cfg = load(BENCH, "configs", base + ".json")
    cfg["name"] = base + "_tiny"
    cfg["events"] = events
    cfg["gene_model"].update(gene_model)
    return cfg


def tiny_cell(config: str, reads: dict, run=None) -> dict:
    """A cell of ``config`` with the stock schedule and the stock cells'
    limits."""
    return {"config": config, "traffic": "tiny", "chips": 1,
            "why": "a cell small enough for the CPU",
            "reads_per_event": reads, "psi_dirichlet": 0.5,
            "run": run or {"summary_only": False, "linear_start": False},
            "check": {"events": 6},
            "limits": {"missing": 0, "classes": 0, "header": 0, "summary": 0,
                       "psi_gap_sd": 3.0, "ci_gap_sd": 5.0,
                       "psi_chain_z": 6.0, "ci_chain_z": 8.0}}


SE_READS = {"unexpressed": 0.2, "unexpressed_below": 20, "median": 50,
            "sigma": 0.3, "cap": 80}
PE_READS = {"unexpressed": 0.0, "unexpressed_below": 20, "median": 40,
            "sigma": 0.3, "cap": 60}


def add_cell(copy: str, name: str, cfg: dict, cell: dict) -> None:
    """Add a configuration (if new) and a cell to the benchmark in
    ``copy`` by new files and new entries only."""
    bench = load(copy, "BENCHMARK.json")
    cfg_file = "benchmark/configs/%s.json" % cfg["name"]
    if not os.path.exists(os.path.join(copy, cfg_file)):
        with open(os.path.join(copy, cfg_file), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": cfg["name"], "source": "test",
                                 "file": cfg_file, "reduced": ["events"],
                                 "why": "test"})
    with open(os.path.join(copy, "benchmark", "workloads",
                           name + ".json"), "w") as f:
        json.dump(cell, f)
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": cell["traffic"], "chips": 1,
                               "why": cell["why"]})
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture
def bench_copy(tmp_path):
    """A checkout of the benchmark beside the program, with a tiny
    single-end and a tiny paired-end cell added."""
    copy = str(tmp_path / "checkout")
    os.makedirs(copy)
    shutil.copytree(BENCH, os.path.join(copy, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    os.symlink(os.path.join(ROOT, "miso_tpu_torch"),
               os.path.join(copy, "miso_tpu_torch"))
    add_cell(copy, "se_tiny.tiny", tiny_config("se_events", 10),
             tiny_cell("se_events_tiny", SE_READS))
    add_cell(copy, "pe_tiny.tiny",
             tiny_config("genes_pe", 6,
                         isoforms={"min": 2, "max": 4, "power": 2.5}),
             tiny_cell("genes_pe_tiny", PE_READS))
    return copy


DRIVE = """
import json, sys, torch
torch.set_num_threads(2)
sys.path[:0] = [{bench!r}, {root!r}]
import run
{patch}
res = run.run_cell({cell!r}, {seed!r}, 0.1, {trace!r}, device="cpu",
                   work_dir={work!r})
found = run.forbidden_modules()
print(json.dumps({{"result": res, "forbidden": found}}))
"""


def drive(copy: str, cell: str, seed: int = 2 ** 31 + 11, trace=False,
          patch: str = "") -> dict:
    """One CPU run of ``cell`` in ``copy``, in a process of its own, with
    ``patch`` (Python) applied to the program first."""
    code = DRIVE.format(bench=os.path.join(copy, "benchmark"), root=copy,
                        patch=patch, cell=cell, seed=seed, trace=trace,
                        work=copy)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=copy, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
