"""The benchmark is driven by data: BENCHMARK.json's entries each find
their files by name, and a cell added by new files and entries only runs
through the whole harness on the CPU."""
import glob
import os
import re

import pytest

from conftest import BENCH, ROOT, drive, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_finds_every_file_by_name():
    bench = load(ROOT, "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        cfg = load(ROOT, c["file"])
        assert cfg["name"] == c["name"]
        assert all(k in cfg for k in c["reduced"])
    used = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1 and w["config"] in configs
        cell = load(BENCH, "workloads", w["name"] + ".json")
        assert (cell["config"], cell["traffic"], cell["chips"],
                cell["why"]) == (w["config"], w["traffic"], w["chips"],
                                 w["why"])
        assert {"missing", "classes", "header", "summary", "psi_gap_sd",
                "ci_gap_sd"} <= set(cell["limits"])
        used.add(w["config"])
    assert used == set(configs)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in bench["per_layer"]:
        assert m["moves"] == "events_per_s"
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_each_metric_reader_is_a_file_of_its_own():
    readers = {os.path.basename(p)[:-3]
               for p in glob.glob(os.path.join(BENCH, "metrics", "*.py"))}
    bench = load(ROOT, "BENCHMARK.json")
    assert {m["name"] for m in bench["per_layer"]} <= readers


@pytest.mark.parametrize("cell", ["se_tiny.tiny", "pe_tiny.tiny"])
def test_an_added_cell_runs_without_editing_a_file(bench_copy, cell):
    out = drive(bench_copy, cell)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"events_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert out["forbidden"] == []


def test_a_traced_run_reads_the_host_spans(bench_copy):
    res = drive(bench_copy, "se_tiny.tiny", trace=True)["result"]
    assert res["correct"], res["checks"]
    # the CPU has no device trace: only the host spans' readers read
    assert {"compile_s_per_kevent", "dispatch_s_per_kevent"} <= set(
        res["metrics"])
    assert not {"kernel_roofline_pct", "kernel_ms_per_kevent",
                "device_idle_pct"} & set(res["metrics"])
