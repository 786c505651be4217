"""BENCHMARK.json against the rules its checks hold it to (names, units,
bounds, run length), and every piece a cell needs found by name."""

import json
import os
import re

import pytest
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_keys_names_and_units(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])


def test_bounds_sources_and_layers(bench):
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    from perfbench import harness

    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        # each per-layer metric moves an end-to-end metric that the cell reports
        assert all(m["moves"] in e2e for m in cell.per_layer)


def test_cells_find_config_mix_limits_and_readers_by_name(bench):
    from perfbench import harness, tracing

    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in bench["paths"])
        assert os.path.exists(os.path.join(ROOT, f))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        assert cell.mix["kind"] in ("serve", "train")
        known = ({"seg_gap", "seg_gap_max", "seg_disagree"} if cell.mix["kind"] == "serve"
                 else {"loss_gap", "grad_gap", "change_gap", "grad_gap_median",
                       "change_gap_median"})
        assert cell.limits and set(cell.limits) <= known
        assert all(v > 0 for v in cell.limits.values())
        for m in cell.per_layer:
            assert callable(tracing.load_reader(os.path.join(ROOT, "perfbench", "metrics"),
                                                m["name"]))


def test_run_seconds_fit_a_full_check_of_24_cells(bench):
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind, key, value", [
    ("serve", "arrival", "open"), ("train", "arrival", "open"),
    ("train", "optimizer", "sgd"), ("train", "loss", "ce"),
    ("train", "augment", "none"), ("train", "scheduler", "step"),
])
def test_a_mix_that_asks_for_what_is_not_implemented_is_refused(bench, kind, key, value):
    from perfbench import drive, harness

    cell = next(harness.Cell(bench, w["name"]) for w in bench["workloads"]
                if harness.Cell(bench, w["name"]).mix["kind"] == kind)
    drive.check_mix(cell.mix)
    with pytest.raises(ValueError, match=key):
        drive.check_mix({**cell.mix, key: value})
