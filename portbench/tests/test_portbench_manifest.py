"""BENCHMARK.json against the benchmark's rules, and every cell's files
found by name."""
from __future__ import annotations

import importlib.util
import os
import re

import pytest

from portbench import run

ROOT = run.ROOT
BENCH = run.load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_entry_keys(group):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[group]
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        extra = set(e) - keys
        assert set(e) >= keys and extra <= {"workloads"}, e["name"]
        if group in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for k in ("why", "layer"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                assert "\t" not in e[k]
        if group == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
            assert 1 <= len(e["why"]) <= 200
        if group == "configs":
            assert 1 <= len(e["source"]) <= 200 and len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])


def test_metric_sources_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_are_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        conf = run.load_json(ROOT, c["file"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert set(c["reduced"]) <= set(conf["program_config"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    data = run.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert (data["config"], data["traffic"], data["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    driver = data["traffic_data"]["driver"]
    assert os.path.isfile(os.path.join(run.HERE, "drivers", driver + ".py"))
    e2e = run.cell_metrics(BENCH, cell, False)
    per = run.cell_metrics(BENCH, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per
    for m in e2e + per:
        if m["name"] == "setup_s":
            continue
        path = os.path.join(run.HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
    assert data["limits"] and all(v > 0 for v in data["limits"].values())


def test_four_card_cells_within_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_layers_named_in_perf_md():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        text = f.read()
    for m in BENCH["per_layer"]:
        assert f"**{m['layer']}**" in text, m["layer"]

