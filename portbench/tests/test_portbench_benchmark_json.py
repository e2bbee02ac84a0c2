"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC = {"name", "unit", "better", "source"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in BENCH["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert all(NAME.match(r) for r in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]


def test_entries_have_just_their_keys_and_one_line_texts():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")


def test_names_are_unique_and_cross_references_hold():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(configs) == len(BENCH["configs"]) and len(cells) == len(BENCH["workloads"])
    assert len(set(metrics)) == len(metrics)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    assert {w["config"] for w in BENCH["workloads"]} == configs
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for cell in cells:
        mine = lambda ms: {m["name"] for m in ms if cell in m.get("workloads", cells)}
        assert "setup_s" in mine(BENCH["end_to_end"]) and len(mine(BENCH["end_to_end"])) >= 2
        assert mine(BENCH["per_layer"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    with open(os.path.join(ROOT, cfg["file"])) as fh:
        data = json.load(fh)
    for key in cfg["reduced"]:
        assert key in data and key in data["published"]
        assert data[key] != data["published"][key]
    for key, value in data.get("published", {}).items():
        assert key in cfg["reduced"] or data[key] == value
    assert os.path.isfile(os.path.join(ROOT, "portbench", "gen", data["generator"] + ".py"))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(cell):
    bench = os.path.join(ROOT, "portbench")
    with open(os.path.join(bench, "mixes", cell["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    assert mix["batch"] >= 1 and mix["check_calls"] >= 1 and mix["check_colorings"] >= 1
    assert all(len(t["edges"]) == t["n"] - 1 <= mix["n_colors"] for t in mix["templates"])
    with open(os.path.join(bench, "limits", cell["name"] + ".json")) as fh:
        limits = json.load(fh)
    assert limits["est_rel_gap"]["limit"] > 0
    for m in BENCH["per_layer"]:
        if cell["name"] in m.get("workloads", [cell["name"]]):
            assert os.path.isfile(os.path.join(bench, "metrics", m["name"] + ".py"))
