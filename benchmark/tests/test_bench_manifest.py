"""BENCHMARK.json and the files it names: the contract's names, units,
lengths and cross references; every metric has its reader."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["benchmark"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_and_units(bench):
    names = []
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for c in bench["configs"]:
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    names += [c["name"] for c in bench["configs"]]
    assert len(set(m["name"] for m in bench["end_to_end"]
                   + bench["per_layer"])) == len(bench["end_to_end"]
                                                 + bench["per_layer"])


def test_free_text_fields(bench):
    texts = [c["why"] for c in bench["configs"] + bench["workloads"]]
    texts += [c["source"] for c in bench["configs"]]
    texts += [m["layer"] for m in bench["per_layer"]]
    texts += bench["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_cross_references(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    used = set()
    for w in bench["workloads"]:
        cfg = configs[w["config"]]
        used.add(w["config"])
        assert os.path.isfile(os.path.join(ROOT, cfg["file"]))
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "cells",
                                           w["traffic"] + ".json"))
        reported = [n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in
                   bench["per_layer"])
    assert used == set(configs)
    assert len({c["file"] for c in configs.values()}) == len(configs)
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        path = os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py")
        assert os.path.isfile(path), path


def test_config_files_name_their_source(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["build"] in ("docs", "digest")
