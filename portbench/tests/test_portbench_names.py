"""``BENCHMARK.json`` keeps to the contract's shapes: allowed characters in
every name, unit and path, the keys of each entry, and a file for every
configuration, traffic mix, limits and per-layer metric it names."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(".." not in p and not p.startswith("/") for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(one_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert not re.search(r"size|_dim$|_rank$|heads|experts", k)


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    seen, pairs = set(), set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in seen
        seen.add(w["name"])
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "portbench", "limits", w["name"] + ".json"))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    assert {w["config"] for w in bench["workloads"]} == configs


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", []):
            reports = e2e[m["moves"]].get("workloads")
            assert reports is None or w in reports
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or "roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in bench["per_layer"])
