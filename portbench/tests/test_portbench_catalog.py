"""The benchmark is driven by data: every configuration, traffic mix,
per-layer metric and limit is found by the name BENCHMARK.json gives it,
and a new file of each kind needs no edit elsewhere. BENCHMARK.json keeps
to the contract's form."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import catalog

BENCH = catalog.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = catalog.cell(workload)
    assert cell["config"]["name"] == cell["workload"]["config"]
    assert cell["traffic"]["name"] == cell["workload"]["traffic"]
    assert cell["traffic"]["driver"] in ("train", "serve")
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"], "every cell reports a per-layer metric"
    for m in cell["per_layer"]:
        assert m["moves"] in names
        assert callable(catalog.metric_reader(m["name"]))
    assert cell["limits"]["numbers"], "every cell has its correctness limits"


def test_configs_match_their_files():
    for c in BENCH["configs"]:
        data = json.loads((catalog.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"] == []
        assert c["file"].startswith("portbench/")


def test_benchmark_json_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, want in keys.items():
        seen = set()
        for entry in BENCH[section]:
            assert set(entry) - {"workloads"} == want, entry
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and all(w["chips"] == 1 for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_a_new_file_of_each_kind_needs_no_edit(tmp_path, monkeypatch):
    root = tmp_path / "portbench"
    shutil.copytree(catalog.HERE, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((root / "configs" / "sr_flagship.json").read_text())
    cfg["name"] = "sr_wide"
    (root / "configs" / "sr_wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "serve_closed16.json").read_text())
    traffic["name"], traffic["clients"] = "serve_closed4", 4
    (root / "traffic" / "serve_closed4.json").write_text(json.dumps(traffic))
    (root / "metrics" / "requests.serve.py").write_text(
        "def read(ctx):\n    return float(ctx['forwards'])\n")
    (root / "limits" / "sr_wide.serve4.json").write_text(
        json.dumps({"numbers": {"tile_gap": {"limit": 1e-3}}}))
    monkeypatch.setattr(catalog, "HERE", root)
    bench = dict(BENCH)
    bench["workloads"] = [{"name": "sr_wide.serve4", "config": "sr_wide",
                           "traffic": "serve_closed4", "chips": 1, "why": "a test"}]
    bench["end_to_end"] = BENCH["end_to_end"][:1]
    bench["per_layer"] = [{"name": "requests.serve", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "l", "moves": "setup_s"}]
    cell = catalog.cell("sr_wide.serve4", bench)
    assert cell["config"]["name"] == "sr_wide" and cell["traffic"]["clients"] == 4
    assert cell["limits"]["numbers"]["tile_gap"]["limit"] == 1e-3
    assert catalog.metric_reader("requests.serve")({"forwards": 3}) == 3.0
