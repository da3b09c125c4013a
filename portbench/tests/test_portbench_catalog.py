"""The benchmark is driven by data: every configuration, model, driver,
traffic mix, per-layer metric and limit is found by the name BENCHMARK.json
or a configuration gives it, and a new file of each kind needs no edit
elsewhere. BENCHMARK.json keeps to the contract's form."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

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
    assert callable(catalog.driver(cell["traffic"]))
    model = catalog.model(cell["config"])
    for name in ("param_shapes", "build", "conv_layers", "norm_layers", "reference_forward"):
        assert callable(getattr(model, name))
    serves = cell["traffic"]["driver"] == "serve"
    for name in (("save_artifact", "reference_tiles") if serves else
                 ("data", "train_step", "reference_follow", "resize_layers", "control_quant")):
        assert callable(getattr(model, name))
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


# A second model, as a new configuration brings one: its plain reference
# and its module, which reaches the program (the port's train state, Adam,
# compiled step and patch sampler) for a toy residual denoiser.
TOY_REFERENCE = """
import torch
import torch.nn.functional as F

from portbench.reference import train as ref_train


def param_shapes(cfg):
    w = int(cfg["width"])
    return {"0.weight": (w, 3, 3, 3), "0.bias": (w,), "2.weight": (3, w, 1, 1), "2.bias": (3,)}


def forward(p, x, cfg, dtype=torch.float32, quant=None):
    h = F.relu(F.conv2d(x.permute(0, 3, 1, 2), p["0.weight"], p["0.bias"], padding=1))
    return x + F.conv2d(h, p["2.weight"], p["2.bias"]).permute(0, 2, 3, 1)


def follow(params, images_u8, sample_seed, cfg, steps, dtype, quant=None, loss_rows=None):
    gen = torch.Generator(images_u8.device).manual_seed(int(sample_seed))
    adam, losses, first = ref_train.Adam(params, cfg["train"]["learning_rate"]), [], {}
    for _ in range(steps):
        hr = ref_train.sample_patches(images_u8, gen, cfg["train"]["batch_size"], cfg["patch_size"])
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = torch.mean((forward(leaves, 0.5 * hr, cfg) - hr) ** 2)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss))
        first = first or {k: g.clone() for k, g in grads.items()}
        adam.step(params, grads)
    return {"losses": losses, "first_grad": first, "params": params}
"""
TOY_MODEL = """
import torch

from portbench.lib import inputs
from portbench.reference import toy_denoiser as ref

param_shapes, reference_forward, reference_follow = ref.param_shapes, ref.forward, ref.follow
control_quant = None


def build(cfg, params, dtype, device, remat=False):
    w = int(cfg["width"])
    net = torch.nn.Sequential(torch.nn.Conv2d(3, w, 3, padding=1), torch.nn.ReLU(),
                              torch.nn.Conv2d(w, 3, 1))
    net.load_state_dict(params)
    return net.to(device)


def data(traffic, seed, device):
    c = traffic["corpus"]
    return inputs.corpus(seed, c["images"], c["height"], c["width"], device)


def train_step(cfg, net, images_u8, graph=None):
    from adunet_torch.data.device_cache import sample_patch_batch
    from adunet_torch.train import CompiledStep, create_train_state, make_optimizer

    state = create_train_state(net, make_optimizer(net.parameters(), cfg["train"]["learning_rate"]))

    def body(state, batch, gen):
        hr = sample_patch_batch(images_u8, gen, cfg["train"]["batch_size"], cfg["patch_size"])
        state.optimizer.zero_grad(set_to_none=True)
        x = 0.5 * hr
        loss = torch.mean((x + state.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) - hr) ** 2)
        loss.backward()
        state.update()
        return {"loss": loss.detach()}

    return state, CompiledStep(body, graph)


def conv_layers(cfg, batch, size):
    w = int(cfg["width"])
    return [dict(name="0", n=batch, h=size, w=size, cin=3, cout=w, k=3, block=None, first=True),
            dict(name="2", n=batch, h=size, w=size, cin=w, cout=3, k=1, block=None, first=False)]


def norm_layers(cfg, batch, size):
    return []


def resize_layers(cfg, batch, size):
    return []
"""
RUN_TOY = """
import json, pathlib
from portbench import catalog, run
assert catalog.HERE == pathlib.Path.cwd().resolve() / "portbench", catalog.HERE
print(json.dumps(run.run_cell(catalog.cell("toy_denoiser.toy"), 2147483713, 1.0, True, "cpu")))
"""


def test_a_new_file_of_each_kind_needs_no_edit(tmp_path, monkeypatch):
    root = tmp_path / "portbench"
    shutil.copytree(catalog.HERE, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
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

    # a second model and a new driver (a renamed copy of the train driver)
    (root / "reference" / "toy_denoiser.py").write_text(TOY_REFERENCE)
    (root / "models" / "toy_denoiser.py").write_text(TOY_MODEL)
    (root / "train2_cell.py").write_text((root / "train_cell.py").read_text())
    (root / "configs" / "toy_denoiser.json").write_text(json.dumps(
        {"name": "toy_denoiser", "model": "toy_denoiser", "width": 8, "patch_size": 16,
         "reduced": [], "train": {"batch_size": 4, "dtype": "float32", "learning_rate": 1e-3}}))
    (root / "traffic" / "toy_cache.json").write_text(json.dumps(
        {"name": "toy_cache", "driver": "train2", "why": "a test",
         "corpus": {"images": 4, "height": 32, "width": 32}, "checked_steps": 3,
         "warm_replays": 1, "in_flight": 2}))
    (root / "limits" / "toy_denoiser.toy.json").write_text(json.dumps({"numbers": {
        "loss_gap": {"limit": 1e-4}, "grad_gap": {"limit": 1e-4}, "change_gap": {"limit": 1e-3}}}))
    (root / "metrics" / "steps.toy.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    old = json.loads((tmp_path / "BENCHMARK.json").read_text())
    new = json.loads(json.dumps(old))
    new["configs"].append({"name": "toy_denoiser", "source": "a test",
                           "file": "portbench/configs/toy_denoiser.json", "reduced": [],
                           "why": "a test"})
    new["workloads"].append({"name": "toy_denoiser.toy", "config": "toy_denoiser",
                             "traffic": "toy_cache", "chips": 1, "why": "a test"})
    for m in new["end_to_end"] + new["per_layer"]:
        if m["name"] in ("train_img_per_s", "mfu.train"):
            m["workloads"].append("toy_denoiser.toy")
    new["per_layer"].append({"name": "steps.toy", "unit": "1", "better": "higher",
                             "source": "program_counter", "layer": "l",
                             "moves": "train_img_per_s", "workloads": ["toy_denoiser.toy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    env = dict(os.environ, PYTHONPATH=str(catalog.ROOT), PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", RUN_TOY], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and set(result["metrics"]) == {"mfu.train", "steps.toy"}
    assert "[launches] K1 / K1 backward / K2 / K2 backward / resize a step: 0 / 0 / 0 / 0 / 0" \
        in out.stderr
    # no file of the copy changed; BENCHMARK.json's entries were only appended to
    assert [p for p, b in before.items() if p.name != "BENCHMARK.json" and p.read_bytes() != b] == []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        assert new[section][:len(old[section])] == [
            dict(e, workloads=e["workloads"] + ["toy_denoiser.toy"])
            if e["name"] in ("train_img_per_s", "mfu.train") else e for e in old[section]]
