"""Find a cell's files by name: ``BENCHMARK.json`` at the checkout's root
names the cell's configuration and traffic mix and the per-layer metrics;
each lives in a file of its own under this folder:

- ``configs/<config>.json`` (the sizes as run; ``model`` names the model
  module),
- ``models/<model>.py`` (the one place where the benchmark reaches that
  model in the program, and the plain reference it is held to),
- ``traffic/<traffic>.json`` (the mix's parameters; ``driver`` names the
  general generator that reads it, ``<driver>_cell.py``: ``train`` or
  ``serve``),
- ``metrics/<metric>.py`` (a reader with ``read(ctx) -> float | None``),
- ``limits/<workload>.json`` (the limit of each number the correctness
  check compares, and the readings it was set from).

A new file of any kind needs no edit elsewhere. A new configuration adds
``configs/<name>.json``; ``models/<model>.py`` and its reference under
``reference/`` if its model is new; ``traffic/<mix>.json``, and
``<driver>_cell.py`` if the mix needs a new driver; ``limits/<cell>.json``;
and readers under ``metrics/``. In ``BENCHMARK.json`` it only appends: its
``configs`` and ``workloads`` entries, its cell's name to the ``workloads``
of each end-to-end and shared per-layer metric it reports, and new
``per_layer`` entries.

A model module gives the drivers what is model-specific, and they put into
the readers' ``ctx`` what it returns:

- ``param_shapes(cfg)``: every parameter's name and shape, in the order
  ``lib.inputs.weights`` draws them (its rules go by name: a 4-D leaf is a
  conv kernel, a name holding ``.norm`` a norm's scale or offset);
- ``build(cfg, params, dtype, device, remat)``: the program's model holding
  ``params``;
- ``data(traffic, seed, device)``: what the train step samples;
- ``train_step(cfg, net, data, graph=None)``: ``(state, step)``, the
  program's step, called ``step(state, None, generator)``;
- ``reference_follow(params, data, sample_seed, cfg, steps, dtype, quant,
  loss_rows)`` and ``reference_forward(params, x, cfg, dtype, quant)``: the
  plain reference; ``control_quant``: the training control's rounding;
- ``conv_layers``, ``norm_layers``, ``resize_layers(cfg, batch, size)``: the
  layer shapes the readers count work from;
- for serving, ``save_artifact(net, out_dir, cfg)`` and
  ``reference_tiles(cfg, seed, x_u8, device, tf32)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(path: Optional[Path] = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def model(cfg: dict):
    """The model module that ``cfg``'s ``model`` key names."""
    return importlib.import_module(f"portbench.models.{cfg['model']}")


def driver(mix: dict):
    """The ``run(cell, seed, seconds, trace, device, log)`` of the driver
    that the traffic mix's ``driver`` key names."""
    return importlib.import_module(f"portbench.{mix['driver']}_cell").run


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    return metric_module(name).read


def cell(workload: str, bench: Optional[dict] = None) -> dict:
    """The cell's entry, configuration, traffic, end-to-end and per-layer
    metric entries (those that report in it) and limits."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def reports(metric: dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    end_to_end: List[Dict] = [m for m in bench["end_to_end"] if reports(m)]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in names and ("workloads" not in m or workload in m["workloads"])]
    return {"workload": entry, "config": config(entry["config"]),
            "traffic": traffic(entry["traffic"]), "end_to_end": end_to_end,
            "per_layer": per_layer, "limits": limits(workload)}
