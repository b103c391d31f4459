"""A cell as data: everything a run needs is found by name from
`BENCHMARK.json` and files under the benchmark's directory.

- the configuration: the `file` of its entry in `configs`, a scene
  description whose every camera, material, shape and light names a kind
  file `kinds/<group>/<kind>.py` (reference/kinds.py);
- the traffic mix: `traffic/<traffic>.json`, whose `kind` names the
  traffic kind `kinds/traffic/<kind>.py` that drives the program's
  window and compares what it produced with the reference;
- the cell's own settings: `cells/<workload>.json`, the check's pixels a
  pass (`check_pixels`), the (pass, pixel) pairs the reference follows
  at most in a run (`check_pairs`), the passes the traced run profiles
  (`trace_passes`), the warm-up passes of set-up (`warmup_passes`) and
  the limits of the numbers the check compares (`limits`);
- each metric: a reader `metrics/<metric>.py` that defines
  `read(run) -> float | None` (None: nothing to read, the metric is left
  out of the line) and, where it needs them, `SPANS` (the integrator's
  calls it times) and `KERNELS` (substrings of kernel names).

A metric belongs to a cell when its entry has no `workloads` key or
lists the cell.
"""
from __future__ import annotations

import json
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple

from reference.kinds import load_file, load_kind

HERE = Path(__file__).resolve().parent.parent  # the benchmark's directory


class Metric(NamedTuple):
    name: str
    unit: str
    entry: dict
    reader: ModuleType


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    job: ModuleType      # the traffic kind
    settings: dict       # the cell file's settings
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path  # the benchmark's directory


def load_module(path: Path) -> ModuleType:
    """A metric's reader file by path."""
    if not path.is_file():
        raise FileNotFoundError(f"no metric reader {path}")
    mod = load_file(path)
    if not callable(getattr(mod, "read", None)):
        raise ValueError(f"{path} defines no read(run)")
    return mod


def _metrics(entries: list, cell: str, root: Path) -> List[Metric]:
    return [Metric(e["name"], e["unit"], e,
                   load_module(root / "metrics" / f"{e['name']}.py"))
            for e in entries if cell in e.get("workloads", [cell])]


def load_cell(name: str, benchmark: Path, root: Path = HERE) -> Cell:
    spec = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((benchmark.parent / configs[w["config"]]["file"])
                        .read_text())
    traffic = json.loads(
        (root / "traffic" / f"{w['traffic']}.json").read_text())
    job = load_kind(root, "traffic", traffic.get("kind"))
    job.validate(traffic)
    settings = json.loads((root / "cells" / f"{name}.json").read_text())
    limits = settings.pop("limits")
    if set(limits) != set(job.NUMBERS):
        raise ValueError(f"{name}: limits {sorted(limits)} are not the "
                         f"numbers {sorted(job.NUMBERS)} its traffic compares")
    return Cell(name, int(w["chips"]), config, traffic, job, settings,
                limits, _metrics(spec["end_to_end"], name, root),
                _metrics(spec["per_layer"], name, root), root)
