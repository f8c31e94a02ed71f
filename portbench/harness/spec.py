"""A cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name in ``BENCHMARK.json``:
``configs/<config>.json`` (the file the configuration entry names),
``traffic/<traffic>.json``, ``metrics/<base>.py`` for a metric named
``<base>`` or ``<base>.<suffix>``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: Path | None = None) -> Cell:
    bench = json.loads((bench_file or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {', '.join(sorted(cells))}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    # a per-layer metric without a "workloads" key is read in every cell
    # that reports the end-to-end metric it moves
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, w["config"], w["traffic"], config, traffic, e2e, per_layer)


def metric_reader(metric_name: str):
    """The ``read(summary, suffix)`` function of a per-layer metric, from
    ``metrics/<base>.py`` for a metric named ``<base>`` or ``<base>.<suffix>``."""
    base, _, suffix = metric_name.partition(".")
    path = BENCH_DIR / "metrics" / f"{base}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {metric_name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return lambda summary: mod.read(summary, suffix)
