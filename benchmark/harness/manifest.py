"""BENCHMARK.json and the files it names, found by name alone.

    configs/<config>.json   the configuration as it is run (sizes, camera,
                            render settings, source, reduced, assumed)
    configs/<config>.py     its scene: `scene(cfg) -> harness.scene.SceneSpec`
    traffic/<traffic>.json  the mix's parameters; "driver" names
                            drivers/<driver>.py, whose `run(cell)` runs it
    metrics/<metric>.py     a per-layer metric's reader, `read(ctx)`
    reference/              the plain reference, one module per driver

A later configuration, mix or metric is a new file and a new entry in
BENCHMARK.json; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str | None = None):
    """Import a file of the benchmark by its path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = name or "bench_" + "_".join(path.relative_to(path.parents[1]).with_suffix("")
                                         .parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict          # configs/<config>.json
    traffic_name: str
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # the manifest's end-to-end metrics this cell reports
    per_layer: list       # the manifest's per-layer metrics this cell reports
    bench_dir: Path

    def scene_module(self):
        return load_module(self.bench_dir / "configs" / f"{self.config_name}.py")

    def driver(self):
        return load_module(self.bench_dir / "drivers" / f"{self.traffic['driver']}.py")

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload `name` of root/BENCHMARK.json, with its configuration,
    traffic and the metrics it reports."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[w["config"]]
    bench_dir = root / "benchmark"
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    layer = [m for m in manifest["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, end_to_end=e2e,
                per_layer=layer, bench_dir=bench_dir)
