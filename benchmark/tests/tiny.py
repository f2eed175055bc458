"""A tiny configuration for the harness's CPU tests, placed as new files
in a copy of the benchmark (as a later configuration, mix and metric
would be): `make_root(tmp)` copies BENCHMARK.json and benchmark/ and adds
configs/tiny.json and .py, traffic mixes of its own and cells that name
them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCENE = '''
import numpy as np

from benchmark.harness.scene import SceneSpec, plane, uv_sphere


def scene(cfg):
    s = SceneSpec(camera=dict(cfg["camera"]))
    rng = np.random.default_rng(3)
    s.env = (rng.uniform(0.1, 1.5, (8, 16, 3)) ** 2).astype(np.float32)
    s.directional.append(((0.4, 1.0, 0.2), (1.0, 0.9, 0.8), 2.0))
    floor = s.add_material((0.6, 0.6, 0.6), roughness=0.8)
    s.add_mesh(plane(8.0), floor)
    for i in range(2):
        m = s.add_material((0.8, 0.3 + 0.3 * i, 0.2), roughness=0.2 + 0.5 * i, metallic=0.3 * i)
        s.add_mesh(uv_sphere(0.7, center=(1.6 * i - 0.8, 0.7, 0.0), rings=6, segments=8), m)
    return s
'''

CONFIG = {
    "name": "tiny", "source": "https://example.org/tiny", "reduced": [], "assumed": [],
    "width": 12, "height": 8, "spp": 2, "max_depth": 4,
    "render": {"accel": "auto", "sort_rays": True},
    "camera": {"position": [0.0, 2.0, 5.0], "target": [0.0, 0.5, 0.0], "fov_deg": 45.0},
    "triangles": 194,
}

METRIC = '''
def read(ctx):
    return float(ctx.work["units"])
'''


def make_root(tmp: Path) -> Path:
    """A copy of the benchmark with the tiny configuration's cells added."""
    root = tmp / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    (bench / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (bench / "configs" / "tiny.py").write_text(SCENE)
    (bench / "metrics" / "units_traced.py").write_text(METRIC)
    mixes = {}
    for name in ("frame", "train", "preview", "frame4"):
        path = bench / "traffic" / f"{name}.json"
        if path.exists():
            mix = json.loads(path.read_text())
            mix.update(check_pixels=48, trace_frames=1, trace_steps=1, setup_steps=3)
            (bench / "traffic" / f"tiny_{name}.json").write_text(json.dumps(mix))
            mixes[name] = f"tiny_{name}"
    manifest["configs"].append({"name": "tiny", "source": CONFIG["source"],
                                "file": "benchmark/configs/tiny.json", "reduced": []})
    for name, mix in mixes.items():
        manifest["workloads"].append({"name": f"tiny.{name}", "config": "tiny", "traffic": mix,
                                      "chips": 4 if name == "frame4" else 1,
                                      "why": "harness test"})
    cells = [f"tiny.{n}" for n in mixes]
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            own = {"mrays_per_s": ("frame", "frame4"), "train_step_s": ("train",),
                   "preview_p90_ms": ("preview",)}.get(m["name"], ())
            m["workloads"] += [f"tiny.{x}" for x in own if x in mixes]
    manifest["per_layer"].append({"name": "units_traced", "unit": "units", "better": "higher",
                                  "source": "program_counter", "layer": "harness test",
                                  "moves": "setup_s", "workloads": cells})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root
