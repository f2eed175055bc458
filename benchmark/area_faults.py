"""Faults planted under an area-lit frame cell (config2.frame), for the
harness's tests and for the readings that set its limits: each breaks the
area-light path in one way, and the cell's check has to come out not
correct (PERF.md gives the readings).

    area.unbounded  the shadow ray toward the area sample is not bounded,
                    so the emitter occludes its own light
    area.mis        the BRDF-hit emitter's MIS weight dropped: its pdf
                    reads 0, so the power heuristic gives it weight 1
    area.emission   no emission on primary hits
    area.order      the emitter order handed to the reference reversed

`plant(name, monkeypatch)` installs one through a pytest-style
monkeypatch.  On the card, as calibrate.py reads a faults.py fault:

    python3 benchmark/area_faults.py --workload config2.frame \\
        --fault area.mis --seeds 31 32 33 [--seconds 1] [--out out/area_faults.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _unbounded():
    from mc_path_tracer_tpu_torch.models import integrator

    real = integrator._occluded

    def occluded(scene, route, ro, rd, mask=None, t_max=None):
        return real(scene, route, ro, rd, mask=mask)
    return integrator, "_occluded", occluded


def _mis():
    import torch

    from mc_path_tracer_tpu_torch.models import lights

    real = lights.area_eval_hit

    def eval_hit(area, tris, hit, ray_o):
        li, pdf, on_light = real(area, tris, hit, ray_o)
        return li, torch.zeros_like(pdf), on_light
    return lights, "area_eval_hit", eval_hit


def _emission():
    import torch

    from mc_path_tracer_tpu_torch.models import materials

    def emission(self, material_id, uv=None, atlas=None):
        return torch.zeros((*material_id.shape, 3), dtype=torch.float32,
                           device=material_id.device)
    return materials.MaterialTable, "emission", emission


def _order():
    from benchmark.harness import area_scene

    real = area_scene.emitter_order

    def reversed_order(sd, spec):
        return real(sd, spec)[::-1].copy()
    return area_scene, "emitter_order", reversed_order


FAULTS = {"unbounded": _unbounded, "mis": _mis, "emission": _emission, "order": _order}


def plant(name: str, monkeypatch) -> None:
    group, kind = name.split(".")
    if group != "area":
        raise KeyError(f"no area fault {name!r}")
    obj, attr, value = FAULTS[kind]()
    monkeypatch.setattr(obj, attr, value)


def main(argv=None) -> int:
    from benchmark import calibrate
    from benchmark.harness import card, manifest
    from benchmark.harness.driver import log

    ap = argparse.ArgumentParser("benchmark/area_faults.py")
    ap.add_argument("--workload", default="config2.frame")
    ap.add_argument("--fault", required=True, choices=[f"area.{k}" for k in FAULTS])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    card.require_cards(cell.chips)
    log(f"fault {args.fault} under {cell.name} on {card.name_and_limit()}")
    for seed in args.seeds:
        patches = calibrate._Patches()
        plant(args.fault, patches)
        try:
            line = calibrate.reading(cell, seed, args.seconds)
        finally:
            patches.undo()
        line = json.dumps(dict(line, control=f"fault {args.fault}"))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
