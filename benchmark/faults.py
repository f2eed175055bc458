"""Faults planted in the program under a run, for the harness's tests and
for the readings that set the limits (calibrate.py --fault): each breaks
the timed path in one way a cell can break, and the cell's check has to
come out not correct.

    frame.stale      render hands back its first film for every key
    frame.half       half of the samples left out, the sum scaled back
    frame.altered    every other row's every third pixel 5% brighter
    train.unchanged  the step returns zero gradients: no parameter moves
    train.half       half of the pixels left out, the mean over the rest
    train.altered    the loss 5% high where the step produces it
    preview.stale    the first frame handed back for every camera
    preview.half     the top half of the frame left black
    preview.altered  every other row's every third pixel 30% brighter
    frame4.exchange  rank 0 keeps only its own rows of the gather

`plant(name, monkeypatch)` installs one through a pytest-style
monkeypatch (an object with setattr(obj, name, value)).
"""

from __future__ import annotations

import dataclasses


def _render(kind):
    import torch

    from mc_path_tracer_tpu_torch.models import integrator

    real = integrator.render
    kept = {}

    def render(scene, camera, width, height, cfg=integrator.RenderConfig(), key=None,
               device="cuda"):
        if kind == "stale":
            if "film" not in kept:
                kept["film"] = real(scene, camera, width, height, cfg, key, device)
            return kept["film"]
        if kind == "half":
            half = dataclasses.replace(cfg, spp=max(1, cfg.spp // 2))
            film = real(scene, camera, width, height, half, key, device)
            return film._replace(ld=film.ld * (cfg.spp / half.spp),
                                 samples=torch.full_like(film.samples, float(cfg.spp)))
        film = real(scene, camera, width, height, cfg, key, device)
        ld = film.ld.clone()
        ld[::2, ::3] *= 1.05
        return film._replace(ld=ld)
    return integrator, "render", render


def _train(kind):
    import torch

    from mc_path_tracer_tpu_torch.parallel import render as prender

    real = prender.make_train_step

    def make(cfg, width, height, spp, mesh=None, replay=True):
        step = real(cfg, width, height, spp, mesh=mesh, replay=replay)

        def broken(scene, cam, px, py, target, key):
            if kind == "half":
                r = px.shape[0] // 2
                return step(scene, cam, px[:r], py[:r], target[:r], key)
            loss, (mat, ls, tex) = step(scene, cam, px, py, target, key)
            if kind == "unchanged":
                return loss, (prender.MaterialGrads(*(torch.zeros_like(g) for g in mat)),
                              torch.zeros_like(ls), torch.zeros_like(tex))
            return loss * 1.05, (mat, ls, tex)
        return broken
    return prender, "make_train_step", make


def _preview(kind):
    from mc_path_tracer_tpu_torch.models import preview

    real = preview.render_preview
    kept = {}

    def render(scene, camera, width, height, mode="shaded", device="cuda"):
        if kind == "stale":
            if "film" not in kept:
                kept["film"] = real(scene, camera, width, height, mode, device)
            return kept["film"]
        film = real(scene, camera, width, height, mode, device)
        ld = film.ld.clone()
        if kind == "half":
            ld[: height // 2] = 0.0
        else:
            ld[::2, ::3] *= 1.3
        return film._replace(ld=ld)
    return preview, "render_preview", render


def _exchange(_):
    import torch.distributed as dist

    real = dist.all_gather

    def gather_left_out(parts, tensor, *args, **kwargs):
        out = real(parts, tensor, *args, **kwargs)
        if tensor.dim() == 2:        # the frame's rows: rank 0 keeps its own only
            for p in parts[1:]:
                p.zero_()
        return out
    return dist, "all_gather", gather_left_out


FAULTS = {"frame": _render, "train": _train, "preview": _preview, "frame4": _exchange}


def plant(name: str, monkeypatch) -> None:
    group, kind = name.split(".")
    obj, attr, value = FAULTS[group](kind)
    monkeypatch.setattr(obj, attr, value)
