"""Inverse-rendering steps in a closed loop.

The step is `parallel.render.make_train_step(cfg, width, height, spp)`
(each sample replayed in the backward) over every pixel of the frame.
Its target is the configuration rendered in set-up at its own materials
(key fold_in(seed key, TARGET_KEY)); albedo, roughness and metallic start
perturbed by the seed, and after every step a plain SGD update,
clamp(p - lr g), is applied through `with_params`, so no two steps see the
same parameters.  Step i draws key fold_in(seed key, i).  A step is the
loss, the gradients and the update, and ends in a synchronise.

Set-up: the scene's build, the target, and the first `setup_steps`
steps through the same call, state and feed as the window's (the first
step's extra seconds belong to set-up).  The window continues the same
loop until `--seconds` have passed; train_step_s is its wall over its
steps.  A traced run traces `trace_steps` steps.

Check (reference/train.py, the reference's own scene, target and
updates): each of the first three steps' loss, the first step's gradient
norm per leaf (leaves whose reference gradient is under a thousandth of
the median leaf's are left out: they move by round-off alone), and the
norm of each updated leaf's change after the three steps.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import compare, driver
from benchmark.harness.driver import Check, Context, LayerContext, Outcome, Window, log
from benchmark.harness.scene import program_camera
from benchmark.harness.spans import Span
from benchmark.reference import rng

TARGET_KEY = 1 << 30
UPDATED = ("albedo", "roughness", "metallic")


def initial_materials(seed: int, spec, tr: dict) -> dict:
    """Albedo, roughness and metallic perturbed from the configuration's by
    the seed (numpy, [M, 3], [M], [M]); the same sizes for every seed."""
    gen = np.random.default_rng(seed)
    m = len(spec.materials)
    albedo = np.asarray([x["albedo"] for x in spec.materials], np.float32)
    rough = np.asarray([x["roughness"] for x in spec.materials], np.float32)
    p = tr["perturb"]
    return {
        "albedo": np.clip(albedo + gen.normal(0.0, p["albedo_sd"], (m, 3)),
                          *p["albedo_range"]).astype(np.float32),
        "roughness": np.clip(rough + gen.normal(0.0, p["roughness_sd"], m),
                             *p["roughness_range"]).astype(np.float32),
        "metallic": gen.uniform(*p["metallic_range"], m).astype(np.float32),
    }


def leaf_norms(values) -> dict:
    """Euclidean norm per leaf (None for a leaf with no element)."""
    return {k: (float(np.linalg.norm(np.asarray(v, np.float64))) if np.size(v) else None)
            for k, v in values.items()}


def program_leaves(grads) -> dict:
    mat, ls, tex = grads
    return {"albedo": mat.albedo, "roughness": mat.roughness, "metallic": mat.metallic,
            "fresnel": mat.fresnel, "emissive": mat.emissive, "dir_ls": ls, "env_tex": tex}


class Trainer:
    """The training state the set-up drives and the window continues: the
    scene at the current parameters, the step, the feed."""

    def __init__(self, ctx: Context, step, sd, cam, px, py, target, base, tr: dict):
        import torch

        from mc_path_tracer_tpu_torch.parallel import render as prender

        self.torch, self.prender, self.ctx = torch, prender, ctx
        self.step, self.sd, self.cam = step, sd, cam
        self.px, self.py, self.target, self.base = px, py, target, base
        self.lr = float(tr["lr"])
        self.bounds = tr["bounds"]
        self.done = 0

    def advance(self):
        """One step: loss and gradients at the current parameters, the SGD
        update, a synchronise.  Returns (loss, gradients as leaves)."""
        torch = self.torch
        loss, grads = self.step(self.sd, self.cam, self.px, self.py, self.target,
                                rng.fold_in(self.base, self.done))
        mat, ls, tex = self.prender.scene_params(self.sd)
        g = program_leaves(grads)
        new = {k: torch.clamp(getattr(mat, k) - self.lr * g[k], *self.bounds[k]).detach()
               for k in UPDATED}
        self.sd = self.prender.with_params(self.sd, (mat._replace(**new), ls, tex))
        loss = float(loss)
        self.ctx.sync()
        self.done += 1
        return loss, g


def run(ctx: Context) -> Outcome:
    torch = driver.prepare_torch(ctx)
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render_tile_radiance
    from mc_path_tracer_tpu_torch.parallel import render as prender

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    w, h, spp, depth = cfg["width"], cfg["height"], cfg["spp"], cfg["max_depth"]
    rcfg = RenderConfig(spp=spp, max_depth=depth, **cfg.get("render", {}))
    spec = ctx.scene_spec()
    sd_true = driver.build_scene(ctx, spec)
    cam = program_camera(spec.camera, w, h, ctx.device)
    base = rng.seed_key(ctx.seed)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    px = xs.reshape(-1).to(torch.float32).to(ctx.device)
    py = ys.reshape(-1).to(torch.float32).to(ctx.device)
    with torch.no_grad():
        target = render_tile_radiance(sd_true, cam, w, h, px, py, rng.fold_in(base, TARGET_KEY),
                                      rcfg) / spp
    init = initial_materials(ctx.seed, spec, tr)
    mat, ls, tex = prender.scene_params(sd_true)
    start = mat._replace(**{k: torch.as_tensor(v).to(ctx.device) for k, v in init.items()})
    trainer = Trainer(ctx, prender.make_train_step(rcfg, w, h, spp), prender.with_params(
        sd_true, (start, ls, tex)), cam, px, py, target, base, tr)
    del sd_true

    losses, first = [], None
    for i in range(tr["setup_steps"]):
        t0 = time.perf_counter()
        loss, g = trainer.advance()
        losses.append(loss)
        if i == 0:
            first = leaf_norms({k: v.detach().cpu().numpy() for k, v in g.items()})
        log(f"set-up step {i}: loss {loss!r}, {time.perf_counter() - t0:.2f} s")
    m3, _, _ = prender.scene_params(trainer.sd)
    change = leaf_norms({k: getattr(m3, k).cpu().numpy() - init[k] for k in UPDATED})
    plain0 = driver.plain_calls()
    setup_s = time.perf_counter() - ctx.t_start
    log(f"set-up {setup_s:.2f} s (scene build {ctx.spans.total('scene_build'):.2f} s)")

    with Window(ctx) as win:
        while True:
            t0 = time.perf_counter()
            trainer.advance()
            t1 = time.perf_counter()
            ctx.spans.items.append(Span("step", t0, t1))
            n = len(ctx.spans.named("step"))
            if (ctx.trace and n >= tr["trace_steps"]) or (
                    not ctx.trace and t1 - win.start >= ctx.seconds):
                break
    wall = win.end - win.start
    step_s = wall / n
    peak = driver.memory_peak(ctx)
    plain = driver.plain_calls() - plain0
    log(f"window: {n} steps in {wall:.3f} s, {step_s:.4f} s/step, peak {peak} bytes")
    busy = window_s = breakdown = layer = None
    if ctx.trace:
        busy, window_s, breakdown = win.traced()
        layer = LayerContext(events=win.events, busy_s=busy, window_s=window_s,
                             spans=ctx.spans, work={"units": n, "steps": n})
    del trainer
    driver.release(ctx)
    checks, numbers = check_steps(ctx, spec, cfg, tr, base, init, losses, first, change)
    if ctx.device == "cuda":
        checks.append(Check("plain_calls", plain, 0))
    return Outcome(e2e={"setup_s": setup_s, "train_step_s": step_s}, checks=checks,
                   attempted=n, failed=0, memory_peak_bytes=peak, layer=layer, busy_s=busy,
                   window_s=window_s, breakdown=breakdown, numbers=numbers)


def check_steps(ctx, spec, cfg, tr, base, init, losses, first, change):
    """The reference's target and first steps against the program's."""
    import torch

    from benchmark.reference import scene as ref_scene
    from benchmark.reference import train as ref_train

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    w, h, spp, depth = cfg["width"], cfg["height"], cfg["spp"], cfg["max_depth"]
    scene = ref_scene.build(spec, ctx.device)
    cam = ref_scene.camera(spec, w, h, ctx.device)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    px = xs.reshape(-1).to(torch.float32).to(ctx.device)
    py = ys.reshape(-1).to(torch.float32).to(ctx.device)
    target = ref_train.render(scene, cam, px, py, rng.fold_in(base, TARGET_KEY), spp, depth) / spp
    s = scene.with_materials(*(torch.as_tensor(init[k]).to(ctx.device) for k in UPDATED))
    emissive = torch.zeros((len(spec.materials), 3), device=ctx.device)
    bounds = {k: tuple(v) for k, v in tr["bounds"].items()}
    ref_losses, ref_first = [], None
    steps = len(losses)
    for i in range(steps):
        loss, grads = ref_train.loss_and_grads(s, emissive, cam, px, py, target,
                                               rng.fold_in(base, i), spp, depth)
        ref_losses.append(loss)
        if i == 0:
            ref_first = leaf_norms({k: v.cpu().numpy() for k, v in grads.items()})
        s = ref_train.sgd(s, grads, float(tr["lr"]), bounds)
    ref_change = leaf_norms({k: getattr(s, k).cpu().numpy() - init[k] for k in UPDATED})
    counted = compare.counted_leaves(ref_first)
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": compare.worst_leaf(first, ref_first, counted),
        "change_gap": compare.worst_leaf(change, ref_change, list(UPDATED)),
    }
    log(f"reference: {steps} steps in {time.perf_counter() - t0:.1f} s; losses {losses} "
        f"vs {ref_losses}; first-step norms {first} vs {ref_first} (counted {counted}); "
        f"change {change} vs {ref_change}; numbers {numbers}")
    return [Check(k, numbers[k], v) for k, v in tr["limits"].items()], numbers
