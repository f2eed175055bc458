"""Whole path-traced frames in a closed loop, one caller.

Each call is one frame through `models.integrator.render` at the
configuration's size, samples and depth, then `Film.to_uint8` to the
host; frame i draws key fold_in(seed key, i).  The window runs whole
frames until `--seconds` have passed and finishes the last one;
mrays_per_s is every nominal ray of those frames over the wall from the
window's start to the last frame's end.  A traced run traces
`trace_frames` whole frames instead.

Set-up: the scene's build, then one frame at one sample per pixel (every
block shape of the frame, the kernels' load) and its tone map.

Check: `check_pixels` pixels drawn from the seed, spread over the
window's frames, against reference/frame.py (the same keys, the
reference's own scene arrays): radiance and display bytes.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark.harness import compare, driver, stats
from benchmark.harness.driver import Check, Context, LayerContext, Outcome, Window, log
from benchmark.harness.scene import program_camera
from benchmark.harness.spans import Span
from benchmark.reference import rng

WARM_KEY = 1 << 30   # the warm-up frame's key index, outside the window's


def frame_work(cfg: dict, frames: int) -> dict:
    """The nominal work of `frames` frames of the configuration."""
    from mc_path_tracer_tpu_torch.models.integrator import PIXEL_CHUNK

    w, h, spp, depth = cfg["width"], cfg["height"], cfg["spp"], cfg["max_depth"]
    samples = frames * w * h * spp
    blocks = -(-w * h // PIXEL_CHUNK)
    return {"units": frames, "pixel_samples": samples,
            "rays": frames * stats.nominal_rays(w, h, spp, depth),
            "rays_closest": samples * (depth - 1), "rays_anyhit": samples * 2 * (depth - 1),
            "dispatches": frames * blocks * spp * 2 * (depth - 1),
            "triangles": cfg["triangles"]}


def render_frames(ctx: Context, render, stop):
    """Call `render(i)` -> (ld, u8) for i = 0, 1, ... until stop(count,
    elapsed) after a frame; returns (window, [(ld, u8)])."""
    frames = []
    with Window(ctx) as win:
        while True:
            t0 = time.perf_counter()
            frames.append(render(len(frames)))
            t1 = time.perf_counter()
            ctx.spans.items.append(Span("frame", t0, t1))
            if stop(len(frames), t1 - win.start):
                break
    return win, frames


def check_frames(ctx: Context, spec, cfg: dict, base, picked, limits: dict):
    """Reference radiance and bytes at the picked pixels of each frame
    (picked: [(px, py, the program's rad [k, 3], its u8 [k, 3])]), compared
    with the program's: (checks, every number compare.pixels gives)."""
    import torch

    from benchmark.reference import frame as ref_frame
    from benchmark.reference import scene as ref_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    scene = ref_scene.build(spec, ctx.device)
    cam = ref_scene.camera(spec, cfg["width"], cfg["height"], ctx.device)
    got_rad, got_u8, want_rad, want_u8 = [], [], [], []
    for f, (px, py, rad, u8) in enumerate(picked):
        with torch.no_grad():
            ref = ref_frame.radiance_sum(
                scene, cam, torch.as_tensor(px, dtype=torch.float32, device=ctx.device),
                torch.as_tensor(py, dtype=torch.float32, device=ctx.device),
                rng.fold_in(base, f), cfg["spp"], cfg["max_depth"])
        want_rad.append(ref.cpu().numpy())
        want_u8.append(ref_frame.reinhard_u8(ref, cfg["spp"]).cpu().numpy())
        got_rad.append(rad)
        got_u8.append(u8)
    numbers = compare.pixels(np.concatenate(got_rad), np.concatenate(want_rad),
                             np.concatenate(got_u8), np.concatenate(want_u8))
    log(f"reference: {sum(len(p[0]) for p in picked)} pixels in "
        f"{time.perf_counter() - t0:.1f} s; numbers {numbers}")
    return [Check(name, numbers[name], limit) for name, limit in limits.items()], numbers


def run(ctx: Context) -> Outcome:
    torch = driver.prepare_torch(ctx)
    from mc_path_tracer_tpu_torch.models import integrator

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    w, h = cfg["width"], cfg["height"]
    rcfg = integrator.RenderConfig(spp=cfg["spp"], max_depth=cfg["max_depth"],
                                   **cfg.get("render", {}))
    spec = ctx.scene_spec()
    sd = driver.build_scene(ctx, spec)
    cam = program_camera(spec.camera, w, h, ctx.device)
    base = rng.seed_key(ctx.seed)

    def render(i, key=None, c=rcfg):
        film = integrator.render(sd, cam, w, h, c, key=rng.fold_in(base, i) if key is None
                                 else key, device=ctx.device)
        return film.ld, film.to_uint8()

    render(WARM_KEY, c=dataclasses.replace(rcfg, spp=1))
    ctx.sync()
    plain0 = driver.plain_calls()
    setup_s = time.perf_counter() - ctx.t_start
    log(f"set-up {setup_s:.2f} s (scene build {ctx.spans.total('scene_build'):.2f} s)")

    if ctx.trace:
        def stop(n, _):
            return n >= tr["trace_frames"]
    else:
        def stop(_, elapsed):
            return elapsed >= ctx.seconds
    win, frames = render_frames(ctx, render, stop)
    n = len(frames)
    wall = win.end - win.start
    work = frame_work(cfg, n)
    mrays = stats.rate_per_s(work["rays"], win.start, win.end) / 1e6
    peak = driver.memory_peak(ctx)
    log(f"window: {n} frames in {wall:.3f} s, {mrays:.4f} Mrays/s, peak {peak} bytes; "
        f"frame s {[round(s.seconds, 3) for s in ctx.spans.named('frame')]}")
    plain = driver.plain_calls() - plain0

    picked = []
    for f, (px, py) in enumerate(compare.sample_pixels(ctx.seed, w, h, n, tr["check_pixels"])):
        ld, u8 = frames[f]
        sel_y, sel_x = torch.as_tensor(py, device=ld.device), torch.as_tensor(px, device=ld.device)
        picked.append((px, py, ld[sel_y, sel_x].cpu().numpy(), u8[py, px]))
    busy = window_s = breakdown = layer = None
    if ctx.trace:
        busy, window_s, breakdown = win.traced()
        layer = LayerContext(events=win.events, busy_s=busy, window_s=window_s,
                             spans=ctx.spans, work=work)
    del frames, sd, render
    driver.release(ctx)
    checks, numbers = check_frames(ctx, spec, cfg, base, picked, tr["limits"])
    if ctx.device == "cuda":
        checks.append(Check("plain_calls", plain, 0))
    return Outcome(e2e={"setup_s": setup_s, "mrays_per_s": mrays}, checks=checks,
                   attempted=n, failed=0, memory_peak_bytes=peak, layer=layer,
                   busy_s=busy, window_s=window_s, breakdown=breakdown, numbers=numbers)
