"""Whole path-traced frames of a scene lit by emitters (config2), in a
closed loop, one caller: drivers/frames.py's loop on an area-lit scene.

Each call is one frame through `models.integrator.render` at the
configuration's size, samples and depth, then `Film.to_uint8` to the
host; frame i draws key fold_in(seed key, i).  Frames render under
`torch.inference_mode()`, as a caller that only looks at the image does:
the frame is launch-bound, and the mode takes the autograd bookkeeping
off every launch (about 8% of a frame's host time on the H100; the
pixels are bit-equal), so a window holds more frames.  The window runs whole
frames until `--seconds` have passed and finishes the last one;
mrays_per_s is every nominal ray of those frames (pixels x spp x
rays_per_sample(depth), as for any frame) over the wall from the
window's start to the last frame's end.  A traced run traces
`trace_frames` whole frames instead.

Set-up: the scene's build (harness/area_scene.to_program, under the
harness's `scene_build` span), the emitter order read from the built
scene (the reference's one input from the program), then one frame at
one sample per pixel and its tone map.

Work count (the per-layer readers' yardstick): the area estimator makes,
per pixel-sample at depth D, 2 (D - 1) closest-hit rays (the camera ray,
D - 1 BRDF rays, D - 2 extension rays) and D - 1 bounded any-hit rays
(the shadow rays), in 3 (D - 1) dispatches per block and sample.

Check: `check_pixels` pixels drawn from the seed, spread over the
window's frames, against reference/area_frame.py (the same keys, the
reference's own scene arrays and the program's emitter order): radiance
and display bytes, under the traffic's limits (frame.json's 0.05 on the
share of pixels off): the two round alike, so a sound run reads 0.0,
while a precision below float32 or a broken area path moves a large
share of the pixels.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmark.drivers.frames import WARM_KEY, frame_work, render_frames
from benchmark.harness import area_scene, compare, driver, stats
from benchmark.harness.driver import Check, Context, LayerContext, Outcome, log
from benchmark.harness.scene import program_camera
from benchmark.reference import rng


def area_work(cfg: dict, frames: int) -> dict:
    """The nominal work of `frames` frames under the area estimator."""
    from mc_path_tracer_tpu_torch.models.integrator import PIXEL_CHUNK

    work = frame_work(cfg, frames)
    depth, samples = cfg["max_depth"], work["pixel_samples"]
    blocks = -(-cfg["width"] * cfg["height"] // PIXEL_CHUNK)
    work.update(rays_closest=samples * 2 * (depth - 1), rays_anyhit=samples * (depth - 1),
                dispatches=frames * blocks * cfg["spp"] * 3 * (depth - 1))
    return work


def check_area_frames(ctx: Context, spec, order, cfg: dict, base, picked, limits: dict):
    """Reference radiance and bytes at the picked pixels of each frame
    (picked: [(px, py, the program's rad [k, 3], its u8 [k, 3])]), every
    frame's pixels traced together, each with its frame's key, and
    compared with the program's: (checks, every number compare.pixels
    gives)."""
    import torch

    from benchmark.reference import area_frame, area_scene as ref_area_scene
    from benchmark.reference import frame as ref_frame
    from benchmark.reference import scene as ref_scene

    t0 = time.perf_counter()
    scene = ref_area_scene.build(spec, order, ctx.device)
    cam = ref_scene.camera(spec, cfg["width"], cfg["height"], ctx.device)
    frame_of = torch.cat([torch.full((len(p[0]),), f, dtype=torch.int64)
                          for f, p in enumerate(picked)])
    keys = rng.fold_in(base, frame_of).to(ctx.device)

    def lanes(i):
        return torch.as_tensor(np.concatenate([p[i] for p in picked]), dtype=torch.float32,
                               device=ctx.device)

    with torch.no_grad():
        ref = area_frame.radiance_sum(scene, cam, lanes(0), lanes(1), keys, cfg["spp"],
                                      cfg["max_depth"])
    numbers = compare.pixels(np.concatenate([p[2] for p in picked]), ref.cpu().numpy(),
                             np.concatenate([p[3] for p in picked]),
                             ref_frame.reinhard_u8(ref, cfg["spp"]).cpu().numpy())
    log(f"reference: {len(frame_of)} pixels of {len(picked)} frames in "
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
    with ctx.spans.span("scene_build", ctx.sync):
        sd = area_scene.to_program(spec).build(ctx.device)
    order = area_scene.emitter_order(sd, spec)
    cam = program_camera(spec.camera, w, h, ctx.device)
    base = rng.seed_key(ctx.seed)

    def render(i, key=None, c=rcfg):
        with torch.inference_mode():
            film = integrator.render(sd, cam, w, h, c, key=rng.fold_in(base, i) if key is None
                                     else key, device=ctx.device)
            return film.ld, film.to_uint8()

    render(WARM_KEY, c=dataclasses.replace(rcfg, spp=1))
    ctx.sync()
    plain0 = driver.plain_calls()
    setup_s = time.perf_counter() - ctx.t_start
    log(f"set-up {setup_s:.2f} s (scene build {ctx.spans.total('scene_build'):.2f} s); "
        f"emitter order {order.tolist()}")

    if ctx.trace:
        def stop(n, _):
            return n >= tr["trace_frames"]
    else:
        def stop(_, elapsed):
            return elapsed >= ctx.seconds
    win, frames = render_frames(ctx, render, stop)
    n = len(frames)
    wall = win.end - win.start
    work = area_work(cfg, n)
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
    checks, numbers = check_area_frames(ctx, spec, order, cfg, base, picked, tr["limits"])
    if ctx.device == "cuda":
        checks.append(Check("plain_calls", plain, 0))
    return Outcome(e2e={"setup_s": setup_s, "mrays_per_s": mrays}, checks=checks,
                   attempted=n, failed=0, memory_peak_bytes=peak, layer=layer,
                   busy_s=busy, window_s=window_s, breakdown=breakdown, numbers=numbers)
