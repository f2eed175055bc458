"""Shaded previews in a closed loop, like an editor user dragging the view.

Each call renders one frame of `models.preview.render_preview(mode=
"shaded")` at the configuration's size on the built scene, from a camera
that orbits the configuration's target about the vertical axis: frame
i's angle is frame i - 1's plus a step drawn from the seed, uniform in
+-`max_step_deg`.  Its latency runs from the call (the camera's matrices
included) to the frame's uint8 pixels on the host.  The window runs whole
frames until `--seconds` have passed; preview_p90_ms is the 90th
percentile of every frame's latency.  A traced run traces `trace_frames`
frames.

Set-up: the scene's build and one preview frame from the first camera.

Check: `check_pixels` pixels drawn from the seed, spread over the
window's frames, against reference/preview.py from the same cameras.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark.harness import compare, driver, stats
from benchmark.harness.driver import Check, Context, LayerContext, Outcome, Window, log
from benchmark.harness.scene import program_camera
from benchmark.harness.spans import Span

MAX_FRAMES = 100_000


def orbit(cam: dict, angles_deg):
    """Camera dicts: `cam` turned about the vertical axis through its
    target by each angle."""
    p = np.asarray(cam["position"], np.float64)
    t = np.asarray(cam["target"], np.float64)
    out = []
    for a in angles_deg:
        c, s = math.cos(math.radians(a)), math.sin(math.radians(a))
        d = p - t
        pos = t + np.array([c * d[0] + s * d[2], d[1], -s * d[0] + c * d[2]])
        out.append(dict(cam, position=[float(x) for x in pos]))
    return out


def angles(seed: int, n: int, max_step: float):
    steps = np.random.default_rng(seed).uniform(-max_step, max_step, n)
    steps[0] = 0.0
    return np.cumsum(steps)


def run(ctx: Context) -> Outcome:
    torch = driver.prepare_torch(ctx)
    from mc_path_tracer_tpu_torch.models import preview

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    w, h = cfg["width"], cfg["height"]
    spec = ctx.scene_spec()
    sd = driver.build_scene(ctx, spec)
    turns = angles(ctx.seed, MAX_FRAMES, float(tr["max_step_deg"]))

    def frame(i):
        cam = program_camera(orbit(spec.camera, [turns[i]])[0], w, h, ctx.device)
        film = preview.render_preview(sd, cam, w, h, mode=tr["mode"], device=ctx.device)
        return film.to_uint8()

    frame(0)
    ctx.sync()
    plain0 = driver.plain_calls()
    setup_s = time.perf_counter() - ctx.t_start
    log(f"set-up {setup_s:.2f} s (scene build {ctx.spans.total('scene_build'):.2f} s)")

    images, lat = [], []
    with Window(ctx) as win:
        while True:
            t0 = time.perf_counter()
            images.append(frame(len(images)))
            t1 = time.perf_counter()
            ctx.spans.items.append(Span("preview", t0, t1))
            lat.append(t1 - t0)
            if (ctx.trace and len(images) >= tr["trace_frames"]) or (
                    not ctx.trace and t1 - win.start >= ctx.seconds):
                break
    n = len(images)
    p90 = stats.percentile(lat, 90) * 1e3
    peak = driver.memory_peak(ctx)
    plain = driver.plain_calls() - plain0
    log(f"window: {n} frames in {win.end - win.start:.3f} s; latency p50 "
        f"{stats.percentile(lat, 50) * 1e3:.2f} ms, p90 {p90:.2f} ms with {stats.beyond(lat, 90)} "
        f"frames beyond it; peak {peak} bytes")
    busy = window_s = breakdown = layer = None
    if ctx.trace:
        busy, window_s, breakdown = win.traced()
        layer = LayerContext(events=win.events, busy_s=busy, window_s=window_s,
                             spans=ctx.spans, work={"units": n, "frames": n})
    picked = [(f, px, py, images[f][py, px]) for f, (px, py) in enumerate(
        compare.sample_pixels(ctx.seed, w, h, n, tr["check_pixels"]))]
    del images, sd, frame
    driver.release(ctx)
    checks, numbers = check_previews(ctx, spec, cfg, turns, picked, tr["limits"])
    if ctx.device == "cuda":
        checks.append(Check("plain_calls", plain, 0))
    return Outcome(e2e={"setup_s": setup_s, "preview_p90_ms": p90}, checks=checks, attempted=n,
                   failed=0, memory_peak_bytes=peak, layer=layer, busy_s=busy,
                   window_s=window_s, breakdown=breakdown, numbers=numbers)


def check_previews(ctx, spec, cfg, turns, picked, limits):
    import torch

    from benchmark.reference import frame as ref_frame
    from benchmark.reference import preview as ref_preview
    from benchmark.reference import scene as ref_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    scene = ref_scene.build(spec, ctx.device)
    got, want = [], []
    for f, px, py, u8 in picked:
        cam = ref_scene.camera(spec, cfg["width"], cfg["height"], ctx.device,
                               cam=orbit(spec.camera, [turns[f]])[0])
        with torch.no_grad():
            rad = ref_preview.shaded(
                scene, cam, torch.as_tensor(px, dtype=torch.float32, device=ctx.device),
                torch.as_tensor(py, dtype=torch.float32, device=ctx.device))
        want.append(ref_frame.reinhard_u8(rad, 1.0).cpu().numpy())
        got.append(u8)
    numbers = compare.bytes_(np.concatenate(got), np.concatenate(want))
    log(f"reference: {sum(len(p[1]) for p in picked)} pixels in "
        f"{time.perf_counter() - t0:.1f} s; numbers {numbers}")
    return [Check(k, numbers[k], v) for k, v in limits.items()], numbers
