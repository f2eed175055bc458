"""Whole frames with the film's rows split over the cards, one process per
card, as users render across cards.

The reporting process is rank 0; it starts ranks 1..N-1 (benchmark/
rank.py) with torchrun's environment and joins them in one NCCL group
(gloo on the CPU, in the harness's tests).  Every rank builds the scene
and renders its rows of each frame with
`parallel.render.render_sharded_global`; the rows are all-gathered and
rank 0 tone-maps the frame to uint8 on the host.  Frame i draws key
fold_in(seed key, i), as in the one-card cell, so the frames are the
same.  Rank 0 decides after each frame whether another follows and
broadcasts it; every rank takes that broadcast as the frame's barrier.

mrays_per_s: every nominal ray of the window's frames over rank 0's wall
from the window's start to the last frame's bytes on the host.  Each
rank's rows time runs from the barrier to its rows being done (a
synchronise); rank 0's gather time from its rows being done to the
gathered frame.  The ranks' spans, busy and window seconds and peaks
reach rank 0 through the process group after the window.

Check: rank 0's gathered frames at pixels drawn from the seed against
the plain reference, as in drivers/frames.py: every rank's rows and their
order in the frame.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from benchmark.drivers import frames as one_card
from benchmark.harness import compare, driver, stats
from benchmark.harness.driver import Check, Context, LayerContext, Outcome, Window, log
from benchmark.harness.scene import program_camera
from benchmark.harness.spans import Span
from benchmark.reference import rng

RANK_SCRIPT = Path(__file__).resolve().parents[1] / "rank.py"
WAIT_S = 300   # how long rank 0 waits for the other ranks to end


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def _watch(procs) -> None:
    """Rank 0's watchdog: a rank that dies with an error leaves the others
    waiting in a collective for ever, so end them all and this process."""
    while True:
        for p in procs:
            code = p.poll()
            if code:
                log(f"a rank ended with exit code {code}: stopping every rank")
                for q in procs:
                    q.kill()
                os._exit(1)
        if all(p.poll() == 0 for p in procs):
            return
        time.sleep(0.5)


def run(ctx: Context) -> Outcome:
    import mc_path_tracer_tpu_torch

    world = ctx.cell.chips
    port = _free_port()
    root = ctx.cell.bench_dir.parent
    program = str(Path(mc_path_tracer_tpu_torch.__file__).resolve().parents[1])
    path = os.pathsep.join(p for p in (program, os.environ.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, str(RANK_SCRIPT), "--root", str(root), "--workload", ctx.cell.name,
         "--seed", str(ctx.seed), "--seconds", str(ctx.seconds), "--trace", str(int(ctx.trace)),
         "--rank", str(r), "--world", str(world), "--port", str(port), "--device", ctx.device,
         "--tf32", str(int(ctx.tf32))],
        env=dict(os.environ, PYTHONPATH=path, **_rank_env(r, world, port)),
        stdout=subprocess.DEVNULL)
        for r in range(1, world)]
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    try:
        os.environ.update(_rank_env(0, world, port))
        out = rank_run(ctx, 0, world, port)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            try:
                p.wait(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return out


def _gather_floats(dist, values, world: int, device) -> list[list[float]]:
    """Every rank's list of floats (one length on every rank), at every rank."""
    import torch

    mine = torch.tensor(values, dtype=torch.float64, device=device)
    got = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(got, mine)
    return [g.cpu().tolist() for g in got]


def rank_run(ctx: Context, rank: int, world: int, port: int):
    """One rank's set-up, window and (on rank 0) report and check."""
    torch = driver.prepare_torch(ctx)
    import torch.distributed as dist

    from mc_path_tracer_tpu_torch.models.film import Film
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
    from mc_path_tracer_tpu_torch.parallel import render as prender
    from mc_path_tracer_tpu_torch.parallel.mesh import init_distributed, make_mesh

    on_card = ctx.device == "cuda"
    init_distributed(f"localhost:{port}", world, rank, backend="nccl" if on_card else "gloo",
                     device=ctx.device)
    try:
        mesh = make_mesh() if on_card else make_mesh(devices=["cpu"])
        device = mesh.devices[0]
        cfg, tr = ctx.cell.config, ctx.cell.traffic
        w, h, spp = cfg["width"], cfg["height"], cfg["spp"]
        rcfg = RenderConfig(spp=spp, max_depth=cfg["max_depth"], **cfg.get("render", {}))
        spec = ctx.scene_spec()
        sd = driver.build_scene(ctx, spec)
        cam = program_camera(spec.camera, w, h, device)
        base = rng.seed_key(ctx.seed)
        samples = torch.empty((h, w), dtype=torch.float32, device=device)

        def frame(i, c=rcfg):
            t0 = time.perf_counter()
            rows = prender.render_sharded_global(sd, cam, w, h, c, rng.fold_in(base, i), mesh)
            ctx.sync()
            t1 = time.perf_counter()
            parts = [torch.empty_like(rows) for _ in range(world)]
            dist.all_gather(parts, rows)
            ctx.sync()
            t2 = time.perf_counter()
            ctx.spans.items.append(Span("rows", t0, t1))
            ctx.spans.items.append(Span("gather", t1, t2))
            if rank != 0:
                return None
            ld = torch.cat(parts).reshape(h, w, 3)
            return ld, Film(ld=ld, samples=torch.full_like(samples, float(c.spp))).to_uint8()

        frame(one_card.WARM_KEY, c=dataclasses.replace(rcfg, spp=1))
        ctx.spans.items[:] = ctx.spans.named("scene_build")
        dist.barrier()
        plain0 = driver.plain_calls()
        setup_s = time.perf_counter() - ctx.t_start
        if rank == 0:
            log(f"set-up {setup_s:.2f} s over {world} ranks")
        kept = []
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        with Window(ctx) as win:
            while True:
                if rank == 0:
                    n = len(kept)
                    go = n < tr["trace_frames"] if ctx.trace else (
                        n == 0 or time.perf_counter() - win.start < ctx.seconds)
                    flag.fill_(int(go))
                dist.broadcast(flag, 0)
                if not int(flag.item()):
                    break
                kept.append(frame(len(kept)))
        n = len(kept)
        rows_s = [s.seconds for s in ctx.spans.named("rows")]
        gather_s = [s.seconds for s in ctx.spans.named("gather")]
        busy = window_s = breakdown = None
        if ctx.trace:
            busy, window_s, breakdown = win.traced()
        mine = [driver.memory_peak(ctx), busy or 0.0, window_s or 0.0,
                driver.plain_calls() - plain0]
        ranks_rows = _gather_floats(dist, rows_s, world, device)
        ranks_misc = _gather_floats(dist, mine, world, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None

    wall = win.end - win.start
    work = one_card.frame_work(cfg, n)
    mrays = stats.rate_per_s(work["rays"], win.start, win.end) / 1e6
    peak = int(max(m[0] for m in ranks_misc))
    plain = sum(m[3] for m in ranks_misc)
    slowest = sum(max(r[f] for r in ranks_rows) for f in range(n))
    mean = sum(sum(r[f] for r in ranks_rows) / world for f in range(n))
    log(f"window: {n} frames in {wall:.3f} s, {mrays:.4f} Mrays/s; rows s by rank "
        f"{[[round(x, 3) for x in r] for r in ranks_rows]}; gather s {gather_s}; "
        f"peaks {[int(m[0]) for m in ranks_misc]}")
    layer = None
    if ctx.trace:
        ranks_busy = [(m[1], m[2]) for m in ranks_misc]
        busy = sum(b for b, _ in ranks_busy) / world
        window_s = sum(x for _, x in ranks_busy) / world
        layer = LayerContext(events=win.events, busy_s=busy, window_s=window_s, spans=ctx.spans,
                             work=work,
                             extra={"ranks": ranks_busy, "shard_spread": slowest / mean,
                                    "gather_ms": 1e3 * sum(gather_s) / n})
    picked = []
    for f, (px, py) in enumerate(compare.sample_pixels(ctx.seed, w, h, n, tr["check_pixels"])):
        ld, u8 = kept[f]
        picked.append((px, py, ld[torch.as_tensor(py, device=ld.device),
                                  torch.as_tensor(px, device=ld.device)].cpu().numpy(),
                       u8[py, px]))
    del kept, sd, frame
    driver.release(ctx)
    checks, numbers = one_card.check_frames(ctx, spec, cfg, base, picked, tr["limits"])
    if on_card:
        checks.append(Check("plain_calls", plain, 0))
    return Outcome(e2e={"setup_s": setup_s, "mrays_per_s": mrays}, checks=checks,
                   attempted=n, failed=0, memory_peak_bytes=peak, layer=layer,
                   busy_s=busy, window_s=window_s, breakdown=breakdown, count=world,
                   numbers=numbers)
