"""The port's scaling benchmark, the twin of the JAX package's bench_scaling.py:
the bench frame and the bench train step over meshes of 1, 2 and 4 cards.

    python3 -m mc_path_tracer_tpu_torch.bench_scaling
    torchrun --nproc-per-node N -m mc_path_tracer_tpu_torch.bench_scaling --worker DIR

For each mesh of 1, 2, 4, ... cards that the machine has (`make_mesh(n)`),
two routes:

  in-process route  one process; render_sharded and make_train_step(mesh=...)
                 enqueue each card's rows in turn from the one host thread
                 (parallel/render.py).
  process route  one process per card, started here with torchrun's
                 environment (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
                 MASTER_PORT) and joined by NCCL through init_distributed()
                 (one rank: a group of one); each renders its rows with
                 render_sharded_global, rank 0 all-gathers them, and each
                 runs one sharded train step.  `--worker DIR` is one such
                 rank: this script starts them, or torchrun does.

The frame is bench.py's: 1920x1080, 4 spp, depth 5, key 0 (not the JAX
script's 256x128 x 2 spp, which is under one 65,536-pixel block per card
and so cannot show scaling); the train step is the same frame at 1 spp
against a mid-grey target.  Every time is a warm second call, ending in
torch.cuda.synchronize() on every card of the mesh (the process route:
from a barrier to the end of the gather or all-reduce).  Per mesh the keys
of bench_scaling.py (`devices`, `wall_ms`, `mrays_s`, `bitequal_vs_1dev`,
`max_abs_diff_vs_1dev`, against the in-process one-card frame) plus
`efficiency` = t_1 / (n t_n) from the measured walls, t_1 being the same
route's one-card wall, which replaces the JAX script's modelled
projection, and the kernel launches of each card; per step its wall,
forward and backward (the step's kept `mcpt::train.forward` span,
utils/profiling; the rest) and the
largest gradient gap to the in-process one-card step, as a share of the
largest gradient.  `comm_bytes` counts
the film gather and the gradient all-reduce from shapes, as the JAX script
does.  The last line of output is one JSON object with all of it and the
card's name and power limit.  Runs on the card; the functions take
device="cpu" for a CPU mesh (tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import resource
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

WIDTH, HEIGHT, SPP, DEPTH = 1920, 1080, 4, 5
STEP_SPP = 1              # the [grad] bench step's spp
GRAD_TARGET = 0.5         # mid-grey target radiance
GRAD_SHARD_TOL = 1e-5     # sharded gradients: only the order of the sums differs
MESH_SIZES = (1, 2, 4, 8, 16, 32)   # bench_scaling.py's, up to the cards there are
WORKER_TIMEOUT = 900


def bench_scene():
    """bench.py's scene (48,002 triangles) and camera, on the host."""
    from mc_path_tracer_tpu_torch.bench import bench_camera, build_bench_scene

    return build_bench_scene(), bench_camera()


@dataclasses.dataclass(frozen=True)
class Frame:
    """What is rendered: the frame's size, samples and depth, the train
    step's samples, and the scene as "module:function" naming a callable
    that returns (Scene, PerspectiveCamera), so that the process route's
    ranks build it too."""

    width: int = WIDTH
    height: int = HEIGHT
    spp: int = SPP
    depth: int = DEPTH
    step_spp: int = STEP_SPP
    scene: str = "mc_path_tracer_tpu_torch.bench_scaling:bench_scene"

    def rays(self) -> int:
        from mc_path_tracer_tpu_torch.utils.profiling import rays_per_sample

        return self.width * self.height * self.spp * rays_per_sample(self.depth)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def comm_bytes(scene_data, frame: Frame) -> dict:
    """bench_scaling.py's communication census: the film radiance gathered
    per frame (f32) and the parameter gradients all-reduced per step
    (materials' float fields and the environment's texels, f32)."""
    m = scene_data.materials
    grads = 4 * sum(t.numel() for t in (m.albedo, m.roughness, m.metallic, m.fresnel,
                                         m.emissive))
    grads += 4 * scene_data.lights.env.tex.numel()
    return {"film_gather_per_frame": frame.width * frame.height * 3 * 4,
            "param_grad_allreduce_per_step": grads}


def efficiency(t_1: float, n: int, t_n: float) -> float:
    """Strong-scaling efficiency of n devices: t_1 / (n t_n)."""
    return t_1 / (n * t_n)


def grad_gap(got, want) -> float:
    """The largest gap between two gradient lists, each tensor's gap as a
    share of want's largest magnitude (0 where both are 0)."""
    gaps = [0.0]
    for a, b in zip(got, want):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        scale = b.abs().max().item() if b.numel() else 0.0
        gap = (a - b).abs().max().item() if b.numel() else 0.0
        gaps.append(gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf")))
    return max(gaps)


def shard_launches(fn):
    """fn()'s result, with parallel.render's render_tile_radiance wrapped to
    read the launch counters (host counts, no synchronisation) around each
    shard's call: (result, [launches of each shard's call, in call order]),
    every ops.kernels.LAUNCHES key: kernel launches, plain calls and the
    sorted dispatches' sort_perm calls.
    A step's backward replays its samples without that call and is not
    counted here."""
    from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES
    from mc_path_tracer_tpu_torch.parallel import render as prender

    inner, shards = prender.render_tile_radiance, []

    def counted(*args, **kwargs):
        before = dict(LAUNCHES)
        out = inner(*args, **kwargs)
        shards.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        return out

    prender.render_tile_radiance = counted
    try:
        return fn(), shards
    finally:
        prender.render_tile_radiance = inner


def _sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _setup(frame: Frame, device):
    """The frame's scene and camera on `device`, and the train step's pixels
    (every pixel, render()'s tile order) and mid-grey target."""
    import importlib

    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.models.integrator import camera_params

    module, name = frame.scene.split(":")
    scene, camera = getattr(importlib.import_module(module), name)()
    sd = scene.build(device)
    cam = camera_params(camera, frame.width, frame.height, device)
    pxi, pyi = tile_order(frame.width, frame.height)
    px = torch.from_numpy(pxi.astype(np.float32)).to(device)
    py = torch.from_numpy(pyi.astype(np.float32)).to(device)
    target = torch.full((px.shape[0], 3), GRAD_TARGET, device=device)
    return sd, cam, (px, py, target)


def _configs(frame: Frame):
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig

    return (RenderConfig(spp=frame.spp, max_depth=frame.depth),
            RenderConfig(spp=frame.step_spp, max_depth=frame.depth))


def _cpu_s() -> float:
    """This process's CPU seconds so far, every thread's."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    return use.ru_utime + use.ru_stime


def _timed(call, devices):
    """A warm second call(), ending in a synchronize of every card:
    (result, seconds, launches of each shard, the process's CPU seconds
    during the call: the host work that the launches cost)."""
    call()
    _sync(devices)
    cpu0, t0 = _cpu_s(), time.perf_counter()
    out, shards = shard_launches(call)
    _sync(devices)
    return out, time.perf_counter() - t0, shards, _cpu_s() - cpu0


def time_frame(sd, cam, frame: Frame, mesh):
    """A warm second render_sharded of the frame on `mesh`: (frame [H, W, 3],
    seconds, launches of each shard, host CPU seconds)."""
    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.parallel.render import render_sharded

    cfg, _ = _configs(frame)
    return _timed(lambda: render_sharded(sd, cam, frame.width, frame.height, cfg,
                                         rng.prng_key(0), mesh), mesh.devices)


def time_step(sd, cam, pixels, frame: Frame, mesh):
    """A warm second bench train step on `mesh`: (loss, the 7 gradients,
    seconds, forward seconds, launches of each shard's forward, host CPU
    seconds)."""
    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.parallel.render import make_train_step

    _, cfg = _configs(frame)
    step = make_train_step(cfg, frame.width, frame.height, cfg.spp, mesh=mesh)
    (loss, (mat, ls, tex)), seconds, shards, cpu = _timed(
        lambda: step(sd, cam, *pixels, rng.prng_key(0)), mesh.devices)
    return loss, [*mat, ls, tex], seconds, forward_seconds(), shards, cpu


def forward_seconds() -> float:
    """The host seconds of the last train step's forward (its kept
    `mcpt::train.forward` span)."""
    from mc_path_tracer_tpu_torch.utils.profiling import GLOBAL_TIMINGS

    return GLOBAL_TIMINGS.last("mcpt::train.forward").seconds


def in_process_route(sd, cam, pixels, frame: Frame, meshes) -> tuple[list, list, dict]:
    """Frame and step on each mesh (the first a one-card mesh): per-mesh
    records and the one-card results the others are held against."""
    per_mesh, steps, ref = [], [], {}
    for mesh in meshes:
        n = len(mesh.devices)
        img, wall, launched, cpu = time_frame(sd, cam, frame, mesh)
        img = img.cpu()
        if not ref:
            ref.update(frame=img, wall=wall)
        diff = float((img - ref["frame"]).abs().max())
        per_mesh.append({
            "devices": n, "wall_ms": wall * 1e3, "mrays_s": frame.rays() / wall / 1e6,
            "bitequal_vs_1dev": bool(torch.equal(img, ref["frame"])),
            "max_abs_diff_vs_1dev": diff, "efficiency": efficiency(ref["wall"], n, wall),
            "launches_per_card": launched, "host_cpu_s": cpu})
        log(f"[in-process] frame on {n} card(s): {wall:.3f} s, "
            f"{per_mesh[-1]['mrays_s']:.3f} Mrays/s, efficiency "
            f"{per_mesh[-1]['efficiency']:.3f}, bit-equal {per_mesh[-1]['bitequal_vs_1dev']}, "
            f"host CPU {cpu:.2f} s")
        loss, grads, wall, fwd, launched, cpu = time_step(sd, cam, pixels, frame, mesh)
        if "grads" not in ref:
            ref.update(grads=[g.cpu() for g in grads], step_wall=wall, loss=float(loss))
        steps.append({
            "devices": n, "wall_ms": wall * 1e3, "forward_ms": fwd * 1e3,
            "backward_ms": (wall - fwd) * 1e3,
            "efficiency": efficiency(ref["step_wall"], n, wall), "loss": float(loss),
            "grad_gap_vs_1dev": grad_gap(grads, ref["grads"]),
            "forward_launches_per_card": launched, "host_cpu_s": cpu})
        log(f"[in-process] step on {n} card(s): {wall:.3f} s (forward {fwd:.3f} s), efficiency "
            f"{steps[-1]['efficiency']:.3f}, gradient gap {steps[-1]['grad_gap_vs_1dev']:.3e}, "
            f"host CPU {cpu:.2f} s")
    return per_mesh, steps, ref


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def process_route(n: int, frame: Frame, device: str, ref: dict, out_dir: Path) -> dict:
    """n processes of this module's --worker, given torchrun's environment
    (one card each; gloo for a CPU mesh); rank 0's gathered frame and every
    rank's gradients against the in-process one-card results.  The
    efficiencies are run()'s, from the one-rank record."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "spec.json").write_text(json.dumps(
        {"frame": dataclasses.asdict(frame), "device": device}))
    base = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n))
    repo = str(Path(__file__).resolve().parents[1])
    base["PYTHONPATH"] = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mc_path_tracer_tpu_torch.bench_scaling", "--worker",
         str(out_dir)], env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, text in enumerate(logs):
        for line in text.strip().splitlines()[-6:]:
            log(f"[processes] rank {r}: {line}")
    if [p.returncode for p in procs] != [0] * n:
        # as bench_scaling.py's _measure_dcn: the route's failure is a result
        return {"devices": n, "ok": False,
                "error": f"a rank failed: exit codes {[p.returncode for p in procs]}"}
    ranks = [np.load(out_dir / f"rank{r}.npz", allow_pickle=False) for r in range(n)]
    img = torch.from_numpy(ranks[0]["frame"]).reshape(ref["frame"].shape)
    wall = float(ranks[0]["frame_s"])
    step_wall = float(ranks[0]["step_s"])
    fwd = max(float(got["forward_s"]) for got in ranks)
    rec = {
        "devices": n, "ok": True, "backend": str(ranks[0]["backend"]), "processes_s": seconds,
        "wall_ms": wall * 1e3, "mrays_s": frame.rays() / wall / 1e6,
        "bitequal_vs_1dev": bool(torch.equal(img, ref["frame"])),
        "max_abs_diff_vs_1dev": float((img - ref["frame"]).abs().max()),
        "step_wall_ms": step_wall * 1e3, "forward_ms": fwd * 1e3,
        "backward_ms": (step_wall - fwd) * 1e3,
        "grad_gap_vs_1dev": max(
            grad_gap([torch.from_numpy(got[f"g{i}"]) for i in range(7)], ref["grads"])
            for got in ranks),
        "launches_per_card": [json.loads(str(got["launches"])) for got in ranks],
        "host_cpu_s_per_rank": [{"frame": float(got["frame_cpu_s"]),
                                 "step": float(got["step_cpu_s"])} for got in ranks]}
    log(f"[processes] {n} rank(s) ({rec['backend']}): frame {wall:.3f} s, bit-equal "
        f"{rec['bitequal_vs_1dev']}; step {step_wall:.3f} s (forward {fwd:.3f} s), gradient "
        f"gap {rec['grad_gap_vs_1dev']:.3e}")
    return rec


def worker(out_dir: str) -> int:
    """One rank of the process route, under torchrun's environment: the
    frame's rows of this process's card with render_sharded_global,
    all-gathered (rank 0 keeps the frame), then one sharded train step;
    each part a warm second call timed from a barrier.  The frame is
    out_dir/spec.json's when there is one, else the bench frame on the
    card."""
    import torch.distributed as dist

    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from mc_path_tracer_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from mc_path_tracer_tpu_torch.parallel.render import make_train_step, render_sharded_global

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    spec = out / "spec.json"
    spec = json.loads(spec.read_text()) if spec.exists() else {}
    frame = Frame(**spec.get("frame", {}))
    device = spec.get("device", "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # the camera's unprojection needs full f32
    init_distributed(device=device)
    if not dist.is_initialized():
        # one rank: a group of one, so that it runs what every rank runs
        if "MASTER_PORT" not in os.environ:
            raise RuntimeError("--worker needs torchrun's environment")
        dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method="env://")
    try:
        mesh = make_mesh() if device == "cuda" else make_mesh(devices=[device])
        rank, world = mesh.rank, mesh.world_size
        sd, cam, pixels = _setup(frame, mesh.devices[0])
        cfg, step_cfg = _configs(frame)
        step = make_train_step(step_cfg, frame.width, frame.height, step_cfg.spp, mesh=mesh)

        def render_and_gather():
            rows = render_sharded_global(sd, cam, frame.width, frame.height, cfg,
                                         rng.prng_key(0), mesh)
            gathered = [torch.empty_like(rows) for _ in range(world)]
            dist.all_gather(gathered, rows)
            return torch.cat(gathered)

        timed = {}
        for name, fn in (("frame", render_and_gather),
                         ("step", lambda: step(sd, cam, *pixels, rng.prng_key(0)))):
            fn()
            _sync(mesh.devices)
            dist.barrier()
            reset_launches()
            cpu0, t0 = _cpu_s(), time.perf_counter()
            timed[name] = fn()
            _sync(mesh.devices)
            timed[f"{name}_s"] = time.perf_counter() - t0
            timed[f"{name}_cpu_s"] = _cpu_s() - cpu0
            if name == "frame":
                launches = dict(LAUNCHES)
        loss, (mat, ls, tex) = timed["step"]
        print(f"rank {rank} of {world} on {mesh.devices[0]} ({dist.get_backend()}): frame "
              f"{timed['frame_s']:.3f} s, step {timed['step_s']:.3f} s (forward "
              f"{forward_seconds():.3f} s), frame launches {launches}", flush=True)
        frame_rows = timed["frame"] if rank == 0 else timed["frame"][:0]
        np.savez(out / f"rank{rank}.npz", frame=frame_rows.cpu().numpy(),
                 frame_s=timed["frame_s"], step_s=timed["step_s"],
                 forward_s=forward_seconds(), loss=loss.cpu().numpy(),
                 backend=dist.get_backend(), launches=json.dumps(launches),
                 frame_cpu_s=timed["frame_cpu_s"], step_cpu_s=timed["step_cpu_s"],
                 **{f"g{i}": g.cpu().numpy() for i, g in enumerate([*mat, ls, tex])})
    finally:
        dist.destroy_process_group()
    return 0


def run(device: str = "cuda", frame: Frame = Frame(), sizes=None, out_dir=None) -> dict:
    """Both routes over meshes of 1, 2, 4, ... cards (`sizes`: by default
    MESH_SIZES up to the cards there are and dividing the height; on the
    CPU, shards of the CPU); the result line as a dict."""
    from mc_path_tracer_tpu_torch.bench import card
    from mc_path_tracer_tpu_torch.device import resolve_device
    from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh

    on_card = resolve_device(device).type == "cuda"
    count = torch.cuda.device_count() if on_card else max(sizes or (1,))
    if sizes is None:
        sizes = [s for s in MESH_SIZES if s <= count and frame.height % s == 0]
    torch.backends.cuda.matmul.allow_tf32 = False
    name_limit = card() if on_card else "cpu"
    meshes = [make_mesh(s) if on_card else make_mesh(devices=[device] * s) for s in sizes]
    t0 = time.perf_counter()
    sd, cam, pixels = _setup(frame, meshes[0].devices[0])
    log(f"{frame.scene}: {sd.tris.num_triangles} triangles, built in "
        f"{time.perf_counter() - t0:.2f} s; meshes {list(sizes)} ({name_limit})")
    per_mesh, steps, ref = in_process_route(sd, cam, pixels, frame, meshes)
    if out_dir is None:
        out_dir = Path(__file__).resolve().parents[1] / "build" / "bench_scaling"
    processes = [process_route(n, frame, device, ref, Path(out_dir) / f"procs{n}")
                 for n in sizes]
    one = processes[0]
    for rec in processes:
        if rec["ok"] and one["ok"]:
            n = rec["devices"]
            rec["efficiency"] = efficiency(one["wall_ms"], n, rec["wall_ms"])
            rec["step_efficiency"] = efficiency(one["step_wall_ms"], n, rec["step_wall_ms"])
            log(f"[processes] {n} rank(s): efficiency frame {rec['efficiency']:.3f}, "
                f"step {rec['step_efficiency']:.3f}")
    agree = all(r.get("bitequal_vs_1dev", False) for r in per_mesh + processes)
    grads_ok = all(r.get("grad_gap_vs_1dev", math.inf) <= GRAD_SHARD_TOL
                   for r in steps + processes)
    return {
        "metric": f"sharded render agrees across 1..{sizes[-1]}-card meshes",
        "value": 1.0 if agree and grads_ok else 0.0, "unit": "bool",
        # bench_scaling.py's is its projected multi-host efficiency: here the
        # measured one of the process route's largest mesh
        "vs_baseline": processes[-1].get("efficiency", 0.0),
        "card": name_limit, "platform": "gpu" if on_card else "cpu", "device_count": count,
        "frame": {**dataclasses.asdict(frame), "rays_per_frame": frame.rays()},
        "shards_agree_all_meshes_bitequal": agree,
        "grads_within_tol": grads_ok, "grad_tol": GRAD_SHARD_TOL,
        "per_mesh": per_mesh, "train_step": steps, "process_route": processes,
        "comm_bytes": comm_bytes(sd, frame),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("mc_path_tracer_tpu_torch.bench_scaling",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--worker", metavar="DIR",
                    help="run one rank of the process route under torchrun's environment, "
                         "writing DIR/rank<RANK>.npz")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the scaling benchmark runs on the card")
    result = run()
    print(json.dumps(result))
    return 0 if result["value"] == 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
