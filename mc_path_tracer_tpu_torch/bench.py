"""The port's benchmark: Mrays/s at 1920x1080, 4 spp, depth 5 on the bench
scene, timed block by block as the JAX package's bench.py times its own.

    python3 -m mc_path_tracer_tpu_torch.bench [--strided] [--spp N] [--reuse]

Prints one JSON line with bench.py's keys (`metric`, `value`, `unit`,
`vs_baseline`, `traced_mrays_s`, `rays_per_sample`, `frame_s`,
`spp_timed`), unrounded, and beside them `card` (the card's name and power
limit), `block_s` (every timed block's seconds by block index, after
re-measuring), `warmup_s` and `host_cpus` (the host's CPU count and this
process's CPU affinity): the frame is host-bound, so its spread needs
them.  Progress goes to stderr.

What is timed (bench.py:117-183): the frame's pixels in 32x16 tile order,
padded with pixel (0, 0) to whole PIXEL_CHUNK (65,536-pixel) blocks.  The
first block is timed apart as the warm-up (on the card it also pays for
the kernels' nvcc build and lazy loading).  Then every block c is timed
with key fold_in(key, 1_000_000 + c), each ending in
torch.cuda.synchronize(); `--strided` times 8 blocks strided across the
frame instead and scales their mean to the frame.  A block over 3x the
median is re-measured once and the re-measured time is kept.  Rays are
counted by utils.profiling.rays_per_sample (12 at depth 5); with
`--reuse` the traced count is 2 * depth - 1.  `vs_baseline` divides by
bench.py's anchor of 100 Mrays/s.  Runs on the card only.  The blocks are
bench.py's, not `integrator.render`'s: a forward frame renders in
FRAME_CHUNK blocks (one at 1080p, one sample a pass), which this timing
does not see; each 65,536-pixel block here runs its samples in one pass.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mc_path_tracer_tpu_torch.utils.profiling import rays_per_sample

WIDTH, HEIGHT, DEPTH = 1920, 1080, 5
BASELINE_MRAYS = 100.0   # bench.py's anchor
STRIDED_BLOCKS = 8
OUTLIER = 3.0            # a block over OUTLIER x the median is re-measured


def build_bench_scene():
    """bench.py's build_bench_scene through the port's Scene: a 40 m plane
    and a 5x3 grid of UV spheres (48,002 triangles), a 64x128 HDR
    environment and one directional light."""
    from mc_path_tracer_tpu_torch.models.primitives import plane, uv_sphere
    from mc_path_tracer_tpu_torch.models.scene import Scene

    rng = np.random.default_rng(0)
    env = (rng.uniform(0.1, 2.0, size=(64, 128, 3)) ** 2).astype(np.float32)
    s = Scene()
    s.set_environment_hdr(env, ls=1.0)
    s.add_directional_light((0.4, 1.0, 0.2), color=(1.0, 0.95, 0.8), ls=3.0)
    floor = s.add_material(albedo=(0.7, 0.7, 0.7), roughness=0.9)
    p, n, uv, idx = plane(40.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    for i in range(5):
        for j in range(3):
            m = s.add_material(
                albedo=(0.2 + 0.15 * i, 0.3 + 0.2 * j, 0.8 - 0.1 * i),
                roughness=0.1 + 0.2 * j,
                metallic=0.3 * j,
            )
            p, n, uv, idx = uv_sphere(
                0.7, center=(1.8 * (i - 2), 0.7, 1.8 * (j - 1)),
                rings=32, segments=50,
            )
            s.add_mesh(p, idx, normals=n, uvs=uv, material_id=m)
    return s


def bench_camera():
    """bench.py's camera (bench.py:109-115)."""
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera

    return PerspectiveCamera(
        position=np.array([0.3, 4.0, 9.0]),
        target=np.array([0.0, 0.5, 0.0]), fov_deg=45.0,
    )


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed_blocks(n_blocks: int, strided: bool) -> list[int]:
    """Every block, or STRIDED_BLOCKS strided across the frame."""
    if not strided:
        return list(range(n_blocks))
    n_timed = min(STRIDED_BLOCKS, n_blocks)
    stride = max(1, n_blocks // n_timed)
    return list(range(0, n_blocks, stride))[:n_timed]


def outliers(deltas) -> list[int]:
    """Indices of the blocks to re-measure: over OUTLIER x the median."""
    med = float(np.median(deltas))
    return [k for k, d in enumerate(deltas) if d > OUTLIER * med]


def summarize(deltas, n_blocks: int, strided: bool, width: int, height: int, spp: int,
              depth: int, reuse: bool) -> dict:
    """bench.py's result keys from the timed blocks' seconds (re-measured
    where they were): the frame is their sum, or their mean times
    n_blocks when strided."""
    dt_block = float(np.mean(deltas))
    frame_s = dt_block * n_blocks if strided else float(np.sum(deltas))
    reference = rays_per_sample(depth)
    traced = 2 * depth - 1 if reuse else reference
    mrays = width * height * spp * reference / frame_s / 1e6
    return {
        "metric": f"Mrays/s/chip @{height}p depth-{depth}",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / BASELINE_MRAYS,
        "traced_mrays_s": width * height * spp * traced / frame_s / 1e6,
        "rays_per_sample": {"reference": reference, "traced": traced},
        "frame_s": frame_s,
        "spp_timed": spp,
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_blocks(scene_data, cam, cfg, width: int, height: int, strided: bool, log=print):
    """Time the frame's blocks as bench.py does, key 0; returns (warm-up
    seconds, the frame's block count, the timed blocks, their seconds after
    re-measuring outliers)."""
    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.models.integrator import PIXEL_CHUNK, render_tile_radiance
    from mc_path_tracer_tpu_torch.ops import rng

    device = scene_data.tris.v0.device
    key = rng.prng_key(0)
    pxi, pyi = tile_order(width, height)
    pad = (-pxi.shape[0]) % PIXEL_CHUNK
    px = torch.from_numpy(np.concatenate([pxi, np.zeros(pad, pxi.dtype)]).astype(np.float32))
    py = torch.from_numpy(np.concatenate([pyi, np.zeros(pad, pyi.dtype)]).astype(np.float32))
    px, py = px.to(device), py.to(device)
    n_blocks = px.shape[0] // PIXEL_CHUNK

    def block(c, kc):
        s = slice(c * PIXEL_CHUNK, (c + 1) * PIXEL_CHUNK)
        t1 = time.perf_counter()
        render_tile_radiance(scene_data, cam, width, height, px[s], py[s], kc, cfg)
        _sync(device)
        return time.perf_counter() - t1

    warmup = block(0, key)
    log(f"warm-up (first block, build and lazy loading included): {warmup:.3f} s")
    blocks = timed_blocks(n_blocks, strided)
    deltas = []
    t0 = time.perf_counter()
    for c in blocks:
        deltas.append(block(c, rng.fold_in(key, 1_000_000 + c)))
        log(f"block {c}/{n_blocks} done {time.perf_counter() - t0:.2f}s (+{deltas[-1]:.3f}s)")
    for k in outliers(deltas):
        c = blocks[k]
        redo = block(c, rng.fold_in(key, 1_000_000 + c))
        log(f"block {c} re-measured: {deltas[k]:.3f}s -> {redo:.3f}s")
        deltas[k] = redo
    return warmup, n_blocks, blocks, deltas


def run(strided: bool = False, spp: int = 4, reuse: bool = False, log=print) -> dict:
    """Build the bench scene on the card, time its frame and return the
    result line as a dict."""
    from mc_path_tracer_tpu_torch.device import resolve_device
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, camera_params

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # the camera's unprojection needs full f32
    name_limit = card()
    cfg = RenderConfig(spp=spp, max_depth=DEPTH, reuse_brdf_ray=reuse)
    t0 = time.perf_counter()
    scene_data = build_bench_scene().build(device)
    _sync(device)
    log(f"scene: {scene_data.tris.num_triangles} tris, {scene_data.bvh.num_nodes} bvh nodes, "
        f"built in {time.perf_counter() - t0:.2f} s ({name_limit})")
    cam = camera_params(dataclasses.replace(bench_camera(), aspect=WIDTH / HEIGHT),
                        WIDTH, HEIGHT, device)
    warmup, n_blocks, blocks, deltas = time_blocks(scene_data, cam, cfg, WIDTH, HEIGHT, strided,
                                                   log=log)
    out = summarize(deltas, n_blocks, strided, WIDTH, HEIGHT, spp, DEPTH, reuse)
    log(f"steady block: {np.mean(deltas) * 1e3:.1f} ms; frame ({n_blocks} blocks): "
        f"{out['frame_s']:.3f} s; warm-up {warmup:.3f} s")
    out.update(card=name_limit, block_s=dict(zip(map(str, blocks), deltas)),
               warmup_s=warmup,
               host_cpus={"count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("mc_path_tracer_tpu_torch.bench", description=__doc__.splitlines()[0])
    ap.add_argument("--strided", action="store_true",
                    help="time only 8 blocks strided across the frame (the default times every "
                         "block end to end)")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--reuse", action="store_true",
                    help="shared-sample estimator: 2 * depth - 1 traced rays per sample")
    args = ap.parse_args(argv)
    result = run(strided=args.strided, spp=args.spp, reuse=args.reuse,
                 log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
