"""Where one block's time goes in the PyTorch/CUDA port, on a CUDA GPU.

Bench path: three 65,536-pixel tile-order blocks of the bench frame
(1920x1080, 4 spp, depth 5): block 0 (sky rows), 15 (mid frame) and 31
(the last, partial block).  Area-light path: config2's whole 256x256 frame
(one 65,536-pixel block) at depth 3 and 8 of its 64 spp, once on the
traversal route (accel="auto") and once on the dense route.  Each block
runs three times unprofiled (wall seconds, the first includes warm-up),
then once under torch.profiler with CPU and CUDA activities.  Prints one
JSON line per block: wall seconds, device-busy seconds (sum of device self
time), idle share = 1 - busy / fastest wall, device ms by kernel (the
port's CUDA kernels by name, everything else as the shading glue) and the
number of device kernels run.

    python3 tools/profile_torch_block.py

Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402

BLOCKS = (0, 15, 31)
REPS = 3
AREA_SPP = 8
# device kernel name fragments, most specific first (dense_closest also
# takes its decode kernel)
KERNEL_NAMES = ("dense_closest", "dense_anyhit", "closest_kernel", "anyhit_kernel",
                "tonemap_kernel")


def profile_block(label, sd, cam, width, height, px, py, cfg, name_limit):
    from mc_path_tracer_tpu_torch.models.integrator import render_tile_radiance
    from mc_path_tracer_tpu_torch.ops import rng

    def run():
        render_tile_radiance(sd, cam, width, height, px, py, rng.prng_key(0), cfg)
        torch.cuda.synchronize()

    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    device_ms = dict.fromkeys([k.removesuffix("_kernel") for k in KERNEL_NAMES] + ["other"], 0.0)
    kernels = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        name = next((k.removesuffix("_kernel") for k in KERNEL_NAMES if k in e.key), "other")
        device_ms[name] += us / 1e3
        if e.cpu_time_total == 0:   # a device kernel, not a host op
            kernels += e.count
    busy = sum(device_ms.values()) / 1e3
    print(json.dumps({
        "block": label, "pixels": px.shape[0], "spp": cfg.spp, "depth": cfg.max_depth,
        "accel": cfg.accel, "wall_s": walls, "device_busy_s": busy,
        "idle_share": 1 - busy / min(walls), "device_ms": device_ms,
        "device_kernels": kernels, "card": name_limit}), flush=True)


def main() -> int:
    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.models.integrator import (
        PIXEL_CHUNK,
        RenderConfig,
        camera_params,
    )

    name_limit = cs.phase_device()
    device = torch.device("cuda", 0)
    sd = cs.phase_scene(device)
    cam = camera_params(cs.bench_camera(), cs.WIDTH, cs.HEIGHT, device)
    cfg = RenderConfig(spp=cs.SPP, max_depth=cs.DEPTH)
    pxi, pyi = tile_order(cs.WIDTH, cs.HEIGHT)
    for blk in BLOCKS:
        sl = slice(blk * PIXEL_CHUNK, (blk + 1) * PIXEL_CHUNK)
        px = torch.from_numpy(pxi[sl].astype("float32")).to(device)
        py = torch.from_numpy(pyi[sl].astype("float32")).to(device)
        profile_block(blk, sd, cam, cs.WIDTH, cs.HEIGHT, px, py, cfg, name_limit)

    sd2, cam2, cfg2 = cs.config2_scene(device)
    size = cs.AREA_SIZE
    cam2 = camera_params(cam2, size, size, device)
    pxi, pyi = tile_order(size, size)
    px = torch.from_numpy(pxi.astype("float32")).to(device)
    py = torch.from_numpy(pyi.astype("float32")).to(device)
    for accel in ("auto", "dense"):
        run_cfg = dataclasses.replace(cfg2, spp=AREA_SPP, accel=accel)
        profile_block("config2", sd2, cam2, size, size, px, py, run_cfg, name_limit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
