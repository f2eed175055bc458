"""Where one block's time goes in the PyTorch/CUDA port, on a CUDA GPU.

Renders three 65,536-pixel tile-order blocks of the bench frame (1920x1080,
4 spp, depth 5): block 0 (sky rows), 15 (mid frame) and 31 (the last,
partial block).  Each block runs three times unprofiled (wall seconds, the
first includes warm-up), then once under torch.profiler with CPU and CUDA
activities.  Prints one JSON line per block: wall seconds, device-busy
seconds (sum of device self time), idle share = 1 - busy / fastest wall,
device ms split into closest-hit kernel, any-hit kernel and everything else
(the shading glue), and the number of device kernels run.

    python3 tools/profile_torch_block.py

Imports nothing of JAX.
"""

from __future__ import annotations

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


def main() -> int:
    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.models.integrator import (
        PIXEL_CHUNK,
        RenderConfig,
        camera_params,
        render_tile_radiance,
    )
    from mc_path_tracer_tpu_torch.ops import rng

    name_limit = cs.phase_device()
    device = torch.device("cuda", 0)
    sd = cs.phase_scene(device)
    cam = camera_params(cs.bench_camera(), cs.WIDTH, cs.HEIGHT, device)
    cfg = RenderConfig(spp=cs.SPP, max_depth=cs.DEPTH)
    pxi, pyi = tile_order(cs.WIDTH, cs.HEIGHT)

    def run(px, py):
        render_tile_radiance(sd, cam, cs.WIDTH, cs.HEIGHT, px, py, rng.prng_key(0), cfg)
        torch.cuda.synchronize()

    for blk in BLOCKS:
        sl = slice(blk * PIXEL_CHUNK, (blk + 1) * PIXEL_CHUNK)
        px = torch.from_numpy(pxi[sl].astype("float32")).to(device)
        py = torch.from_numpy(pyi[sl].astype("float32")).to(device)
        walls = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(px, py)
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(px, py)
        device_ms = {"closest": 0.0, "anyhit": 0.0, "other": 0.0}
        kernels = 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if us <= 0:
                continue
            name = ("closest" if "closest_kernel" in e.key
                    else "anyhit" if "anyhit_kernel" in e.key else "other")
            device_ms[name] += us / 1e3
            if e.cpu_time_total == 0:   # a device kernel, not a host op
                kernels += e.count
        busy = sum(device_ms.values()) / 1e3
        print(json.dumps({
            "block": blk, "pixels": px.shape[0], "wall_s": walls, "device_busy_s": busy,
            "idle_share": 1 - busy / min(walls), "device_ms": device_ms,
            "device_kernels": kernels, "card": name_limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
