"""How far a sharded train step's gradients are from the one-card step's, on a
CUDA GPU, and how that depends on where a shard cuts its blocks.

The bench train step (1920x1080, 1 spp, depth 5, mid-grey target, key 0)
on one card, twice (the step is deterministic: the gaps must be 0), then
split into 2 and 4 shards of that card: once with each shard's blocks cut
on the whole frame's block grid (make_train_step's own cut), once cut from
each shard's first row.  Prints, per run, every gradient's largest gap as a
share of its largest magnitude, that magnitude and where the gap is.

    python3 tools/shard_grad_gap.py

Imports nothing of JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from mc_path_tracer_tpu_torch import bench_scaling as twin  # noqa: E402
from mc_path_tracer_tpu_torch.bench import card  # noqa: E402
from mc_path_tracer_tpu_torch.ops import rng  # noqa: E402
from mc_path_tracer_tpu_torch.parallel import render as prender  # noqa: E402
from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

NAMES = ("albedo", "roughness", "metallic", "fresnel", "emissive", "ls", "tex")


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    frame = twin.Frame()
    sd, cam, pixels = twin._setup(frame, torch.device("cuda", 0))
    _, cfg = twin._configs(frame)

    def step(n):
        mesh = make_mesh(devices=["cuda:0"] * n)
        run = prender.make_train_step(cfg, frame.width, frame.height, cfg.spp, mesh=mesh)
        t0 = time.perf_counter()
        loss, (mat, ls, tex) = run(sd, cam, *pixels, rng.prng_key(0))
        torch.cuda.synchronize()
        return float(loss), [g.double().cpu() for g in (*mat, ls, tex)], time.perf_counter() - t0

    def gaps(got, want):
        out = {}
        for name, x, y in zip(NAMES, got, want):
            scale = y.abs().max().item()
            d = (x - y).abs()
            where = tuple(int(i) for i in torch.nonzero(d == d.max())[0]) if scale else ()
            out[name] = (d.max().item() / scale if scale else 0.0, scale, where)
        return out

    print(card(), flush=True)
    ref = step(1)
    print(f"one card: loss {ref[0]!r}, {ref[2]:.2f} s", flush=True)
    print("one card again: gaps", gaps(step(1)[1], ref[1]), flush=True)
    for n in (2, 4):
        got = step(n)
        print(f"{n} shards, blocks on the frame's grid: loss {got[0]!r}, {got[2]:.2f} s, gaps",
              gaps(got[1], ref[1]), flush=True)
    firsts = prender._firsts
    prender._firsts = lambda mesh, rows: [0] * len(mesh.devices)
    try:
        for n in (2, 4):
            print(f"{n} shards, blocks from each shard's first row: gaps",
                  gaps(step(n)[1], ref[1]), flush=True)
    finally:
        prender._firsts = firsts
    return 0


if __name__ == "__main__":
    sys.exit(main())
