"""What a host thread per card does to the bench frame in one process, on
CUDA GPUs: the frame's rows split over 2 and 4 cards (as many as there
are), each card's rows rendered by a thread of its own, against
render_sharded, which enqueues the cards' rows in turn from one thread,
and against one card.

The bench frame is bench.py's (1920x1080, 4 spp, depth 5, key 0).  Each
time is a warm call ending in torch.cuda.synchronize() on every card (the
threaded frame is warmed by the mesh's calls in turn before it), with the
process's CPU seconds (every thread's) over the call; each threaded frame
must be bit-equal to the one-card frame.

    python3 tools/thread_per_card.py

Imports nothing of JAX.
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from mc_path_tracer_tpu_torch import bench_scaling as twin  # noqa: E402
from mc_path_tracer_tpu_torch.bench import card  # noqa: E402
from mc_path_tracer_tpu_torch.models.integrator import render_tile_radiance  # noqa: E402
from mc_path_tracer_tpu_torch.ops import rng  # noqa: E402
from mc_path_tracer_tpu_torch.parallel import render as prender  # noqa: E402
from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh, replicated, tile_sharding  # noqa: E402


def threaded(sd, cam, frame, cfg, mesh) -> torch.Tensor:
    """The frame with each card's rows rendered on a thread of its own,
    gathered on the first card: [H, W, 3]."""
    px, py = prender._pixel_grid(frame.width, frame.height)
    shards = list(zip(mesh.devices, replicated(mesh, sd), replicated(mesh, cam),
                      tile_sharding(mesh, px), tile_sharding(mesh, py)))
    out, errors = [None] * len(shards), []

    def work(i, dev, s, c, pxs, pys):
        try:
            with torch.cuda.device(dev):
                out[i] = render_tile_radiance(s, c, frame.width, frame.height, pxs, pys,
                                              rng.prng_key(0), cfg, cfg.spp)
                torch.cuda.synchronize(dev)
        except BaseException as e:      # re-raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i, *args)) for i, args in enumerate(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    rows = torch.cat([r.to(mesh.devices[0]) for r in out])
    return rows.reshape(frame.height, frame.width, 3)


def timed(fn, devices, warm=True):
    if warm:
        fn()
        twin._sync(devices)
    cpu0, t0 = twin._cpu_s(), time.perf_counter()
    out = fn()
    twin._sync(devices)
    return out, time.perf_counter() - t0, twin._cpu_s() - cpu0


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    frame = twin.Frame()
    cfg, _ = twin._configs(frame)
    sd, cam, _ = twin._setup(frame, torch.device("cuda", 0))
    print(card(), f"{torch.cuda.device_count()} card(s)", flush=True)
    one = make_mesh(1)
    ref, wall, cpu = timed(lambda: prender.render_sharded(
        sd, cam, frame.width, frame.height, cfg, rng.prng_key(0), one), one.devices)
    print(f"1 card: {wall:.3f} s, host CPU {cpu:.2f} s", flush=True)
    ok = True
    for n in (2, 4):
        if n > torch.cuda.device_count():
            break
        mesh = make_mesh(n)
        _, wall_s, cpu_s = timed(lambda: prender.render_sharded(
            sd, cam, frame.width, frame.height, cfg, rng.prng_key(0), mesh), mesh.devices)
        # warmed by the calls in turn: every card's context and kernels are up
        got, wall_t, cpu_t = timed(lambda: threaded(sd, cam, frame, cfg, mesh), mesh.devices,
                                   warm=False)
        equal = bool(torch.equal(got.cpu(), ref.cpu()))
        ok = ok and equal
        print(f"{n} cards: a thread per card {wall_t:.3f} s (efficiency "
              f"{twin.efficiency(wall, n, wall_t):.3f}, host CPU {cpu_t:.2f} s, bit-equal "
              f"{equal}); in turn from one thread {wall_s:.3f} s (efficiency "
              f"{twin.efficiency(wall, n, wall_s):.3f}, host CPU {cpu_s:.2f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
