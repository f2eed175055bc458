"""Smoke run of the PyTorch/CUDA port on one GPU: builds the traversal
kernel from csrc/, checks it against its plain PyTorch version on the card,
renders the bench scene at 1920x1080, 4 spp, depth 5 through the kernel,
and checks the kernel route against the plain route on a crop.

    python3 chip_smoke.py

Needs a CUDA GPU and nvcc; fails (non-zero exit, no result line) without
them and on any fault.  Prints one line per phase, then a JSON line of the
kernels (launches on the main path, error against the plain version, times
at the main path's shapes), the card's name and power limit, and last
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT, SPP, DEPTH = 1920, 1080, 4, 5
RAYS_PER_SAMPLE = 1 + (DEPTH - 2) + 2 * (DEPTH - 1)   # bench.py's 12
CHECK_RAYS = 16384
CLOSEST_RAYS = 65536      # one block's closest-hit dispatch
ANYHIT_RAYS = 131072      # one block's fused shadow + visibility dispatch
CROP = 64
SOURCE = "mc_path_tracer_tpu_torch/csrc/traversal.cu"
REPLACES = "mc_path_tracer_tpu/ops/pallas/traversal_kernel.py:892"


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera

    return PerspectiveCamera(
        position=np.array([0.3, 4.0, 9.0]),
        target=np.array([0.0, 0.5, 0.0]), fov_deg=45.0,
    )


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()
    log(f"[device] {name_limit} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    return name_limit


def phase_build():
    from mc_path_tracer_tpu_torch.ops.kernels import build

    _, info = build.load("traversal")
    log(f"[build] {info.path.name}: {info.seconds:.2f} s nvcc")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def phase_scene(device):
    scene = build_bench_scene()
    t0 = time.perf_counter()
    sd = scene.build(device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t = sd.tris.num_triangles
    if t != 48002:
        raise AssertionError(f"bench scene has {t} triangles, expected 48002")
    log(f"[scene] {t} triangles, {sd.bvh.num_nodes} nodes, "
        f"{scene.builder} BVH builder, built in {seconds:.2f} s")
    return sd


def _camera_rays(px, py, device):
    from mc_path_tracer_tpu_torch.models import camera as camera_mod

    cam = dataclasses.replace(bench_camera(), aspect=WIDTH / HEIGHT).params(device)
    lens_u = torch.zeros((px.shape[0], 2), device=device)
    return camera_mod.gen_camera_rays(cam, WIDTH, HEIGHT, px, py, lens_u)


def _bounce_rays(sd, ro, rd, gen, device):
    """Rays leaving the closest hits of (ro, rd) in random directions of the
    upper hemisphere, offset as the integrator offsets extension rays, plus
    the hit mask and the hit record."""
    from mc_path_tracer_tpu_torch.ops import intersect
    from mc_path_tracer_tpu_torch.ops.kernels import traversal

    _, tri_id = traversal.closest_plain(intersect.pack_rays(ro, rd), sd.tris.geo)
    h = intersect.finish_closest(sd.tris, tri_id, ro, rd)
    d = torch.randn(ro.shape, generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    d = torch.where((d * h.normal).sum(-1, keepdim=True) < 0, -d, d)
    return h.position + h.normal * 1e-3, d, h


def _time_ms(fn, reps: int):
    """Mean CUDA-event time of `reps` calls after one warm-up call, and the
    warm-up call's output."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _check_closest(label, rays, kernel, plain):
    """tri_id agreement on live lanes >= 0.999, t rel <= 1e-5 where the ids
    agree, dead lanes miss; returns the max abs t error."""
    (t_k, id_k), (t_p, id_p) = kernel, plain
    live = rays[:, 6] > 0.5
    if not live.any():
        raise AssertionError(f"no live lanes to compare ({label})")
    id_agree = (id_k[live] == id_p[live]).float().mean().item()
    both = (id_k == id_p) & (id_p >= 0)
    t_err = (t_k[both] - t_p[both]).abs()
    t_rel = (t_err / t_p[both].abs().clamp(min=1e-20)).max().item() if both.any() else 0.0
    dead_ok = bool((id_k[~live] == -1).all())
    hit_frac = (id_p[live] >= 0).float().mean().item()
    log(f"[kernel] {label}: closest tri_id agreement {id_agree:.6f} of {int(live.sum())} "
        f"live lanes ({hit_frac:.3f} hit), t max rel {t_rel:.3e}, dead lanes miss: {dead_ok}")
    if id_agree < 0.999 or t_rel > 1e-5 or not dead_ok:
        raise AssertionError(f"closest kernel disagrees with its plain version ({label})")
    return t_err.max().item() if both.any() else 0.0


def _check_anyhit(label, rays, occ_k, occ_p):
    """Occlusion agreement on live lanes >= 0.999, dead lanes unoccluded;
    returns the max abs difference (0 or 1)."""
    live = rays[:, 6] > 0.5
    if not live.any():
        raise AssertionError(f"no live lanes to compare ({label})")
    agree = (occ_k[live] == occ_p[live]).float().mean().item()
    dead_ok = bool((~occ_k[~live]).all())
    occ_frac = occ_p[live].float().mean().item()
    log(f"[kernel] {label}: any-hit agreement {agree:.6f} of {int(live.sum())} live lanes "
        f"({occ_frac:.3f} occluded), dead lanes miss: {dead_ok}")
    if agree < 0.999 or not dead_ok:
        raise AssertionError(f"any-hit kernel disagrees with its plain version ({label})")
    return (occ_k[live].float() - occ_p[live].float()).abs().max().item()


def phase_kernel_check(sd, device, name_limit):
    """The kernel against its plain version on the same rays: a mixed set
    with masked lanes and bounded t_max, then the main path's shapes."""
    from mc_path_tracer_tpu_torch.models.film import tile_order
    from mc_path_tracer_tpu_torch.ops import intersect
    from mc_path_tracer_tpu_torch.ops.kernels import traversal

    gen = torch.Generator(device=device).manual_seed(0)
    nodes, geo = sd.bvh.packed, sd.tris.geo

    # 16,384 camera rays at random pixels + 16,384 bounce rays from their hits
    pix = torch.randint(0, WIDTH * HEIGHT, (CHECK_RAYS,), generator=gen, device=device)
    ro_c, rd_c = _camera_rays((pix % WIDTH).float(), (pix // WIDTH).float(), device)
    ro_b, rd_b, h = _bounce_rays(sd, ro_c, rd_c, gen, device)
    ro = torch.cat([ro_c, ro_b])
    rd = torch.cat([rd_c, rd_b])
    live = torch.rand(ro.shape[0], generator=gen, device=device) > 0.1
    live[CHECK_RAYS:] &= h.hit
    bounded = torch.rand(ro.shape[0], generator=gen, device=device) < 0.3
    t_max = torch.where(
        bounded, torch.rand(ro.shape[0], generator=gen, device=device) * 5.0, 1e32)
    rays = intersect.pack_rays(ro, rd, live, t_max)
    label = f"{2 * CHECK_RAYS} mixed rays"
    errs = {
        "closest": [_check_closest(label, rays, traversal.trace_closest(rays, nodes, geo),
                                   traversal.closest_plain(rays, geo))],
        "anyhit": [_check_anyhit(label, rays, traversal.trace_anyhit(rays, nodes, geo),
                                 traversal.anyhit_plain(rays, geo))],
    }

    # the main path's shapes: one tile-order block of camera rays, its
    # first-bounce extension rays (closest, 65,536 rays), and its shadow
    # rays toward the directional light + visibility rays (any-hit, 131,072
    # rays); each timed, and the timed calls' outputs held against plain
    pxi, pyi = tile_order(WIDTH, HEIGHT)
    blk = slice(15 * CLOSEST_RAYS, 16 * CLOSEST_RAYS)
    px = torch.from_numpy(pxi[blk].astype(np.float32)).to(device)
    py = torch.from_numpy(pyi[blk].astype(np.float32)).to(device)
    ro_c, rd_c = _camera_rays(px, py, device)
    ro_b, rd_b, h = _bounce_rays(sd, ro_c, rd_c, gen, device)
    closest_rays = intersect.pack_rays(ro_b, rd_b, h.hit)
    light = torch.tensor([0.4, 1.0, 0.2], device=device)
    light = (light / light.norm()).expand_as(ro_b)
    shadow_o = h.position + h.normal * 0.01
    anyhit_rays = intersect.pack_rays(
        torch.cat([shadow_o, ro_b]), torch.cat([light, rd_b]),
        torch.cat([h.hit, h.hit]))
    times = {}
    k_ms, k_out = _time_ms(lambda: traversal.trace_closest(closest_rays, nodes, geo), 20)
    p_ms, p_out = _time_ms(lambda: traversal.closest_plain(closest_rays, geo), 2)
    label = f"{CLOSEST_RAYS} path rays"
    errs["closest"].append(_check_closest(label, closest_rays, k_out, p_out))
    times["closest"] = (k_ms, p_ms)
    k_ms, k_out = _time_ms(lambda: traversal.trace_anyhit(anyhit_rays, nodes, geo), 20)
    p_ms, p_out = _time_ms(lambda: traversal.anyhit_plain(anyhit_rays, geo), 2)
    label = f"{ANYHIT_RAYS} path rays"
    errs["anyhit"].append(_check_anyhit(label, anyhit_rays, k_out, p_out))
    times["anyhit"] = (k_ms, p_ms)
    for name, rays_n in (("closest", CLOSEST_RAYS), ("anyhit", ANYHIT_RAYS)):
        k_ms, p_ms = times[name]
        log(f"[kernel] {name} {rays_n} rays: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
            f"({name_limit})")
    return {name: max(e) for name, e in errs.items()}, times


def phase_render(sd, device, name_limit):
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render
    from mc_path_tracer_tpu_torch.ops.kernels import traversal

    cfg = RenderConfig(spp=SPP, max_depth=DEPTH)
    for k in traversal.LAUNCHES:
        traversal.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film = render(sd, bench_camera(), WIDTH, HEIGHT, cfg, device=device)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = dict(traversal.LAUNCHES)
    img = film.radiance_mean()
    finite = bool(torch.isfinite(img).all())
    mean = img.mean().item()
    spread = img.std().item()
    log(f"[render] {WIDTH}x{HEIGHT} {SPP} spp depth {DEPTH}: frame {frame_s:.3f} s, "
        f"{WIDTH * HEIGHT * SPP * RAYS_PER_SAMPLE / frame_s / 1e6:.3f} Mrays/s at "
        f"{RAYS_PER_SAMPLE} rays/sample ({name_limit}); launches {launches}; "
        f"image mean {mean:.5f} std {spread:.5f}")
    if not finite or mean <= 0.0 or spread <= 0.0:
        raise AssertionError("rendered image is not finite, dark or uniform")
    if launches["closest"] == 0 or launches["anyhit"] == 0 or launches["plain"] != 0:
        raise AssertionError(f"main path did not run through the kernel: {launches}")
    return launches, frame_s


def phase_route_parity(sd, device):
    from mc_path_tracer_tpu_torch.models.integrator import (
        RenderConfig,
        camera_params,
        render_tile_radiance,
    )
    from mc_path_tracer_tpu_torch.ops import rng

    x0, y0 = (WIDTH - CROP) // 2, (HEIGHT - CROP) // 2
    ys, xs = torch.meshgrid(torch.arange(CROP), torch.arange(CROP), indexing="ij")
    px = (xs.reshape(-1) + x0).float().to(device)
    py = (ys.reshape(-1) + y0).float().to(device)
    cam = camera_params(bench_camera(), WIDTH, HEIGHT, device)
    key = rng.prng_key(0)
    out = {}
    for accel in ("auto", "brute"):
        cfg = RenderConfig(spp=SPP, max_depth=DEPTH, accel=accel)
        out[accel] = render_tile_radiance(sd, cam, WIDTH, HEIGHT, px, py, key, cfg)
    a, b = out["auto"], out["brute"]
    diff = (a - b).abs()
    agree = (diff <= 1e-3 * b.abs() + 1e-6).all(dim=-1).float().mean().item()
    log(f"[parity] {CROP}x{CROP} crop, kernel vs plain route: max abs diff "
        f"{diff.max().item():.3e}, {agree:.4f} of pixels within rel 1e-3")
    if not bool(torch.isfinite(a).all()) or agree < 0.99:
        raise AssertionError("kernel route and plain route disagree")


def main() -> int:
    name_limit = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    sd = phase_scene(device)
    errs, times = phase_kernel_check(sd, device, name_limit)
    launches, _ = phase_render(sd, device, name_limit)
    phase_route_parity(sd, device)
    jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
    if jax_mods:
        raise AssertionError(f"the port loaded JAX modules: {jax_mods[:5]}")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("closest", "anyhit")
    ]
    print(json.dumps({"kernels": kernels}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
