"""Command-line renderer (port of mc_path_tracer_tpu/cli.py).

Examples:
  python3 -m mc_path_tracer_tpu_torch --demo --out demo.png
  python3 -m mc_path_tracer_tpu_torch --demo --mode rasterizer --size 1920x1080 --out preview.png
  python3 -m mc_path_tracer_tpu_torch --demo --size 64x48 --spp 4 --device cpu --out demo.png

The options, defaults and choices are the JAX package's, plus `--device`
(default "cuda"): the port renders on the card unless asked for the CPU,
and raises without a card.  The JAX package's compile cache has no
counterpart.  The printed Mrays/s counts depth*2 + 2 rays per sample, as
the JAX command line does, which is not utils.profiling.rays_per_sample
(the two agree at depth 5, 12, but at depth 2 this counts 6 and
rays_per_sample 3).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser("mc_path_tracer_tpu_torch")
    p.add_argument("--scene", help=".glb scene file")
    p.add_argument("--demo", action="store_true", help="use the built-in demo scene")
    p.add_argument("--hdr", help="equirect .hdr environment map")
    p.add_argument("--env-ls", type=float, default=1.0)
    p.add_argument("--sun", help="directional light dir as x,y,z")
    p.add_argument("--sun-ls", type=float, default=5.0)
    p.add_argument("--size", default="512x512")
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--mode", default="path_tracer",
                   choices=["path_tracer", "rasterizer", "wireframe", "debug"])
    p.add_argument("--view", default="color", choices=["color", "heatmap"],
                   help="display transform (heatmap = the debug luminance view)")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--camera", help="pos as x,y,z", default="0,2,6")
    p.add_argument("--target", help="look-at as x,y,z", default="0,0,0")
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--lens-radius", type=float, default=0.0)
    p.add_argument("--focal", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quirks", action="store_true",
                   help="replicate reference estimator quirks")
    p.add_argument("--out", default="render.png")
    p.add_argument("--out-hdr", help="also save linear radiance as .npy")
    p.add_argument("--interactive", action="store_true",
                   help="live terminal viewer: wasdeq move, arrows look, "
                        "x quits (progressive restart on every move)")
    p.add_argument("--interactive-seconds", type=float, default=120.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cpu to run without a card)")
    return p


def _vec(s):
    return np.asarray([float(x) for x in s.split(",")], np.float32)


def demo_scene(scene):
    """The built-in demo: a 40 m floor and three 0.8 m spheres of rising
    roughness, the first half metallic."""
    from mc_path_tracer_tpu_torch.models.primitives import plane, uv_sphere

    floor = scene.add_material(albedo=(0.7, 0.7, 0.7), roughness=0.9)
    p, n, uv, idx = plane(40.0)
    scene.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    for i, r in enumerate((0.05, 0.3, 0.7)):
        m = scene.add_material(albedo=(0.8, 0.4, 0.25), roughness=r,
                               metallic=0.5 * (i == 0))
        p, n, uv, idx = uv_sphere(0.8, center=(2.0 * (i - 1), 0.8, 0))
        scene.add_mesh(p, idx, normals=n, uvs=uv, material_id=m)
    return scene


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    from mc_path_tracer_tpu_torch.device import resolve_device
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
    from mc_path_tracer_tpu_torch.models.engine import RenderEngine
    from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
    from mc_path_tracer_tpu_torch.models.scene import Scene
    from mc_path_tracer_tpu_torch.ops import rng
    from mc_path_tracer_tpu_torch.utils.image import write_hdr_npy

    device = resolve_device(args.device)
    scene = Scene()
    if args.demo or not args.scene:
        demo_scene(scene)
    else:
        scene.load(args.scene)

    if args.hdr:
        scene.set_environment_hdr(args.hdr, ls=args.env_ls)
    if args.sun:
        scene.add_directional_light(_vec(args.sun), ls=args.sun_ls)
    if not args.sun and not args.hdr:
        scene.add_directional_light((0.4, 1.0, 0.2), ls=args.sun_ls)

    width, height = (int(x) for x in args.size.split("x"))
    cam = PerspectiveCamera(
        position=_vec(args.camera), target=_vec(args.target), fov_deg=args.fov,
        lens_radius=args.lens_radius, focal_distance=args.focal,
    )
    cfg = RenderConfig(spp=args.spp, max_depth=args.depth,
                       reference_quirks=args.quirks)

    if args.interactive:
        from mc_path_tracer_tpu_torch.models.interactive import FlyCamera, InteractiveViewer

        pos = _vec(args.camera).astype(np.float64)
        look = _vec(args.target).astype(np.float64) - pos
        look /= max(np.linalg.norm(look), 1e-8)
        fly = FlyCamera(
            position=pos, fov_deg=args.fov,
            yaw_deg=float(np.degrees(np.arctan2(look[2], look[0]))),
            pitch_deg=float(np.degrees(np.arcsin(np.clip(look[1], -1, 1)))),
        )
        viewer = InteractiveViewer(scene, width=width, height=height,
                                   cfg=cfg, fly=fly, device=device)
        viewer.run_tty(max_seconds=args.interactive_seconds)
        return 0

    t0 = time.time()
    film = RenderEngine().render(
        scene, cam, width, height, mode=args.mode, cfg=cfg,
        key=rng.prng_key(args.seed), device=device,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    # debug mode renders its own single-bounce visualizer (with its own
    # heat map on miss pixels); --view heatmap applies to any output
    view = "heatmap" if args.view == "heatmap" else "color"
    film.save_png(args.out, exposure=args.exposure, view=view)
    if args.out_hdr:
        write_hdr_npy(args.out_hdr, film.radiance_mean())
    # depth*2 + 2 rays per sample, as the JAX command line counts them
    rays = width * height * args.spp * (args.depth * 2 + 2)
    print(f"wrote {args.out}  [{width}x{height}, {args.spp}spp, "
          f"{dt:.2f}s, ~{rays/dt/1e6:.1f} Mrays/s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
