"""Graduated verification configs (port of mc_path_tracer_tpu/configs.py).

Each builder returns (scene, camera, render_config, (width, height)) with
the JAX builder's arguments, built from the port's Scene, PerspectiveCamera
and RenderConfig:
  1. sphere + Lambertian + directional light, 64x64, 16 spp, depth 2
  2. cube + sphere with an emissive-quad area light (MIS), 256x256, 64 spp,
     depth 3
  3. Suzanne under the cloudy-sky HDR (env importance sampling), 512x512,
     64 spp, depth 4
  4. GGX roughness sweep, 384x128, 32 spp, depth 3
  5. show-off scene: LBVH, 1920x1080, 250 spp, depth 5

Configs 1 and 3 load the reference's glTF and HDR assets where they exist,
in the directories the JAX configs look in, and otherwise take the same
procedural stand-ins, so every config runs anywhere.
"""

from __future__ import annotations

import os

import numpy as np

from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
from mc_path_tracer_tpu_torch.models.integrator import RenderConfig
from mc_path_tracer_tpu_torch.models.primitives import box, plane, uv_sphere
from mc_path_tracer_tpu_torch.models.scene import Scene
from mc_path_tracer_tpu_torch.utils import native

# the reference checkout's asset directories, where the JAX configs look
REF_ROOT = os.path.join(os.sep, "root", "reference")
REF_MODELS = os.path.join(REF_ROOT, "models")
REF_HDRI = os.path.join(REF_ROOT, "hrdi")


def _maybe(path):
    return path if os.path.exists(path) else None


def config1_sphere_directional():
    """Single sphere, Lambertian diffuse, one directional light (2,304
    triangles without the asset)."""
    s = Scene()
    s.set_environment_color((0, 0, 0), ls=0.0)
    mat = s.add_material(albedo=(0.8, 0.8, 0.8), roughness=1.0, metallic=0.0)
    glb = _maybe(os.path.join(REF_MODELS, "sphere.glb"))
    if glb:
        s.load(glb)
        for i in range(len(s.material_albedo)):
            s.material_roughness[i] = 1.0
            s.material_metallic[i] = 0.0
    else:
        p, n, uv, idx = uv_sphere(1.0, rings=24, segments=48)
        s.add_mesh(p, idx, normals=n, uvs=uv, material_id=mat)
    s.add_directional_light((0.3, 1.0, 0.4), color=(1, 1, 1), ls=3.0)
    cam = PerspectiveCamera(position=np.array([0.0, 0.8, 3.5]),
                            target=np.zeros(3), fov_deg=45.0)
    return s, cam, RenderConfig(spp=16, max_depth=2), (64, 64)


def config2_mis_area_light():
    """Cube + sphere with an emissive-quad area light: MIS of BRDF vs light
    sampling (2 + 12 + 2,304 + 2 = 2,320 triangles)."""
    s = Scene()
    s.set_environment_color((0.02, 0.02, 0.03), ls=1.0)
    floor = s.add_material(albedo=(0.6, 0.6, 0.6), roughness=0.8)
    p, n, uv, idx = plane(20.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    mcube = s.add_material(albedo=(0.7, 0.2, 0.2), roughness=0.4)
    p, n, uv, idx = box((1.2, 1.2, 1.2), center=(-1.0, 0.6, 0.0))
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=mcube)
    msph = s.add_material(albedo=(0.2, 0.4, 0.8), roughness=0.15, metallic=0.3)
    p, n, uv, idx = uv_sphere(0.7, center=(1.0, 0.7, 0.3), rings=24, segments=48)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=msph)
    em = s.add_material(albedo=(0, 0, 0), emissive=(12.0, 11.0, 9.0))
    q = np.array([[-0.8, 3, -0.8], [0.8, 3, -0.8], [0.8, 3, 0.8], [-0.8, 3, 0.8]],
                 np.float32)
    s.add_mesh(q, np.array([[0, 1, 2], [0, 2, 3]]),
               normals=np.tile([[0, -1, 0]], (4, 1)).astype(np.float32),
               material_id=em)
    cam = PerspectiveCamera(position=np.array([0.3, 2.2, 5.0]),
                            target=np.array([0.0, 0.7, 0.0]), fov_deg=40.0)
    return s, cam, RenderConfig(spp=64, max_depth=3), (256, 256)



def config3_suzanne_env():
    """Suzanne under the cloudy-sky HDR with the importance-sampled env
    light (a 4,096-triangle sphere and a procedural HDR without the
    assets)."""
    s = Scene()
    glb = _maybe(os.path.join(REF_MODELS, "Suzanne.glb"))
    if glb:
        s.load(glb)
    else:
        p, n, uv, idx = uv_sphere(1.0, rings=32, segments=64)
        m = s.add_material(albedo=(0.8, 0.7, 0.6), roughness=0.5)
        s.add_mesh(p, idx, normals=n, uvs=uv, material_id=m)
    hdr = _maybe(os.path.join(REF_HDRI, "HDR_029_Sky_Cloudy_Env.hdr"))
    if hdr:
        s.set_environment_hdr(hdr)
    else:
        rng = np.random.default_rng(0)
        tex = (rng.uniform(0.05, 1.0, (64, 128, 3)) ** 2).astype(np.float32)
        tex[16, 40] = [400, 380, 350]
        s.set_environment_hdr(tex)
    cam = PerspectiveCamera(position=np.array([0.0, 0.4, 3.2]),
                            target=np.zeros(3), fov_deg=40.0)
    return s, cam, RenderConfig(spp=64, max_depth=4), (512, 512)


def config4_roughness_sweep():
    """GGX roughness sweep: six spheres on a floor under an HDR environment
    (13,826 triangles)."""
    s = Scene()
    rng = np.random.default_rng(1)
    tex = (rng.uniform(0.1, 1.2, (32, 64, 3)) ** 2).astype(np.float32)
    s.set_environment_hdr(tex)
    floor = s.add_material(albedo=(0.5, 0.5, 0.5), roughness=0.9)
    p, n, uv, idx = plane(40.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    for i in range(6):
        r = 0.05 + 0.18 * i
        m = s.add_material(albedo=(0.9, 0.3, 0.2), roughness=r, metallic=0.0)
        p, n, uv, idx = uv_sphere(0.6, center=(1.5 * (i - 2.5), 0.6, 0.0),
                                  rings=24, segments=48)
        s.add_mesh(p, idx, normals=n, uvs=uv, material_id=m)
    cam = PerspectiveCamera(position=np.array([0.0, 2.2, 7.0]),
                            target=np.array([0.0, 0.5, 0.0]), fov_deg=45.0)
    return s, cam, RenderConfig(spp=32, max_depth=3), (384, 128)


def config5_showoff(bvh_method=native.LBVH):
    """Show-off scene at 1080p / 250 spp / depth 5 with the LBVH builder: a
    plane and a 6x4 grid of UV spheres (96,770 triangles), an HDR
    environment and a directional light."""
    s = Scene()
    s.bvh_method = bvh_method
    rng = np.random.default_rng(0)
    tex = (rng.uniform(0.05, 1.5, (128, 256, 3)) ** 2).astype(np.float32)
    s.set_environment_hdr(tex)
    s.add_directional_light((0.4, 1.0, 0.2), color=(1.0, 0.95, 0.85), ls=4.0)
    floor = s.add_material(albedo=(0.55, 0.55, 0.6), roughness=0.7)
    p, n, uv, idx = plane(60.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    for i in range(6):
        for j in range(4):
            m = s.add_material(
                albedo=(0.2 + 0.12 * i, 0.25 + 0.18 * j, 0.85 - 0.1 * i),
                roughness=0.08 + 0.18 * j, metallic=0.25 * (i % 3),
            )
            p, n, uv, idx = uv_sphere(
                0.65, center=(1.7 * (i - 2.5), 0.65, 1.7 * (j - 1.5)),
                rings=36, segments=56,
            )
            s.add_mesh(p, idx, normals=n, uvs=uv, material_id=m)
    cam = PerspectiveCamera(position=np.array([0.5, 4.5, 10.0]),
                            target=np.array([0.0, 0.5, 0.0]), fov_deg=45.0)
    return s, cam, RenderConfig(spp=250, max_depth=5), (1920, 1080)


ALL_CONFIGS = {
    1: config1_sphere_directional,
    2: config2_mis_area_light,
    3: config3_suzanne_env,
    4: config4_roughness_sweep,
    5: config5_showoff,
}
