"""The port never imports JAX: in a fresh interpreter, import every module of
mc_path_tracer_tpu_torch, render 8x8 on the CPU, and check that no jax
module was loaded (the GPU machine that runs the port has no JAX)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, pkgutil, sys
import numpy as np
import mc_path_tracer_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from mc_path_tracer_tpu_torch.models.primitives import plane, uv_sphere
from mc_path_tracer_tpu_torch import PerspectiveCamera, RenderConfig, Scene, render
s = Scene()
s.set_environment_color((0.4, 0.5, 0.7))
s.add_directional_light((0.3, 1.0, 0.2), ls=2.0)
p, n, uv, idx = plane(10.0)
s.add_mesh(p, idx, normals=n, uvs=uv, material_id=s.add_material(roughness=0.9))
p, n, uv, idx = uv_sphere(0.8, center=(0, 0.8, 0), rings=6, segments=8)
s.add_mesh(p, idx, normals=n, uvs=uv, material_id=s.add_material(albedo=(0.8, 0.3, 0.2)))
cam = PerspectiveCamera(position=np.array([0.5, 2.5, 4.0]), target=np.array([0.0, 0.6, 0.0]))
img = render(s, cam, 8, 8, RenderConfig(spp=1, max_depth=3), device="cpu").radiance_mean()
assert img.shape == (8, 8, 3) and bool(img.isfinite().all()) and float(img.mean()) > 0
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", loaded)
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [str(REPO), env.get("PYTHONPATH", "")] if p)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout
