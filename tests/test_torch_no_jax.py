"""The port stands alone: in a fresh interpreter, import every module of
mc_path_tracer_tpu_torch, render an 8x8 frame of a scene with an area light
and an 8x8 frame of one with a directional light on the CPU, and check that
no module of JAX and none of the JAX package (mc_path_tracer_tpu) was
loaded (the GPU machine that runs the port has no JAX).  No source of the
port names the JAX package outside comments and docstrings, and the port
builds nothing inside it.  Entry points default to the card and raise
without one.  A changed kernel header renames the kernel's library."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_path_tracer_tpu_torch.models.scene import Scene
from mc_path_tracer_tpu_torch.ops.kernels import build
from mc_path_tracer_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "mc_path_tracer_tpu_torch"

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
# an area_scene-style frame: floor and an emissive quad facing down, black env
a = Scene()
a.set_environment_color((0, 0, 0), ls=0.0)
p, n, uv, idx = plane(20.0)
a.add_mesh(p, idx, normals=n, uvs=uv, material_id=a.add_material(albedo=(0.7, 0.5, 0.3)))
q = np.array([[-0.5, 2, -0.5], [0.5, 2, -0.5], [0.5, 2, 0.5], [-0.5, 2, 0.5]], np.float32)
a.add_mesh(q, np.array([[0, 1, 2], [0, 2, 3]]),
           normals=np.tile([[0, -1, 0]], (4, 1)).astype(np.float32),
           material_id=a.add_material(albedo=(0, 0, 0), emissive=(4.0, 3.0, 2.0)))
cam = PerspectiveCamera(position=np.array([0.6, 3.0, 2.5]), target=np.zeros(3), fov_deg=35.0)
film = render(a, cam, 8, 8, RenderConfig(spp=2, max_depth=3), device="cpu")
assert a.builder == "native", a.builder
img = film.radiance_mean()
assert bool(img.isfinite().all()) and float(img.mean()) > 0
assert film.to_uint8().shape == (8, 8, 3)
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", loaded)
ref = sorted(m for m in sys.modules
             if m == "mc_path_tracer_tpu" or m.startswith("mc_path_tracer_tpu."))
print("REFERENCE_MODULES", ref)
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [str(REPO), env.get("PYTHONPATH", "")] if p)
    # one intra-op thread: the suite's other workers share the cores
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout
    assert "REFERENCE_MODULES []" in proc.stdout, proc.stdout


_IMPORT = re.compile(r"^\s*(from\s+mc_path_tracer_tpu(\.|\s)|import\s+mc_path_tracer_tpu(\.|\s|$))",
                     re.MULTILINE)


def test_port_sources_do_not_import_the_jax_package():
    sources = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(sources) > 20
    offenders = [str(p.relative_to(REPO)) for p in sources if _IMPORT.search(p.read_text())]
    assert not offenders, offenders


def test_port_builds_outside_the_jax_package():
    """The native builder and the kernels build into the gitignored build/
    directory at the root of the checkout."""
    reference = REPO / "mc_path_tracer_tpu"
    for path in (native.library_path(), build.library_path(build.CSRC_DIR / "dense.cu")):
        assert path.is_relative_to(REPO / "build"), path
        assert not path.is_relative_to(reference), path
    assert native.SOURCE == PORT / "csrc" / "bvh.cpp"
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_entry_points_default_to_the_card():
    """A scene with geometry builds on the card by default: without one it
    raises instead of falling back to the CPU."""
    s = Scene()
    p = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    s.add_mesh(p, np.array([[0, 2, 1]]))
    if torch.cuda.is_available():
        assert s.build().tris.geo.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.build()
    assert s.build("cpu").tris.num_triangles == 1


def test_changed_header_renames_the_library(tmp_path):
    """build.library_path hashes every csrc header a source includes, so an
    edit to mt.cuh rebuilds both kernels that include it (pure hashing)."""
    for name in ("dense.cu", "traversal.cu", "mt.cuh"):
        shutil.copy(build.CSRC_DIR / name, tmp_path / name)
    dense, trav = tmp_path / "dense.cu", tmp_path / "traversal.cu"
    assert build.included_headers(dense) == [(tmp_path / "mt.cuh").resolve()]
    before = build.library_path(dense), build.library_path(trav)
    assert before == (build.library_path(dense), build.library_path(trav))
    header = tmp_path / "mt.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path(dense), build.library_path(trav)
    assert after[0] != before[0] and after[1] != before[1]
    assert after[0].name.startswith("libdense_") and after[1].name.startswith("libtraversal_")
