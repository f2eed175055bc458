"""The port stands alone: in a fresh interpreter, import every module of
mc_path_tracer_tpu_torch, render an 8x8 frame of a scene with an area light
and an 8x8 frame of one with a directional light on the CPU, render the
latter again on a 2-shard CPU mesh (parallel/mesh.py, render_sharded),
rebuild its triangles with build_accel and trace them through
ops/wide_bvh's routes, build a procedural turtle mesh (models/procedural.py), decode
chip_smoke.py's embedded JPEGs (utils/jpeg.py) to PIL's hashes, run the
command line (`python3 -m mc_path_tracer_tpu_torch`) in the path tracer and
the preview and the benchmark's and the gate's mains (which refuse to run
without a card), and check that no module of JAX and none of the JAX package (mc_path_tracer_tpu) was
loaded (the GPU machine that runs the port has no JAX), nor PIL (it has no
imaging package either).  No source of the
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
    if not m.name.endswith(".__main__"):
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
film = render(s, cam, 8, 8, RenderConfig(spp=1, max_depth=3), device="cpu")
img = film.radiance_mean()
assert img.shape == (8, 8, 3) and bool(img.isfinite().all()) and float(img.mean()) > 0
# the same frame on a 2-shard CPU mesh, bit for bit
import dataclasses
from mc_path_tracer_tpu_torch import make_mesh, render_sharded
from mc_path_tracer_tpu_torch.ops import rng
sharded = render_sharded(s.build("cpu"), dataclasses.replace(cam, aspect=1.0).params("cpu"), 8, 8,
                         RenderConfig(spp=1, max_depth=3), rng.prng_key(0),
                         make_mesh(devices=["cpu"] * 2))
assert bool((sharded == film.ld).all())
# a procedural mesh, and the embedded JPEGs decoded as PIL decodes them
from mc_path_tracer_tpu_torch.models.procedural import LSystem, Turtle
mods = LSystem(seed=1).set_axiom("F").add_rule("F -> F[+F]F[-F]F").build(2)
p, n, uv, idx = Turtle(step=0.5).interpret(mods).to_mesh(sides=4)
assert idx.shape == (25 * 8, 3)
import base64, hashlib
import chip_smoke
from mc_path_tracer_tpu_torch.utils.jpeg import read_jpeg
for b64, sha, size in chip_smoke.EMBEDDED_JPEGS.values():
    assert hashlib.sha256(read_jpeg(base64.b64decode(b64)).tobytes()).hexdigest() == sha
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
# the command line as `python3 -m mc_path_tracer_tpu_torch` runs it, in the
# path tracer and the preview, and the benchmark, which runs on the card only
import os, runpy, tempfile
out = os.path.join(tempfile.mkdtemp(), "cli.png")
for mode in ("path_tracer", "rasterizer"):
    sys.argv = ["mc_path_tracer_tpu_torch", "--demo", "--size", "8x6", "--spp", "1",
                "--depth", "2", "--mode", mode, "--device", "cpu", "--out", out]
    try:
        runpy.run_module("mc_path_tracer_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
    assert os.path.getsize(out) > 0
sys.argv = ["mc_path_tracer_tpu_torch.bench", "--strided"]
try:
    runpy.run_module("mc_path_tracer_tpu_torch.bench", run_name="__main__")
    raise AssertionError("the benchmark ran without a card")
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
# the API routes of the last slice, and the on-card gate, which refuses to
# run without a card
for name in ("mc_path_tracer_tpu_torch.ops.wide_bvh", "mc_path_tracer_tpu_torch.tests_tpu"):
    assert name in sys.modules, name
from mc_path_tracer_tpu_torch.ops import bvh, wide_bvh
import torch
tb, tw, tt = bvh.build_accel(s.build("cpu").tris, device="cpu")
o = torch.tensor([[0.0, 3.0, 0.0]]).repeat(2, 1)
d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(2, 1)
assert wide_bvh.intersect_wide(tw, tt, o, d, mask=torch.tensor([True, False])).hit.tolist() == [True, False]
assert wide_bvh.occluded_wide(tw, o, d, t_max=torch.tensor([1.0, 5.0])).tolist() == [False, True]
sys.argv = ["mc_path_tracer_tpu_torch.tests_tpu"]
try:
    runpy.run_module("mc_path_tracer_tpu_torch.tests_tpu", run_name="__main__")
    raise AssertionError("the gate ran without a card")
except RuntimeError as e:
    assert "only on a GPU" in str(e), e
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", loaded)
ref = sorted(m for m in sys.modules
             if m == "mc_path_tracer_tpu" or m.startswith("mc_path_tracer_tpu."))
print("REFERENCE_MODULES", ref)
print("PIL_MODULES", sorted(m for m in sys.modules if m == "PIL" or m.startswith("PIL.")))
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
    assert "PIL_MODULES []" in proc.stdout, proc.stdout


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
