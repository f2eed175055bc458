"""The block cut of `render_tile_radiance`: a call that records no graph
runs FRAME_CHUNK-pixel blocks, one that records a graph (a train step,
replayed or not) PIXEL_CHUNK-pixel blocks, both cut at multiples of the
block size counted from `first`.  The cut changes the launch count only:
forward radiance is bit-equal under any cut (pixel-keyed noise, per-lane
paths), and a step's loss and gradients do not see FRAME_CHUNK at all.

Blocks here are 40 pixels under autograd and 120 otherwise, on a 16x16
frame at 2 spp and depth 2 (two plain-version calls per block and
sample: a closest hit and a fused any-hit)."""

import dataclasses

import numpy as np
import pytest
import torch

from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera
from mc_path_tracer_tpu_torch.models.primitives import plane, uv_sphere
from mc_path_tracer_tpu_torch.models.scene import Scene
from mc_path_tracer_tpu_torch.ops import rng
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES
from mc_path_tracer_tpu_torch.parallel import render as tpar
from mc_path_tracer_tpu_torch.utils.profiling import GLOBAL_TIMINGS
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

W = H = 16
SPP, DEPTH = 2, 2
CHUNK, FRAME = 40, 120
CFG = tint.RenderConfig(spp=SPP, max_depth=DEPTH)


@pytest.fixture(scope="module")
def port():
    s = Scene()
    s.set_environment_color((0.3, 0.3, 0.35), ls=1.0)
    floor = s.add_material(albedo=(0.6, 0.6, 0.6), roughness=0.8)
    p, n, uv, idx = plane(30.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    m = s.add_material(albedo=(0.8, 0.3, 0.2), roughness=0.4)
    p, n, uv, idx = uv_sphere(0.8, center=(0, 0.8, 0), rings=8, segments=16)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=m)
    s.add_directional_light((0.3, 1.0, 0.2), ls=2.0)
    cam = PerspectiveCamera(position=np.array([0.3, 2.0, 4.0]),
                            target=np.array([0.0, 0.5, 0.0]))
    return s.build("cpu"), dataclasses.replace(cam, aspect=W / H).params("cpu")


def pixels():
    ys, xs = np.mgrid[0:H, 0:W]
    return (torch.from_numpy(xs.reshape(-1).astype(np.float32)),
            torch.from_numpy(ys.reshape(-1).astype(np.float32)))


def blocked(monkeypatch, frame_chunk, fn):
    """fn() with PIXEL_CHUNK = CHUNK and FRAME_CHUNK = frame_chunk:
    (its result, the plain-version calls it made)."""
    monkeypatch.setattr(tint, "PIXEL_CHUNK", CHUNK)
    monkeypatch.setattr(tint, "FRAME_CHUNK", frame_chunk)
    before = LAUNCHES["plain"]
    out = fn()
    return out, LAUNCHES["plain"] - before


@pytest.mark.parametrize("first, n, blocks", [
    (0, W * H, (3, 7)),   # a frame: cuts at 120, 240 / every 40
    (50, 100, (2, 3)),    # pixels 50..149 of a list: cuts at 70 / 30, 70
])
def test_forward_blocks_are_bit_equal_under_either_cut(port, monkeypatch, first, n, blocks):
    sd, cam = port
    px, py = (v[:n] for v in pixels())

    def radiance():
        return tint.render_tile_radiance(sd, cam, W, H, px, py, rng.prng_key(3), CFG,
                                         first=first)

    wide, wide_calls = blocked(monkeypatch, FRAME, radiance)
    narrow, narrow_calls = blocked(monkeypatch, CHUNK, radiance)
    assert (wide_calls, narrow_calls) == tuple(b * 2 * SPP for b in blocks)
    assert torch.equal(wide, narrow)


def test_forward_frame_is_one_block_at_the_default_cut(port, monkeypatch):
    """`render` of the whole frame at FRAME_CHUNK = 32 * PIXEL_CHUNK runs
    one block per sample, and the film equals the 40-pixel cut's."""
    sd, cam = port
    monkeypatch.setattr(tint, "PIXEL_CHUNK", CHUNK)
    before = LAUNCHES["plain"]
    film = tint.render(sd, cam, W, H, CFG, key=rng.prng_key(4), device="cpu")
    assert LAUNCHES["plain"] - before == 1 * 2 * SPP
    narrow, _ = blocked(monkeypatch, CHUNK, lambda: tint.render(
        sd, cam, W, H, CFG, key=rng.prng_key(4), device="cpu"))
    assert torch.equal(film.ld, narrow.ld)


def test_no_grad_render_of_a_differentiable_scene_runs_forward_blocks(port, monkeypatch):
    """A scene whose parameters require grad, rendered under no_grad,
    records nothing: FRAME_CHUNK blocks; with grad on, PIXEL_CHUNK blocks."""
    sd, cam = port
    albedo = sd.materials.albedo.detach().requires_grad_(True)
    diff = sd._replace(materials=sd.materials._replace(albedo=albedo))
    px, py = pixels()

    def radiance():
        return tint.render_tile_radiance(diff, cam, W, H, px, py, rng.prng_key(5), CFG)

    with torch.no_grad():
        off, off_calls = blocked(monkeypatch, FRAME, radiance)
    on, on_calls = blocked(monkeypatch, FRAME, radiance)
    assert (off_calls, on_calls) == (3 * 2 * SPP, 7 * 2 * SPP)
    assert on.requires_grad and not off.requires_grad
    assert torch.equal(off, on.detach())


@pytest.mark.parametrize("replay", [True, False])
def test_train_step_blocks_ignore_the_frame_cut(port, monkeypatch, replay):
    """The replayed step and a `replay=False` step cut at PIXEL_CHUNK
    whatever FRAME_CHUNK is: the same launches (forward 7 blocks, and the
    replay's 7 again in the backward), loss and gradients bit-equal."""
    sd, cam = port
    px, py = pixels()
    target = torch.from_numpy(
        np.random.default_rng(6).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32))
    step = tpar.make_train_step(CFG, W, H, SPP, replay=replay)
    runs = []
    for frame_chunk in (FRAME, CHUNK):
        (loss, (mat, ls, tex)), calls = blocked(
            monkeypatch, frame_chunk, lambda: step(sd, cam, px, py, target, rng.prng_key(7)))
        forward = GLOBAL_TIMINGS.last("mcpt::train.forward").launches.get("plain", 0)
        assert (forward, calls - forward) == (7 * 2 * SPP, 7 * 2 * SPP if replay else 0)
        runs.append([loss, *mat, ls, tex])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
