"""The block cut of `render_tile_radiance`: a call that records no graph
runs FRAME_CHUNK-pixel blocks, one that records a graph (a train step,
replayed or not) PIXEL_CHUNK-pixel blocks, both cut at multiples of the
block size counted from `first`.  Either block of B pixels runs k =
min(samples left, FRAME_CHUNK // B), at least 1, samples a pass over
k * B sample-major lanes.  The cut changes the launch count, and a step's
gradients in the last bits at most (a pass's samples meet in one index
backward instead of autograd's sum of per-pass ones): forward radiance
and a step's loss are bit-equal under any cut (noise keyed by pixel and
sample, per-lane paths, each pixel's samples added in order).

Blocks here are 40 pixels under autograd and 120 otherwise, on a 16x16
frame at 2 spp and depth 2 (two plain-version calls per pass: a closest
hit and a fused any-hit)."""

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
from tests.test_torch_arealight import EMIT, area_scene
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)
from tests.test_torch_spans import new_records, traced

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


@pytest.mark.parametrize("first, n, passes", [
    # a frame: cuts at 120, 240 (blocks of 120, 120 and 16 pixels: 2 + 2 + 1
    # passes) / every 40 (six blocks of 40 pixels: 2 passes each, 16: 1)
    (0, W * H, (5, 13)),
    # pixels 50..149 of a list: cuts at 70 (blocks of 70 and 30 pixels:
    # 2 + 1 passes) / 30, 70 (30, 40 and 30 pixels: 2 passes each)
    (50, 100, (3, 6)),
])
def test_forward_blocks_are_bit_equal_under_either_cut(port, monkeypatch, first, n, passes):
    sd, cam = port
    px, py = (v[:n] for v in pixels())

    def radiance():
        return tint.render_tile_radiance(sd, cam, W, H, px, py, rng.prng_key(3), CFG,
                                         first=first)

    wide, wide_calls = blocked(monkeypatch, FRAME, radiance)
    narrow, narrow_calls = blocked(monkeypatch, CHUNK, radiance)
    assert (wide_calls, narrow_calls) == tuple(p * 2 for p in passes)
    assert torch.equal(wide, narrow)


def test_forward_frame_is_one_block_at_the_default_cut(port, monkeypatch):
    """`render` of the whole frame at FRAME_CHUNK = 32 * PIXEL_CHUNK runs
    one block, both samples in one pass, and the film equals the 40-pixel
    cut's."""
    sd, cam = port
    monkeypatch.setattr(tint, "PIXEL_CHUNK", CHUNK)
    before = LAUNCHES["plain"]
    film = tint.render(sd, cam, W, H, CFG, key=rng.prng_key(4), device="cpu")
    assert LAUNCHES["plain"] - before == 1 * 2
    narrow, _ = blocked(monkeypatch, CHUNK, lambda: tint.render(
        sd, cam, W, H, CFG, key=rng.prng_key(4), device="cpu"))
    assert torch.equal(film.ld, narrow.ld)


def test_no_grad_render_of_a_differentiable_scene_runs_forward_blocks(port, monkeypatch):
    """A scene whose parameters require grad, rendered under no_grad,
    records nothing: FRAME_CHUNK blocks (120, 120 and 16 pixels: 2 + 2 + 1
    passes); with grad on, PIXEL_CHUNK blocks (six of 40 pixels and one of
    16), each block's two samples in one pass."""
    sd, cam = port
    albedo = sd.materials.albedo.detach().requires_grad_(True)
    diff = sd._replace(materials=sd.materials._replace(albedo=albedo))
    px, py = pixels()

    def radiance():
        return tint.render_tile_radiance(diff, cam, W, H, px, py, rng.prng_key(5), CFG)

    with torch.no_grad():
        off, off_calls = blocked(monkeypatch, FRAME, radiance)
    on, on_calls = blocked(monkeypatch, FRAME, radiance)
    assert (off_calls, on_calls) == ((2 + 2 + 1) * 2, 7 * 2)
    assert on.requires_grad and not off.requires_grad
    assert torch.equal(off, on.detach())


@pytest.mark.parametrize("replay", [True, False])
def test_train_step_blocks_ignore_the_frame_cut(port, monkeypatch, replay):
    """The replayed step and a `replay=False` step cut at PIXEL_CHUNK
    whatever FRAME_CHUNK is (7 blocks), and FRAME_CHUNK decides only how
    many samples a pass: both at 120 (7 passes), one a pass at 40 (2 + 2 +
    2 + 2 + 2 + 2 + 1: the 16-pixel block still takes both), the replay's
    passes again in the backward; loss bit-equal, gradients within 1e-6 of
    the largest."""
    sd, cam = port
    px, py = pixels()
    target = torch.from_numpy(
        np.random.default_rng(6).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32))
    step = tpar.make_train_step(CFG, W, H, SPP, replay=replay)
    runs = []
    for frame_chunk, passes in ((FRAME, 7), (CHUNK, 13)):
        (loss, (mat, ls, tex)), calls = blocked(
            monkeypatch, frame_chunk, lambda: step(sd, cam, px, py, target, rng.prng_key(7)))
        forward = GLOBAL_TIMINGS.last("mcpt::train.forward").launches.get("plain", 0)
        assert (forward, calls - forward) == (passes * 2, passes * 2 if replay else 0)
        runs.append([loss, *mat, ls, tex])
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1:], runs[1][1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


BATCH_SPP = 4


def test_replayed_step_batches_its_samples(port, monkeypatch):
    """A replayed train step of one 256-pixel block at 4 spp runs every
    sample in one pass, forward and replay, at the default FRAME_CHUNK, and
    one sample a pass at FRAME_CHUNK = 256: the same loss, gradients within
    1e-6 of the largest, and every traced `mcpt::sample` span of the
    batched step, the forward's and the replay's, carries all 4 samples."""
    sd, cam = port
    px, py = pixels()
    target = torch.from_numpy(
        np.random.default_rng(14).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32))
    cfg = dataclasses.replace(CFG, spp=BATCH_SPP)
    step = tpar.make_train_step(cfg, W, H, BATCH_SPP)
    runs, idents = [], []
    for frame_chunk in (tint.FRAME_CHUNK, W * H):
        monkeypatch.setattr(tint, "FRAME_CHUNK", frame_chunk)
        before = len(GLOBAL_TIMINGS.records())
        (loss, (mat, ls, tex)), _ = traced(
            lambda: step(sd, cam, px, py, target, rng.prng_key(15)))
        idents.append([r.ident for _, r in new_records(before) if r.name == "mcpt::sample"])
        runs.append([loss, *mat, ls, tex])
    assert idents[0] == [(0, 0, BATCH_SPP)] * 2
    assert sorted(idents[1]) == sorted([(0, s, 1) for s in range(BATCH_SPP)] * 2)
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1].abs().sum() > 0
    for a, b in zip(runs[0][1:], runs[1][1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


AREA_DEPTH = 3
# a camera under the quad of tests/test_torch_arealight.area_scene that sees
# its underside (primary emission) and the lit floor
AREA_VIEW = PerspectiveCamera(position=np.array([0.0, 0.6, 2.4]),
                              target=np.array([0.0, 1.5, 0.0]), fov_deg=70.0)


@pytest.fixture(scope="module")
def area():
    return (area_scene().build("cpu"),
            dataclasses.replace(AREA_VIEW, aspect=W / H).params("cpu"))


# (scene, RenderConfig fields, spp, first, pixels, FRAME_CHUNK of the batched
# call, FRAME_CHUNK of the one-sample-a-pass call, their passes).  The
# default FRAME_CHUNK holds every sample of these pixels in one pass; a
# one-sample call cuts blocks of more than half its FRAME_CHUNK.
BATCHES = {
    "directional, sorted": ("port", {}, 2, 0, W * H, None, W * H, (1, 2)),
    "directional, unsorted": ("port", dict(sort_rays=False), 2, 0, W * H, None, W * H, (1, 2)),
    "directional, jitter": ("port", dict(jitter=True), 2, 0, W * H, None, W * H, (1, 2)),
    "directional, thin lens": ("lens", {}, 2, 0, W * H, None, W * H, (1, 2)),
    "area, sorted": ("area", dict(max_depth=AREA_DEPTH), 3, 0, W * H, None, W * H, (1, 3)),
    "area, jitter": ("area", dict(max_depth=AREA_DEPTH, jitter=True), 3, 0, W * H, None,
                     W * H, (1, 3)),
    # a shard's 100 pixels from pixel 40 of the list: one block, or cuts at 50
    "first 40": ("port", {}, 2, 40, 100, None, 90, (1, 2 * 2)),
    # 3 samples, 2 a pass: passes of 2 and 1 samples
    "remainder": ("port", {}, 3, 0, W * H, 2 * W * H, W * H, (2, 3)),
}


@pytest.mark.parametrize("case", list(BATCHES))
def test_batched_samples_are_bit_equal_to_one_sample_a_pass(port, area, monkeypatch, case):
    """A forward block's samples batched into its lanes give the radiance of
    the same call at one sample a pass, bit for bit: on the directional
    scene (sorted and unsorted traversal, jitter on, a thin lens's
    samples), on an area-lit scene
    (bounded shadow any-hits, primary emission), for a part of a pixel list
    (`first`) and with a remainder pass.  Plain calls: ceil(spp / k) passes
    a block, each a pass's dispatches (2 at depth 2; 4 closest and 2
    bounded any-hits at depth 3)."""
    name, fields, spp, first, n, batched_chunk, single_chunk, passes = BATCHES[case]
    sd, cam = area if name == "area" else port
    if name == "lens":
        cam = cam._replace(lens_radius=torch.tensor(0.05), focal_distance=torch.tensor(4.0))
    cfg = dataclasses.replace(CFG, spp=spp, **fields)
    per_pass = 6 if name == "area" else 2 * (cfg.max_depth - 1)
    px, py = (v[first:first + n] for v in pixels())

    def radiance():
        return tint.render_tile_radiance(sd, cam, W, H, px, py, rng.prng_key(11), cfg,
                                         first=first)

    batched, batched_calls = blocked(monkeypatch, batched_chunk or tint.FRAME_CHUNK, radiance)
    single, single_calls = blocked(monkeypatch, single_chunk, radiance)
    assert (batched_calls, single_calls) == tuple(p * per_pass for p in passes)
    assert torch.equal(batched, single)
    assert batched.abs().sum() > 0
    if name == "area":
        assert batched.max() >= max(EMIT)   # some pixels see the emitter directly


@pytest.mark.parametrize("frame_chunk, spp, idents", [
    # blocks of 120, 120 and 16 pixels: one sample a pass, one sample a pass,
    # all three in one pass
    (FRAME, 3, [(0, 0, 1), (0, 1, 1), (0, 2, 1), (1, 0, 1), (1, 1, 1), (1, 2, 1),
                (2, 0, 3)]),
    # one 256-pixel block, 2 samples a pass: passes of 2 and 1
    (2 * W * H, 3, [(0, 0, 2), (0, 2, 1)]),
])
def test_sample_spans_name_block_first_sample_and_samples(port, monkeypatch, frame_chunk,
                                                          spp, idents):
    """A traced forward render opens `mcpt::sample` once a pass, with ident
    (block, first sample, samples in the pass), and launches each pass's
    dispatches inside it."""
    sd, cam = port
    monkeypatch.setattr(tint, "FRAME_CHUNK", frame_chunk)
    before = len(GLOBAL_TIMINGS.records())
    px, py = pixels()
    traced(lambda: tint.render_tile_radiance(sd, cam, W, H, px, py, rng.prng_key(12),
                                             dataclasses.replace(CFG, spp=spp)))
    passes = [r for _, r in new_records(before) if r.name == "mcpt::sample"]
    assert [r.ident for r in passes] == idents
    assert all(r.launches == {"plain": 2, "sort": 2} for r in passes)


@pytest.mark.parametrize("case", ["one sample a pass", "batched", "replayed step"])
def test_key_words_are_made_once_a_call(port, monkeypatch, case):
    """Every pass reads its samples' rows of the device key words that
    `_key_words` makes once per render_tile_radiance call: a forward call
    at one sample a pass (one 256-pixel block, 2 passes), a batched one (1
    pass) and a replayed train step (7 blocks of one pass, each replayed in
    the backward from the words its checkpoint saved)."""
    sd, cam = port
    px, py = pixels()
    made = []
    key_words = tint._key_words

    def counted(*args):
        made.append(args)
        return key_words(*args)

    monkeypatch.setattr(tint, "_key_words", counted)
    if case == "replayed step":
        target = torch.zeros((W * H, 3))
        step = tpar.make_train_step(CFG, W, H, SPP)
        _, calls = blocked(monkeypatch, FRAME,
                           lambda: step(sd, cam, px, py, target, rng.prng_key(13)))
        assert calls == 2 * (7 * 2)
    else:
        frame_chunk = W * H if case == "one sample a pass" else tint.FRAME_CHUNK
        _, calls = blocked(monkeypatch, frame_chunk, lambda: tint.render_tile_radiance(
            sd, cam, W, H, px, py, rng.prng_key(13), CFG))
        assert calls == (SPP if case == "one sample a pass" else 1) * 2
    assert len(made) == 1
