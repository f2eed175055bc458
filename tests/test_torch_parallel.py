"""Row-sharded rendering and train steps of the port on an 8-shard CPU mesh,
against the port's one-device path and the JAX package's one-device render
and train step (tests/test_parallel.py's scene and arguments: 16x16, 2
spp, depth 2, key 0).

Tolerances: the sharded frame within rtol 1e-5 / atol 1e-6 of the JAX
render (tests/test_parallel.py's own) on at least 99% of pixels, and every
pixel within the port's standing rtol 1e-4 / atol 1e-5: the two packages'
camera rays differ by up to 7e-7 (XLA contracts the camera's
multiply-adds into FMAs, ROADMAP Queue 3 #6), and one glossy pixel of the
256 reads 3.5e-5 relative off; bit-equal to the port's
one-device frame (pixel-keyed noise, per-pixel arithmetic); sharded
gradients within 1e-5 of the largest of the one-device step's (only the
order of the shards' sum differs) and within 2e-3 of the largest of the
JAX step's (the port's standing gradient tolerance, tests/test_torch_grad.py).
The JAX references are computed once per module in fixtures."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.models import integrator as jint
from mc_path_tracer_tpu.models.camera import PerspectiveCamera as JCam
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu.parallel import render as jpar
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera as TCam
from mc_path_tracer_tpu_torch.models.primitives import plane, uv_sphere
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from mc_path_tracer_tpu_torch.ops import rng as trng
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES
from mc_path_tracer_tpu_torch.parallel import mesh as tmesh
from mc_path_tracer_tpu_torch.parallel import render as tpar
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

W = H = 16
SPP, DEPTH = 2, 2
SHARDS = 8
GRAD_TOL = 2e-3
SHARD_GRAD_TOL = 1e-5
CAM = dict(position=np.array([0.3, 2.0, 4.0]), target=np.array([0.0, 0.5, 0.0]))


def small_scene(scene_cls):
    """tests/test_parallel.py's scene through either package's Scene API."""
    s = scene_cls()
    s.set_environment_color((0.3, 0.3, 0.35), ls=1.0)
    floor = s.add_material(albedo=(0.6, 0.6, 0.6), roughness=0.8)
    p, n, uv, idx = plane(30.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    m = s.add_material(albedo=(0.8, 0.3, 0.2), roughness=0.4)
    p, n, uv, idx = uv_sphere(0.8, center=(0, 0.8, 0), rings=8, segments=16)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=m)
    s.add_directional_light((0.3, 1.0, 0.2), ls=2.0)
    return s


def cpu_mesh(n=SHARDS):
    return tmesh.make_mesh(devices=["cpu"] * n)


def pixels(w=W, h=H):
    ys, xs = np.mgrid[0:h, 0:w]
    return xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32)


@pytest.fixture(scope="module")
def port():
    sd = small_scene(TScene).build("cpu")
    cam = dataclasses.replace(TCam(**CAM), aspect=W / H).params("cpu")
    return sd, cam


@pytest.fixture(scope="module")
def jax_frame():
    """The JAX package's one-device render of the scene."""
    sd = small_scene(JScene).build()
    return np.asarray(jint.render(sd, JCam(**CAM), W, H,
                                  jint.RenderConfig(spp=SPP, max_depth=DEPTH),
                                  key=jax.random.PRNGKey(0)).ld)


@pytest.fixture(scope="module")
def target():
    return np.random.default_rng(5).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_step(target):
    """The JAX package's one-device make_train_step: (loss, 7 gradients)."""
    sd = small_scene(JScene).build()
    cam = dataclasses.replace(JCam(**CAM), aspect=W / H).params()
    step = jpar.make_train_step(jint.RenderConfig(spp=SPP, max_depth=DEPTH, accel="brute"),
                                W, H, SPP)
    loss, grads = step(sd, cam, *(jnp.asarray(v) for v in pixels()), jnp.asarray(target),
                       jax.random.PRNGKey(0))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def run_step(port, target, mesh, key=0):
    sd, cam = port
    step = tpar.make_train_step(tint.RenderConfig(spp=SPP, max_depth=DEPTH), W, H, SPP,
                                mesh=mesh)
    loss, (mat, ls, tex) = step(sd, cam, *(torch.from_numpy(v) for v in pixels()),
                                torch.from_numpy(target), trng.prng_key(key))
    return loss, [*mat, ls, tex], step


@pytest.fixture(scope="module")
def steps(port, target):
    """The port's one-device and 8-shard steps, with the sharded step's
    forward and backward plain-version calls."""
    one = run_step(port, target, None)
    before = LAUNCHES["plain"]
    loss, grads, step = run_step(port, target, cpu_mesh())
    forward = step.forward_launches["plain"] - before
    return one[:2], (loss, grads), (forward, LAUNCHES["plain"] - before - forward)


def largest_gap(got, want) -> float:
    """The largest per-tensor gap, each as a share of want's largest
    magnitude (0 where both are 0)."""
    gaps = [0.0]
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        scale, gap = np.abs(b).max(initial=0.0), np.abs(a - b).max(initial=0.0)
        gaps.append(gap / scale if scale > 0 else (0.0 if gap == 0 else np.inf))
    return max(gaps)


def test_mesh_shard_count():
    mesh = cpu_mesh()
    assert mesh.size == SHARDS and mesh.world_size == 1 and mesh.group is None
    assert list(mesh.local_shards()) == list(range(SHARDS))
    assert tmesh.TILE_AXIS == "tiles"
    # no card here: a mesh of cards is refused, not shrunk to the CPU
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices asked for"):
            tmesh.make_mesh(n_devices=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.make_mesh(devices=["cuda:0"])


def test_tile_sharding_and_replicated(port):
    mesh = cpu_mesh(4)
    x = torch.arange(24.0).reshape(12, 2)
    blocks = tmesh.tile_sharding(mesh, x)
    assert [b.shape for b in blocks] == [(3, 2)] * 4
    assert torch.equal(torch.cat(blocks), x)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.tile_sharding(mesh, torch.zeros(10, 3))
    copies = tmesh.replicated(mesh, port[0])
    # shards on one device share one copy, and nothing is copied
    assert len(copies) == 4 and all(c is copies[0] for c in copies)
    assert copies[0].tris.geo is port[0].tris.geo
    assert copies[0].bvh.wide_depth == port[0].bvh.wide_depth


def test_init_distributed_is_a_no_op_for_one_process():
    tmesh.init_distributed("localhost:1", 1, 0)
    tmesh.init_distributed(None, None, None)
    assert not torch.distributed.is_initialized()


def test_sharded_render_rejects_a_bad_height(port):
    sd, cam = port
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        tpar.render_sharded(sd, cam, 16, 9, tint.RenderConfig(spp=1, max_depth=2),
                            mesh=cpu_mesh())


def test_sharded_frame_matches_jax_render(port, jax_frame):
    """The 8-shard frame against the JAX package's one-device render at
    tests/test_parallel.py's tolerance on 99% of pixels (module docstring)."""
    sd, cam = port
    frame = tpar.render_sharded(sd, cam, W, H, tint.RenderConfig(spp=SPP, max_depth=DEPTH),
                                key=trng.prng_key(0), mesh=cpu_mesh())
    assert frame.shape == (H, W, 3)
    close = np.isclose(frame.numpy(), jax_frame, rtol=1e-5, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, (close.mean(), np.argwhere(~close))
    np.testing.assert_allclose(frame.numpy(), jax_frame, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_sharded_frame_is_the_one_device_frame(port, shards):
    """Bit-equal to the port's render() of the same key, however the rows are
    split: the noise is keyed by pixel id; and render_sharded_global with one
    process is the same frame, flat."""
    sd, cam = port
    cfg = tint.RenderConfig(spp=SPP, max_depth=DEPTH)
    single = tint.render(sd, cam, W, H, cfg, key=trng.prng_key(0)).ld
    mesh = cpu_mesh(shards)
    frame = tpar.render_sharded(sd, cam, W, H, cfg, key=trng.prng_key(0), mesh=mesh)
    assert torch.equal(frame, single)
    flat = tpar.render_sharded_global(sd, cam, W, H, cfg, key=trng.prng_key(0), mesh=mesh)
    assert torch.equal(flat, single.reshape(-1, 3))


def test_sharded_step_gradients_match_one_device(steps):
    (loss1, grads1), (loss8, grads8), _ = steps
    assert largest_gap([g.numpy() for g in grads8], [g.numpy() for g in grads1]) <= \
        SHARD_GRAD_TOL
    assert abs(float(loss8) - float(loss1)) <= 1e-6 * abs(float(loss1))
    assert float(grads8[0].abs().sum()) > 0
    # no path reaches an emissive factor or an env texel: zeros, not None
    assert torch.equal(grads8[4], torch.zeros(2, 3))


def test_sharded_step_matches_jax_step(steps, jax_step):
    _, (loss8, grads8), _ = steps
    jloss, jgrads = jax_step
    assert abs(float(loss8) - jloss) <= 1e-4 * abs(jloss)
    assert largest_gap([g.numpy() for g in grads8], jgrads) <= GRAD_TOL


def test_sharded_step_counts_every_shard(steps):
    """forward_launches sums the shards' forwards; the backward replays
    each: per sample one closest and one fused any-hit dispatch for each
    of the 8 shards' blocks."""
    *_, (forward, backward) = steps
    assert forward == backward == SHARDS * SPP * 2


def test_sharded_sgd_step_lowers_the_loss(port):
    """One SGD step on albedo toward the scene rendered with albedo 0.9
    lowers the sharded loss (8x8 x 2 spp x depth 2, tests/test_parallel.py's
    step)."""
    sd, _ = port
    w = h = 8
    cam = dataclasses.replace(TCam(**CAM), aspect=1.0).params("cpu")
    cfg = tint.RenderConfig(spp=SPP, max_depth=DEPTH)
    px, py = (torch.from_numpy(v) for v in pixels(w, h))
    key = trng.prng_key(0)
    bright = sd._replace(materials=sd.materials._replace(
        albedo=torch.full_like(sd.materials.albedo, 0.9)))
    target = tint.render_tile_radiance(bright, cam, w, h, px, py, key, cfg) / cfg.spp
    step = tpar.make_train_step(cfg, w, h, cfg.spp, mesh=cpu_mesh())
    loss0, (g_mat, _, _) = step(sd, cam, px, py, target, key)
    assert float(g_mat.albedo.abs().sum()) > 0
    stepped = sd._replace(materials=sd.materials._replace(
        albedo=sd.materials.albedo - 0.5 * g_mat.albedo))
    loss1, _ = step(stepped, cam, px, py, target, key)
    assert float(loss1) < float(loss0)
