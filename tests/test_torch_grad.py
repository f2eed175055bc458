"""The gradient path: the port's autograd through trace_radiance, its
make_train_step, build_distribution_traced and save_params / load_params
against the JAX package's jax.grad, make_train_step, build_distribution
and checkpoints on the same scenes, rays and keys; per-sample replay
against keeping every sample's graph; finite differences; one SGD step.

Tolerances: per gradient tensor, the largest gap is at most 2e-3 of the
largest JAX gradient (float32 transcendentals differ in the last bit
between XLA and torch, tools/libm_drift.py, and glossy paths amplify it);
losses agree to 1e-4 relative.  The JAX side runs accel="brute" (its BVH
routes compile far longer on the CPU and meet the same hits); the port runs
"auto", the traversal's plain version on CPU tensors.  Each JAX reference
is computed once per module in a fixture."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu import configs as jconfigs
from mc_path_tracer_tpu.models import integrator as jint
from mc_path_tracer_tpu.models.camera import PerspectiveCamera as JCam
from mc_path_tracer_tpu.models.camera import gen_camera_rays as jgen
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu.ops import envmap as jenv
from mc_path_tracer_tpu.parallel import render as jpar
from mc_path_tracer_tpu.utils import checkpoint as jckpt
from mc_path_tracer_tpu_torch import configs as tconfigs
from mc_path_tracer_tpu_torch import make_train_step
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera as TCam
from mc_path_tracer_tpu_torch.models.camera import gen_camera_rays as tgen
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from mc_path_tracer_tpu_torch.ops import envmap as tenv
from mc_path_tracer_tpu_torch.ops import rng as trng
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES
from mc_path_tracer_tpu_torch.parallel import render as tpar
from mc_path_tracer_tpu_torch.parallel.mesh import make_mesh
from mc_path_tracer_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_scene import small_scene

W = H = 8
KEY = 7
GRAD_TOL = 2e-3
LOSS_RTOL = 1e-4
NAMES = ("albedo", "roughness", "metallic", "fresnel", "emissive", "ls", "tex")
SMALL_CAM = dict(position=np.array([0.5, 2.5, 4.0]), target=np.array([0.0, 0.6, 0.0]),
                 fov_deg=45.0)
# the JAX package's floor scene and camera (tests/test_integrator.py)
FLOOR_CAM = dict(position=np.array([0.7, 5.0, 1.3]), target=np.array([0.3, 0.0, 0.1]),
                 fov_deg=40.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs in several worker processes, and a
    render's many small ops slow down tenfold when each spins a full set of
    intra-op threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def scenes(name):
    """(JAX SceneData, port SceneData on the CPU, JAX camera, port camera)."""
    if name == "small_scene":
        return (small_scene(JScene).build(), small_scene(TScene).build("cpu"),
                JCam(**SMALL_CAM), TCam(**SMALL_CAM))
    n = {"config2": 2, "config4": 4}[name]
    js, jc, *_ = jconfigs.ALL_CONFIGS[n]()
    ts, tc, *_ = tconfigs.ALL_CONFIGS[n]()
    return js.build(), ts.build("cpu"), jc, tc


def pixels(w=W, h=H):
    ys, xs = np.mgrid[0:h, 0:w]
    return xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32)


def camera_rays(jcam, tcam, w=W, h=H):
    """The same pinhole camera rays for both packages."""
    px, py = pixels(w, h)
    cam = dataclasses.replace(jcam, aspect=w / h).params()
    # one compiled program: op-by-op dispatch compiles each op apart
    jr = jax.jit(lambda x, y: jgen(cam, w, h, x, y, jnp.zeros((w * h, 2))))(
        jnp.asarray(px), jnp.asarray(py))
    tr = tgen(tint.camera_params(tcam, w, h, "cpu"), w, h, torch.from_numpy(px),
              torch.from_numpy(py), torch.zeros((w * h, 2)))
    return jr, tr


def jax_params(sd):
    m = sd.materials
    return (jpar.MaterialGrads(m.albedo, m.roughness, m.metallic, m.fresnel, m.emissive),
            sd.lights.directional.ls, sd.lights.env.tex)


def jax_with_params(sd, params):
    """make_train_step's loss_fn replacement (mc_path_tracer_tpu/parallel/render.py)."""
    mat_f, ls, tex = params
    lights = sd.lights
    return sd._replace(materials=sd.materials._replace(**mat_f._asdict()),
                       lights=lights._replace(env=lights.env._replace(tex=tex),
                                              directional=lights.directional._replace(ls=ls)))


def jax_trace_grads(sd, rays, depth):
    """sum(trace_radiance) and its gradients w.r.t. the train step's
    parameters, as numpy."""
    cfg = jint.RenderConfig(spp=1, max_depth=depth, accel="brute")

    def loss(params):
        return jnp.sum(jint.trace_radiance(jax_with_params(sd, params), *rays,
                                           jax.random.PRNGKey(KEY), cfg))

    value, grads = jax.jit(jax.value_and_grad(loss))(jax_params(sd))
    return float(value), [np.asarray(g) for g in jax.tree.leaves(grads)]


def leaves_of(sd):
    """Fresh leaves of the train step's parameters and the scene made of them."""
    mat, ls, tex = tpar.scene_params(sd)
    leaves = [p.detach().clone().requires_grad_(True) for p in (*mat, ls, tex)]
    return leaves, tpar.with_params(sd, (tpar.MaterialGrads(*leaves[:5]), *leaves[5:]))


def port_trace_grads(sd, rays, depth, key=KEY, **cfg):
    leaves, sd2 = leaves_of(sd)
    out = tint.trace_radiance(sd2, *rays, trng.prng_key(key),
                              tint.RenderConfig(spp=1, max_depth=depth, **cfg)).sum()
    grads = torch.autograd.grad(out, leaves, allow_unused=True)
    return out.item(), [np.zeros(p.shape, np.float32) if g is None else g.numpy()
                        for p, g in zip(leaves, grads)]


def assert_grads_agree(got, want):
    assert len(got) == len(want) == len(NAMES)
    for name, a, b in zip(NAMES, got, want):
        a = np.asarray(a)
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        if b.size:
            gap = np.abs(a - b).max()
            assert gap <= GRAD_TOL * np.abs(b).max(), (name, gap, np.abs(b).max())


# depth 2 takes the first hit's NEE and BRDF sample; config4 runs depth 3, so
# that gradients also flow through the glossy continuation throughput
TRACE_CASES = {"small_scene": 2, "config2": 2, "config4": 3}


@pytest.fixture(scope="module", params=list(TRACE_CASES))
def trace_case(request):
    jsd, tsd, jcam, tcam = scenes(request.param)
    jrays, trays = camera_rays(jcam, tcam)
    depth = TRACE_CASES[request.param]
    return request.param, jax_trace_grads(jsd, jrays, depth), port_trace_grads(tsd, trays, depth)


def test_trace_gradients_match_jax(trace_case):
    """d sum(trace_radiance) / d (materials, directional ls, env texels),
    8x8 rays, 1 spp: small_scene (HDR environment, a directional light),
    config2 (the area light: emissive reaches primary-hit emission only,
    as the JAX package copies the light's emission on the host) and
    config4 (six GGX spheres)."""
    name, (jloss, jgrads), (tloss, tgrads) = trace_case
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss)
    assert_grads_agree(tgrads, jgrads)
    nonzero = {"small_scene": ("albedo", "roughness", "metallic", "fresnel", "ls", "tex"),
               "config2": ("albedo", "roughness", "metallic", "fresnel", "emissive"),
               "config4": ("albedo", "roughness", "fresnel", "tex")}[name]
    for field in nonzero:
        assert np.abs(tgrads[NAMES.index(field)]).sum() > 0, field


TRAIN_CFG = dict(spp=2, max_depth=2)


@pytest.fixture(scope="module")
def train_steps():
    """JAX make_train_step(..., mesh=None) and the port's on small_scene,
    8x8 x 2 spp x depth 2, against a target drawn from a seed."""
    jsd, tsd, jcam, tcam = scenes("small_scene")
    px, py = pixels()
    target = np.random.default_rng(5).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32)
    jstep = jpar.make_train_step(jint.RenderConfig(accel="brute", **TRAIN_CFG), W, H, 2)
    jloss, jgrads = jstep(jsd, dataclasses.replace(jcam, aspect=W / H).params(),
                          jnp.asarray(px), jnp.asarray(py), jnp.asarray(target),
                          jax.random.PRNGKey(KEY))
    tstep = make_train_step(tint.RenderConfig(**TRAIN_CFG), W, H, 2)
    tloss, tgrads = tstep(tsd, tint.camera_params(tcam, W, H, "cpu"), torch.from_numpy(px),
                          torch.from_numpy(py), torch.from_numpy(target), trng.prng_key(KEY))
    return (float(jloss), [np.asarray(g) for g in jax.tree.leaves(jgrads)]), (tloss, tgrads)


def test_train_step_matches_jax(train_steps):
    (jloss, jgrads), (tloss, tgrads) = train_steps
    assert isinstance(tgrads[0], tpar.MaterialGrads)
    flat = [*tgrads[0], tgrads[1], tgrads[2]]
    assert all(isinstance(g, torch.Tensor) for g in flat)
    assert abs(float(tloss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert_grads_agree([g.numpy() for g in flat], jgrads)


def test_unreached_parameters_get_zeros(train_steps):
    """No path of small_scene reaches an emissive factor, and config2's
    colour environment has no texels a path reads: JAX returns zeros, and
    so does the port, not None."""
    (_, jgrads), (_, tgrads) = train_steps
    assert torch.equal(tgrads[0].emissive, torch.zeros(2, 3))
    assert not np.abs(jgrads[NAMES.index("emissive")]).any()
    _, tsd, _, tcam = scenes("config2")
    px, py = (torch.from_numpy(v) for v in pixels(4, 4))
    step = make_train_step(tint.RenderConfig(spp=1, max_depth=2), 4, 4, 1)
    loss, (mat, ls, tex) = step(tsd, tint.camera_params(tcam, 4, 4, "cpu"), px, py,
                                torch.zeros(16, 3), trng.prng_key(0))
    assert float(loss) > 0 and mat.albedo.abs().sum() > 0
    assert ls.shape == (0,) and torch.equal(tex, torch.zeros(1, 1, 3))


def test_make_train_step_refuses_a_mesh():
    """A mesh whose shard count does not divide the pixels is refused, as
    JAX's shard_map refuses it (sharded steps: tests/test_torch_parallel.py)."""
    _, tsd, _, tcam = scenes("small_scene")
    px, py = (torch.from_numpy(v) for v in pixels())
    step = make_train_step(tint.RenderConfig(spp=1, max_depth=2), W, H, 1,
                           mesh=make_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="64 rows not divisible by mesh size 3"):
        step(tsd, tint.camera_params(tcam, W, H, "cpu"), px, py, torch.zeros(W * H, 3),
             trng.prng_key(0))


def _step_launches(step, *args):
    """(loss, grads, plain calls of the forward, plain calls of the backward)."""
    before = LAUNCHES["plain"]
    loss, grads = step(*args)
    forward = step.forward_launches["plain"] - before
    return loss, grads, forward, LAUNCHES["plain"] - before - forward


def test_replay_matches_no_replay():
    """Replaying each sample in the backward gives the gradients of keeping
    every sample's graph, and re-runs every intersection dispatch of the
    forward: 2 spp x (1 + 1 + 2) dispatches at depth 3."""
    _, tsd, _, tcam = scenes("small_scene")
    px, py = (torch.from_numpy(v) for v in pixels())
    args = (tsd, tint.camera_params(tcam, W, H, "cpu"), px, py, torch.full((W * H, 3), 0.5),
            trng.prng_key(KEY))
    cfg = tint.RenderConfig(spp=2, max_depth=3)
    loss_r, grads_r, fwd_r, bwd_r = _step_launches(make_train_step(cfg, W, H, 2), *args)
    loss_k, grads_k, fwd_k, bwd_k = _step_launches(
        make_train_step(cfg, W, H, 2, replay=False), *args)
    assert (fwd_r, bwd_r, fwd_k, bwd_k) == (8, 8, 8, 0)
    assert float(loss_r) == float(loss_k)
    for a, b in zip([*grads_r[0], *grads_r[1:]], [*grads_k[0], *grads_k[1:]]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


def test_render_is_the_same_with_grad_enabled():
    """render() of a scene whose albedo requires grad, under torch.no_grad
    and with grad enabled (then every sample is replayed in a backward): the
    same image, the same plain calls, and a backward that reaches albedo."""
    _, tsd, _, tcam = scenes("small_scene")
    leaves, sd = leaves_of(tsd)
    cfg = tint.RenderConfig(spp=2, max_depth=3)
    films, calls = [], []
    for grad in (False, True):
        before = LAUNCHES["plain"]
        with torch.set_grad_enabled(grad):
            films.append(tint.render(sd, tcam, W, H, cfg, key=trng.prng_key(KEY)))
        calls.append(LAUNCHES["plain"] - before)
    assert torch.equal(films[0].ld, films[1].ld.detach())
    assert calls[0] == calls[1] == 8
    assert not films[0].ld.requires_grad and films[1].ld.requires_grad
    films[1].ld.sum().backward()
    assert leaves[0].grad is not None and leaves[0].grad.abs().sum() > 0


def floor_scene(roughness=1.0, metallic=0.0):
    """tests/test_integrator.py's floor_scene: a floor (Lambertian unless
    given a roughness and metallic) under an overhead directional light
    (ls 2), black environment."""
    s = TScene()
    s.set_environment_color((0, 0, 0), ls=0.0)
    mat = s.add_material(albedo=(0.8, 0.4, 0.2), roughness=roughness, metallic=metallic)
    p = np.array([[-10, 0, -10], [10, 0, -10], [10, 0, 10], [-10, 0, 10]], np.float32)
    s.add_mesh(p, np.array([[0, 2, 1], [0, 3, 2]]),
               normals=np.tile([[0, 1, 0]], (4, 1)).astype(np.float32), material_id=mat)
    s.add_directional_light((0, 1, 0), color=(1, 1, 1), ls=2.0)
    return s.build("cpu")


@pytest.mark.parametrize("field, index, rtol", [("ls", 0, 1e-3), ("albedo", 0, 2e-2)])
def test_finite_differences(field, index, rtol):
    """tests/test_integrator.py's finite differences on the port: 4x4
    rays, 1 spp, depth 2; radiance is linear in ls."""
    sd = floor_scene()
    px, py = (torch.from_numpy(v) for v in pixels(4, 4))
    rays = tgen(tint.camera_params(TCam(**FLOOR_CAM), 4, 4, "cpu"), 4, 4, px, py,
                torch.zeros(16, 2))
    cfg = tint.RenderConfig(spp=1, max_depth=2)
    _, grads = port_trace_grads(sd, rays, 2, key=0)
    grad = grads[NAMES.index(field)].reshape(-1)[index]
    assert grad != 0

    def loss(delta):
        mat, ls, tex = tpar.scene_params(sd)
        if field == "ls":
            ls = ls + delta
        else:
            mat = mat._replace(albedo=mat.albedo + torch.tensor([[delta, 0.0, 0.0]]))
        return float(tint.trace_radiance(tpar.with_params(sd, (mat, ls, tex)), *rays,
                                         trng.prng_key(0), cfg).sum())

    eps = 1e-2
    fd = (loss(eps) - loss(-eps)) / (2 * eps)
    np.testing.assert_allclose(grad, fd, rtol=rtol)


@pytest.mark.parametrize("field, index", [("roughness", 0), ("metallic", 0), ("fresnel", 1)])
def test_finite_differences_glossy(field, index):
    """Central differences on the glossy terms (ROADMAP Queue 3 #1, which
    the JAX package holds only as finite and nonzero): a glossy half-metal
    floor (roughness 0.5, metallic 0.4), 4x4 rays, 1 spp, depth 2.  The
    floor has no silhouette and the black environment contributes nothing,
    so the radiance is the sun's smooth GGX-plus-Lambert response and the
    autograd gradient meets the central difference (eps 2e-3) within 1e-3
    relative.  (At roughness 0.35 the sum's roughness derivative is small,
    -0.61 against -68 at 0.5, and an eps small enough for the curvature
    there meets float32 noise.)"""
    sd = floor_scene(roughness=0.5, metallic=0.4)
    px, py = (torch.from_numpy(v) for v in pixels(4, 4))
    rays = tgen(tint.camera_params(TCam(**FLOOR_CAM), 4, 4, "cpu"), 4, 4, px, py,
                torch.zeros(16, 2))
    cfg = tint.RenderConfig(spp=1, max_depth=2)
    _, grads = port_trace_grads(sd, rays, 2, key=0)
    grad = grads[NAMES.index(field)].reshape(-1)[index]
    assert grad != 0

    def loss(delta):
        mat, ls, tex = tpar.scene_params(sd)
        value = getattr(mat, field).clone()
        value.view(-1)[index] += delta
        mat = mat._replace(**{field: value})
        return float(tint.trace_radiance(tpar.with_params(sd, (mat, ls, tex)), *rays,
                                         trng.prng_key(0), cfg).double().sum())

    eps = 2e-3
    fd = (loss(eps) - loss(-eps)) / (2 * eps)
    np.testing.assert_allclose(grad, fd, rtol=1e-3)


def test_sgd_step_lowers_loss():
    """tests/test_parallel.py's step: one SGD step on albedo against the
    same scene rendered with albedo 0.9 lowers the loss (8x8 x 2 spp x
    depth 2)."""
    _, tsd, _, tcam = scenes("small_scene")
    cam = tint.camera_params(tcam, W, H, "cpu")
    px, py = (torch.from_numpy(v) for v in pixels())
    key = trng.prng_key(0)
    cfg = tint.RenderConfig(**TRAIN_CFG)
    bright = tsd._replace(materials=tsd.materials._replace(
        albedo=torch.full_like(tsd.materials.albedo, 0.9)))
    target = tint.render_tile_radiance(bright, cam, W, H, px, py, key, cfg) / cfg.spp
    step = make_train_step(cfg, W, H, cfg.spp)
    loss0, (g_mat, _, _) = step(tsd, cam, px, py, target, key)
    assert g_mat.albedo.abs().sum() > 0
    stepped = tsd._replace(materials=tsd.materials._replace(
        albedo=tsd.materials.albedo - 0.5 * g_mat.albedo))
    loss1, _ = step(stepped, cam, px, py, target, key)
    assert float(loss1) < float(loss0)


def test_build_distribution_traced():
    """The traced tables equal both packages' host builds and the JAX traced
    build, and the gradients of the pdf texture and the row CDF w.r.t. the
    texels equal jax.grad's.  (The column CDFs' gradient divides by the pole
    row's marginal squared, 0 since sin 0 = 0: 1e-20 ** 2 is subnormal, which
    XLA's CPU code flushes to zero, so jax.grad gives NaN there; nothing
    differentiates the CDFs in a render.)"""
    rs = np.random.default_rng(3)
    tex = (rs.uniform(0.05, 2.0, (8, 16, 3)) ** 2).astype(np.float32)
    tex[2, 5] = 40.0
    weights = [rs.normal(size=s).astype(np.float32) for s in ((8,), (8, 16))]
    tt = torch.from_numpy(tex).requires_grad_(True)
    traced = tenv.build_distribution_traced(tt)
    for ref in (tenv.build_distribution(tex, "cpu"), jenv.build_distribution(tex),
                jenv.build_distribution_traced(jnp.asarray(tex))):
        for a, b in zip(traced, ref):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)

    def jloss(t):
        d = jenv.build_distribution_traced(t)
        return jnp.sum(d.marginal_cdf * weights[0]) + jnp.sum(d.pdf_texture * weights[1])

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(tex)))
    (got,) = torch.autograd.grad((traced.marginal_cdf * torch.from_numpy(weights[0])).sum()
                                 + (traced.pdf_texture * torch.from_numpy(weights[1])).sum(),
                                 [tt])
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _params(seed):
    """Train-step parameters of distinct values: (MaterialGrads, ls, tex)."""
    rs = np.random.default_rng(seed)
    shapes = ((3, 3), (3,), (3,), (3, 3), (3, 3), (2,), (4, 8, 3))
    return [rs.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_params_round_trip_between_packages(saver, tmp_path):
    """save_params of either package loads in the other's load_params (and
    in its own), leaf for leaf in jax.tree.flatten's order."""
    arrays = _params(11)
    tparams = (tpar.MaterialGrads(*(torch.from_numpy(a) for a in arrays[:5])),
               *(torch.from_numpy(a) for a in arrays[5:]))
    jparams = (jpar.MaterialGrads(*(jnp.asarray(a) for a in arrays[:5])),
               *(jnp.asarray(a) for a in arrays[5:]))
    path = str(tmp_path / "params.npz")
    if saver == "port":
        tckpt.save_params(path, tparams)
        assert str(np.load(path)["treedef"]) == "(MaterialGrads(*, *, *, *, *), *, *)"
    else:
        jckpt.save_params(path, jparams)
    tlike = (tpar.MaterialGrads(*(torch.zeros(a.shape) for a in arrays[:5])),
             *(torch.zeros(a.shape) for a in arrays[5:]))
    tload = tckpt.load_params(path, tlike)
    jload = jckpt.load_params(path, jparams)
    assert isinstance(tload[0], tpar.MaterialGrads) and isinstance(jload[0], jpar.MaterialGrads)
    flat_t = [*tload[0], *tload[1:]]
    flat_j = jax.tree.leaves(jload)
    for a, t, j in zip(arrays, flat_t, flat_j):
        np.testing.assert_array_equal(t.numpy(), a)
        np.testing.assert_array_equal(np.asarray(j), a)
