"""The area light: the port's scene build, `make_area_lights`,
`sample_area` and `area_eval_hit` against the JAX functions run eagerly on
the same leaf-order triangles, `scene_data_from_arrays` carrying the light
across, and the port's config2 (cube + sphere + emissive quad, MIS)
rendered on the CPU against tests/golden/config2.npy, the JAX render that
tests/test_golden.py holds.

Tolerances: the light's tables are host numpy in both packages and must be
equal; the per-ray functions are a few f32 operations, held to rtol 1e-5;
the render is held as tests/test_torch_integrator.py holds renders (per
pixel rtol 1e-4 / atol 1e-5 on at least 99% of pixels, frame mean within
1e-4 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu import configs as jconfigs
from mc_path_tracer_tpu.models import lights as jlights
from mc_path_tracer_tpu.models.primitives import plane
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu.ops import intersect as jisect
from mc_path_tracer_tpu_torch import configs as tconfigs
from mc_path_tracer_tpu_torch.models import lights as tlights
from mc_path_tracer_tpu_torch.models.integrator import RenderConfig, render
from mc_path_tracer_tpu_torch.models.scene import (
    Scene as TScene,
    scene_arrays,
    scene_data_from_arrays,
)
from mc_path_tracer_tpu_torch.ops import intersect as tisect
from mc_path_tracer_tpu_torch.ops import rng as trng
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, traversal

EMIT = (4.0, 3.0, 2.0)
AREA_CAM = dict(position=np.array([0.6, 3.0, 2.5]), target=np.array([0.0, 0.0, 0.0]),
                fov_deg=35.0)


def area_scene(scene_cls=TScene):
    """tests/test_arealight.py's area_scene: a Lambertian floor and a 1x1
    emissive quad at y = 2 facing down, black environment (4 triangles)."""
    s = scene_cls()
    s.set_environment_color((0, 0, 0), ls=0.0)
    floor = s.add_material(albedo=(0.7, 0.5, 0.3), roughness=1.0, metallic=0.0)
    p, n, uv, idx = plane(20.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    em = s.add_material(albedo=(0, 0, 0), roughness=1.0, emissive=EMIT)
    q = np.array([[-0.5, 2, -0.5], [0.5, 2, -0.5], [0.5, 2, 0.5], [-0.5, 2, 0.5]],
                 np.float32)
    s.add_mesh(q, np.array([[0, 1, 2], [0, 2, 3]]),
               normals=np.tile([[0, -1, 0]], (4, 1)).astype(np.float32), material_id=em)
    return s


@pytest.fixture(scope="module")
def config2():
    """config2 built by both packages: (JAX SceneData, port SceneData built by
    the port's Scene, port SceneData carried from the JAX arrays)."""
    jsd = jconfigs.config2_mis_area_light()[0].build()
    tsd = tconfigs.config2_mis_area_light()[0].build("cpu")
    return jsd, tsd, scene_data_from_arrays(scene_arrays(jsd), device="cpu")


def test_config2_build_equals_jax(config2):
    """Same triangles in the same leaf order, same tree and the same area
    light: the emissive quad's two triangles, in leaf order."""
    jsd, tsd, carried = config2
    assert tsd.tris.num_triangles == 2320 and tsd.lights.area.count == 2
    ja = scene_arrays(jsd)
    for sd in (tsd, carried):
        ta = scene_arrays(sd)
        keys = [k for k in ja if k.startswith(("tris.", "bvh.", "materials.", "lights."))
                and not k.startswith("lights.env.packed")]
        assert any(k.startswith("lights.area.") for k in keys)
        for k in keys:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert tlights.area_light_id(tsd.lights) == jlights.area_light_id(jsd.lights) == 1
    assert tlights.num_lights(tsd.lights) == jlights.num_lights(jsd.lights) == 2


def test_make_area_lights_matches_jax(config2):
    jsd, _, carried = config2
    rng = np.random.default_rng(0)
    mask = rng.random(carried.tris.num_triangles) < 0.05
    emission = rng.uniform(0.5, 9.0, (carried.tris.num_triangles, 3)).astype(np.float32)
    got = tlights.make_area_lights(carried.tris, mask, emission, device="cpu")
    want = jlights.make_area_lights(jsd.tris, mask, emission)
    assert got.count == want.count == mask.sum()
    for a, b, name in zip(got, want, tlights.AreaLights._fields):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    empty = tlights.make_area_lights(carried.tris, np.zeros_like(mask), emission, device="cpu")
    assert empty.count == 0 and tlights.num_lights(carried.lights._replace(area=empty)) == 1


def _close(a, b, name):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)


def test_sample_area_matches_jax(config2):
    jsd, _, carried = config2
    rng = np.random.default_rng(1)
    n = 512
    pos = np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 2.5, n), rng.uniform(-3, 3, n)],
                   axis=-1).astype(np.float32)
    u3 = rng.random((n, 3)).astype(np.float32)
    u3[:4] = [[0.0, 0.0, 0.0], [0.5, 1.0, 1.0], [np.nextafter(1, 0)] * 3, [1.0, 0.25, 0.5]]
    got = tlights.sample_area(carried.lights.area, carried.tris,
                              torch.from_numpy(pos), torch.from_numpy(u3))
    want = jlights.sample_area(jsd.lights.area, jsd.tris, jnp.asarray(pos), jnp.asarray(u3))
    for a, b, name in zip(got, want, ("wi", "dist", "li", "pdf_sa")):
        _close(a, b, name)
    assert (got[3].numpy() > 0).mean() > 0.9  # most points see the quad's front


def test_area_eval_hit_matches_jax(config2):
    """BRDF rays from the floor and the box, about half of them aimed at the
    quad: hit records from the brute oracle (JAX) and the plain closest hit
    (port), then the area light's (li, pdf, on_light) for each."""
    jsd, _, carried = config2
    rng = np.random.default_rng(2)
    n = 600
    ro = np.stack([rng.uniform(-2, 2, n), np.full(n, 0.01), rng.uniform(-2, 2, n)], -1)
    aim = np.stack([rng.uniform(-0.8, 0.8, n), np.full(n, 3.0), rng.uniform(-0.8, 0.8, n)], -1)
    rd = np.where(rng.random((n, 1)) < 0.5, aim - ro, rng.normal(size=(n, 3)))
    rd[:, 1] = np.abs(rd[:, 1])
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro, rd = ro.astype(np.float32), rd.astype(np.float32)
    # jitted: the eager oracle spends seconds dispatching its many small ops
    jh = jax.jit(jisect.intersect_brute)(jsd.tris, jnp.asarray(ro), jnp.asarray(rd))
    tro, trd = torch.from_numpy(ro), torch.from_numpy(rd)
    _, tri_id = traversal.closest_plain(tisect.pack_rays(tro, trd), carried.tris.geo)
    th = tisect.finish_closest(carried.tris, tri_id, tro, trd)
    np.testing.assert_array_equal(th.tri_id.numpy(), np.asarray(jh.tri_id))
    got = tlights.area_eval_hit(carried.lights.area, carried.tris, th, tro)
    want = jlights.area_eval_hit(jsd.lights.area, jsd.tris, jh, jnp.asarray(ro))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0.2 < got[2].numpy().mean() < 0.8
    _close(got[0], want[0], "li")
    _close(got[1], want[1], "pdf_sa")


@pytest.fixture
def one_thread():
    """Run torch on one thread: the test suite runs in several worker
    processes, and a render's many small ops slow down tenfold when each
    worker spins a full set of intra-op threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_config2_render_matches_golden(one_thread):
    """The port's config2 at 16x16, 8 spp, depth 3, key 42 on the CPU
    against the JAX render stored in tests/golden/config2.npy; on CPU
    tensors every dispatch takes the plain version: 4 closest hits and 2
    bounded any-hits per pass (LAUNCHES["anyhit_bounded"]), each over
    lanes sorted by sort_rays, and the 8 samples of the frame's one block
    run in one pass."""
    scene, cam, _, _ = tconfigs.config2_mis_area_light()
    before = dict(LAUNCHES)
    img = render(scene, cam, 16, 16, RenderConfig(spp=8, max_depth=3),
                 key=trng.prng_key(42), device="cpu").radiance_mean().numpy()
    want = np.load("tests/golden/config2.npy")
    assert img.shape == want.shape == (16, 16, 3) and np.isfinite(img).all()
    close = np.isclose(img, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - want).max())
    assert abs(img.mean() - want.mean()) <= 1e-4 * abs(want.mean())
    assert LAUNCHES["plain"] - before["plain"] == 1 * 6
    assert LAUNCHES["sort"] - before["sort"] == 1 * 6
    assert LAUNCHES["anyhit_bounded"] - before["anyhit_bounded"] == 1 * 2
    assert all(LAUNCHES[k] == before[k] for k in LAUNCHES
               if k not in ("plain", "sort", "anyhit_bounded"))


def test_area_scene_renders_its_emitter():
    """Looking up at the quad's underside, the centre pixels see the full
    emission (primary-hit emission), as tests/test_arealight.py asserts of
    the JAX render."""
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera

    cam = PerspectiveCamera(position=np.array([0.05, 0.5, 0.08]),
                            target=np.array([0.0, 2.0, 0.0]), fov_deg=45.0,
                            up=np.array([0.0, 0.0, 1.0]))
    img = render(area_scene(), cam, 16, 16, RenderConfig(spp=2, max_depth=2),
                 device="cpu").radiance_mean().numpy()
    assert img.max() >= max(EMIT) * 0.9


def test_area_scene_builds_like_jax():
    jsd, tsd = area_scene(JScene).build(), area_scene().build("cpu")
    ja, ta = scene_arrays(jsd), scene_arrays(tsd)
    for k in [k for k in ja if k.startswith(("tris.", "lights.area."))]:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    np.testing.assert_allclose(float(tsd.lights.area.total_area), 1.0, rtol=1e-5)
