"""The port's Scene.build() against the JAX Scene.build() on the same calls:
the leaf-order triangles and packed shading rows, the BVH node table, the
material table, the environment CDFs, the directional lights and the area
light must be equal, not close (both run the same host numpy and the same
native builder source with the same flags).  scene_data_from_arrays must
reproduce the JAX arrays it is given."""

import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.models import primitives as jprim
from mc_path_tracer_tpu.models.primitives import plane, uv_sphere
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu_torch.models import lights as tlights
from mc_path_tracer_tpu_torch.models import primitives as tprim
from mc_path_tracer_tpu_torch.models.scene import (
    Scene as TScene,
    scene_arrays,
    scene_data_from_arrays,
)


def small_scene(scene_cls, roughness=0.3):
    """A floor quad and a 192-triangle UV sphere (194 triangles), a 16x32
    HDR environment and one directional light."""
    env = (np.random.default_rng(0).uniform(0.1, 2.0, size=(16, 32, 3)) ** 2
           ).astype(np.float32)
    s = scene_cls()
    s.set_environment_hdr(env, ls=1.0)
    s.add_directional_light((0.4, 1.0, 0.2), color=(1.0, 0.95, 0.8), ls=3.0)
    floor = s.add_material(albedo=(0.7, 0.7, 0.7), roughness=0.9)
    p, n, uv, idx = plane(10.0)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=floor)
    ball = s.add_material(albedo=(0.8, 0.3, 0.2), roughness=roughness, metallic=0.5)
    p, n, uv, idx = uv_sphere(0.8, center=(0, 0.8, 0), rings=8, segments=12)
    s.add_mesh(p, idx, normals=n, uvs=uv, material_id=ball)
    return s


@pytest.fixture(scope="module")
def built():
    return small_scene(JScene).build(), small_scene(TScene).build("cpu")


@pytest.mark.parametrize("name, kwargs", [
    ("uv_sphere", dict(radius=0.7, center=(1.8, 0.7, -1.8), rings=32, segments=50)),
    ("uv_sphere", dict(radius=0.8, center=(0, 0.8, 0), rings=8, segments=12)),
    ("plane", dict(size=40.0)),
    ("plane", dict(size=2.0, center=(0, 3, 1), normal_axis="z")),
    ("box", dict(size=(1.2, 1.2, 1.2), center=(-1.0, 0.6, 0.0))),
    ("box", dict()),
])
def test_primitives_equal_jax(name, kwargs):
    """The port's primitives give the JAX package's arrays exactly."""
    for a, b in zip(getattr(tprim, name)(**kwargs), getattr(jprim, name)(**kwargs)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _compare(port_arrays: dict, jax_arrays: dict, prefixes):
    keys = [k for k in jax_arrays if k.startswith(prefixes)]
    assert keys
    for k in keys:
        assert k in port_arrays, k
        np.testing.assert_array_equal(port_arrays[k], jax_arrays[k], err_msg=k)


def test_scene_build_equals_jax(built):
    jsd, tsd = built
    assert tsd.tris.num_triangles == jsd.tris.num_triangles == 194
    assert tsd.tris.attrs.shape == (194, 28)
    ja, ta = scene_arrays(jsd), scene_arrays(tsd)
    _compare(ta, ja, ("tris.", "bvh.", "materials.", "lights.env.", "lights.directional."))
    np.testing.assert_array_equal(
        ta["tris.geo"], np.concatenate([ja["tris.v0"], ja["tris.e1"], ja["tris.e2"]], 1))


def test_scene_data_from_arrays_reproduces_jax(built):
    jsd, _ = built
    ja = scene_arrays(jsd)
    sd = scene_data_from_arrays(ja, device="cpu")
    _compare(scene_arrays(sd), ja,
             ("tris.", "bvh.", "materials.", "lights.env.", "lights.directional."))
    assert sd.tris.geo.is_contiguous() and sd.tris.geo.dtype == torch.float32


def with_emitter(scene_cls):
    """small_scene plus an unused emissive material and a 1 m emissive quad
    facing down at y = 3 (its two triangles become the area light)."""
    s = small_scene(scene_cls)
    s.add_material(emissive=(9.0, 9.0, 9.0))
    em = s.add_material(emissive=(5.0, 4.0, 3.0))
    p, n, uv, idx = plane(1.0, center=(0, 3, 0))
    s.add_mesh(p, idx[:, ::-1].copy(), normals=-n, uvs=uv, material_id=em)
    return s


def test_emissive_mesh_builds_the_area_light():
    """Emissive triangles become the area light after the BVH reorder, with
    the JAX build's leaf-order ids, emission, areas and CDF."""
    jsd, tsd = with_emitter(JScene).build(), with_emitter(TScene).build("cpu")
    assert tsd.lights.area.count == jsd.lights.area.count == 2
    assert tlights.area_light_id(tsd.lights) == 2 and tlights.num_lights(tsd.lights) == 3
    ja, ta = scene_arrays(jsd), scene_arrays(tsd)
    _compare(ta, ja, ("tris.", "bvh.", "lights.area."))
    np.testing.assert_allclose(ta["lights.area.total_area"], 1.0, rtol=1e-6)
    # scenes without emitters carry an empty area light
    assert small_scene(TScene).build("cpu").lights.area.count == 0


def test_unported_scene_features_are_refused(built):
    """Textures, refused by the first slices, are carried across: a JAX
    scene whose materials point into a two-texture atlas arrives with the
    same texture ids and atlas."""
    textured = small_scene(JScene)
    r = np.random.default_rng(5)
    t0 = textured.add_texture(r.random((4, 8, 3)).astype(np.float32))
    t1 = textured.add_texture(r.random((6, 2, 3)).astype(np.float32))
    textured.add_material(albedo=(0.5, 0.5, 0.5), albedo_tex=t0, normal_tex=t1, mr_tex=t1)
    ja = scene_arrays(textured.build())
    assert (ja["materials.albedo_tex"] >= 0).any() and ja["atlas.data"].shape == (2, 6, 8, 3)
    sd = scene_data_from_arrays(ja, device="cpu")
    _compare(scene_arrays(sd), ja, ("materials.", "atlas."))
    assert sd.atlas.count == 2
    # a scene without textures arrives with an empty atlas
    assert scene_data_from_arrays(scene_arrays(built[0]), device="cpu").atlas.count == 0
