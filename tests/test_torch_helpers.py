"""The JAX package's public helpers that the port carries under the same
names, each against its JAX function on the same seeded inputs:
Film.accumulate / clear, materials.default_material, scene.concat_soa,
ops.math.length / luminance / mix / transform_point / transform_dir,
ops.rng.uniforms (bit-equal to jax.random.uniform) and
ops.intersect.intersect_brute / occluded_brute.  Vector math is held to
test_torch_ops.py's rtol 1e-5 / atol 1e-6 (the JAX CPU backend fuses
multiply-adds and orders its sums its own way); everything that is
copied, counted or drawn from threefry must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.models import film as jfilm
from mc_path_tracer_tpu.models import materials as jmat
from mc_path_tracer_tpu.models import scene as jscene
from mc_path_tracer_tpu.models.primitives import box, uv_sphere
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu.ops import intersect as jisect
from mc_path_tracer_tpu.ops import math as jmath
from mc_path_tracer_tpu.ops import rng as jrng
from mc_path_tracer_tpu_torch.models import film as tfilm
from mc_path_tracer_tpu_torch.models import materials as tmat
from mc_path_tracer_tpu_torch.models import scene as tscene
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from mc_path_tracer_tpu_torch.ops import intersect as tisect
from mc_path_tracer_tpu_torch.ops import math as tmath
from mc_path_tracer_tpu_torch.ops import rng as trng
from tests.test_torch_ops import assert_close, both, rng, unit
from tests.test_torch_scene import small_scene
from tests.test_torch_sort import rays


def test_film_accumulate_and_clear():
    r = rng(11)
    ld, add = r.random((2, 6, 5, 3)).astype(np.float32)
    samples = r.integers(0, 9, (6, 5)).astype(np.float32)
    jf, tf = jfilm.Film(jnp.asarray(ld), jnp.asarray(samples)), tfilm.Film(
        torch.from_numpy(ld), torch.from_numpy(samples))
    for j, t in ((jf.accumulate(jnp.asarray(add), 2.0), tf.accumulate(torch.from_numpy(add), 2.0)),
                 (jf.clear(), tf.clear())):
        assert isinstance(t, tfilm.Film)
        np.testing.assert_array_equal(t.ld.numpy(), np.asarray(j.ld))
        np.testing.assert_array_equal(t.samples.numpy(), np.asarray(j.samples))


def test_default_material():
    t, j = tmat.default_material(device="cpu"), jmat.default_material()
    assert t._fields == j._fields
    for name, a, b in zip(t._fields, t, j):
        assert a.device.type == "cpu"
        assert a.numpy().dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("tangents", ["all", "some"])
def test_concat_soa(tangents):
    """Two meshes' host arrays in order; tangents are dropped unless every
    part has them."""
    p, n, uv, idx = uv_sphere(0.5, rings=4, segments=6)
    q, m, uv2, idx2 = box((1.0, 2.0, 0.5), center=(1.0, 0.0, 0.0))
    tan = np.tile(np.float32([1.0, 0.0, 0.0, -1.0]), (p.shape[0], 1))
    parts = {}
    for pkg, mesh_to_soa in (("jax", jscene._mesh_to_soa), ("port", tscene._mesh_to_soa)):
        second = mesh_to_soa(q, m, uv2, idx2, 1)
        if tangents == "some":
            second = second._replace(tan0=None, tan1=None, tan2=None)
        parts[pkg] = [mesh_to_soa(p, n, uv, idx, 0, tan), second]
    got, want = tscene.concat_soa(parts["port"]), jscene.concat_soa(parts["jax"])
    assert (got.tan0 is None) == (want.tan0 is None) == (tangents == "some")
    assert got.attrs is None and got.geo is None
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert isinstance(a, np.ndarray) and a.dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert got.v0.shape[0] == idx.shape[0] + idx2.shape[0]


@pytest.mark.parametrize("name", ["length", "luminance", "mix"])
def test_math_helpers(name):
    r = rng(12)
    args = [r.normal(size=(2048, 3)).astype(np.float32) for _ in range(2)]
    if name == "mix":
        args.append(r.random((2048, 1)).astype(np.float32))
    j, t = both(*args[: {"length": 1, "luminance": 1, "mix": 3}[name]])
    assert_close(getattr(tmath, name)(*t), getattr(jmath, name)(*j))


def test_transform_point_and_dir():
    """Through the camera's view-projection (a w-divide that cancels) and a
    rigid transform, full f32 on both sides."""
    eye, center, up = [0.3, 4.0, 9.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0]
    mats = (
        (tmath.perspective(0.8, 1.7, 0.1, 100.0, device="cpu")
         @ tmath.look_at(eye, center, up, device="cpu"),
         jmath.perspective(0.8, 1.7, 0.1, 100.0)
         @ jmath.look_at(jnp.asarray(eye), jnp.asarray(center), jnp.asarray(up))),
        (tmath.look_at(eye, center, up, device="cpu"),
         jmath.look_at(jnp.asarray(eye), jnp.asarray(center), jnp.asarray(up))),
    )
    r = rng(13)
    j, t = both(r.uniform(-2.0, 2.0, (512, 3)).astype(np.float32), unit(r, 512))
    for mt, mj in mats:
        assert_close(tmath.transform_point(mt, t[0]), jmath.transform_point(mj, j[0]))
        assert_close(tmath.transform_dir(mt, t[1]), jmath.transform_dir(mj, j[1]))


@pytest.mark.parametrize("shape, n", [((37,), 10), ((4, 9), 3), ((), 5)])
def test_uniforms_bit_equal(shape, n):
    jk, tk = jax.random.fold_in(jax.random.PRNGKey(7), 3), trng.fold_in(trng.prng_key(7), 3)
    want = np.asarray(jrng.uniforms(jk, shape, n))
    got = trng.uniforms(tk, shape, n, device="cpu").numpy()
    assert got.shape == want.shape == (*shape, n)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def built():
    return small_scene(JScene).build(), small_scene(TScene).build("cpu")


def test_intersect_brute(built):
    """Hit, t and tri_id on every lane; the shading of hit lanes (the JAX
    package leaves a miss lane's attributes unsanitised)."""
    jsd, tsd = built
    ro, rd, _ = rays(14, 1000)
    j, t = both(ro, rd)
    got, want = tisect.intersect_brute(tsd.tris, *t), jisect.intersect_brute(jsd.tris, *j)
    hit = np.array(want.hit)
    assert 100 < hit.sum() < 1000
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))
    assert_close(got.t, want.t)
    for name in ("position", "normal", "uv", "tangent", "bitangent"):
        assert_close(getattr(got, name)[hit], np.asarray(getattr(want, name))[hit])
    np.testing.assert_array_equal(got.material_id.numpy()[hit],
                                  np.asarray(want.material_id)[hit])


@pytest.mark.parametrize("bounded", [True, False])
def test_occluded_brute(built, bounded):
    jsd, tsd = built
    ro, rd, _ = rays(15, 1000)
    t_max = rng(16).uniform(0.1, 3.0, 1000).astype(np.float32) if bounded else None
    j, t = both(ro, rd)
    got = tisect.occluded_brute(tsd.tris, *t,
                                t_max=None if t_max is None else torch.from_numpy(t_max))
    want = np.asarray(jisect.occluded_brute(jsd.tris, *j,
                                            t_max=None if t_max is None else jnp.asarray(t_max)))
    assert 0 < want.sum() < 1000
    np.testing.assert_array_equal(got.numpy(), want)
