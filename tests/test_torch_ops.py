"""The port's leaf numerics against their jnp counterparts on the same random
inputs: math, sampling, BRDF, material table, envmap, camera, film tile
order, tone map and lights.  Same f32 formulas on both sides, so rtol 1e-5 / atol 1e-6 (the JAX
CPU backend fuses multiply-adds and has its own transcendentals, so results
differ in the last bits); integer results (quantize, tile order, CDF
searches) must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.models import camera as jcam
from mc_path_tracer_tpu.models import film as jfilm
from mc_path_tracer_tpu.models import lights as jlights
from mc_path_tracer_tpu.models import materials as jmat
from mc_path_tracer_tpu.ops import brdf as jbrdf
from mc_path_tracer_tpu.ops import envmap as jenv
from mc_path_tracer_tpu.ops import math as jmath
from mc_path_tracer_tpu.ops import sampling as jsamp
from mc_path_tracer_tpu.ops import tonemap as jtone
from mc_path_tracer_tpu_torch.models import camera as tcam
from mc_path_tracer_tpu_torch.models import film as tfilm
from mc_path_tracer_tpu_torch.models import lights as tlights
from mc_path_tracer_tpu_torch.models import materials as tmat
from mc_path_tracer_tpu_torch.ops import brdf as tbrdf
from mc_path_tracer_tpu_torch.ops import envmap as tenv
from mc_path_tracer_tpu_torch.ops import math as tmath
from mc_path_tracer_tpu_torch.ops import sampling as tsamp
from mc_path_tracer_tpu_torch.ops import tonemap as ttone

RTOL, ATOL = 1e-5, 1e-6
N = 2048


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_close(out, ref):
    if isinstance(ref, (tuple, list)):
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            assert_close(o, r)
        return
    o, r = _np(out), _np(ref)
    assert o.shape == r.shape, (o.shape, r.shape)
    np.testing.assert_allclose(o.astype(np.float64), r.astype(np.float64),
                               rtol=RTOL, atol=ATOL)


def both(*arrays):
    """The same numpy inputs as (jnp arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays])


def rng(seed):
    return np.random.default_rng(seed)


def unit(r, n=N):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def uniforms(r, n=N, k=2):
    return r.random((n, k)).astype(np.float32)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

VEC_FNS = [
    ("dot", 2), ("normalize", 1), ("cross", 2), ("reflect", 2),
    ("build_onb", 1), ("equirect_uv", 1),
]


@pytest.mark.parametrize("name,arity", VEC_FNS)
def test_math_vector_fns(name, arity):
    r = rng(1)
    args = [unit(r) if name in ("build_onb", "equirect_uv") else
            r.normal(size=(N, 3)).astype(np.float32) for _ in range(arity)]
    j, t = both(*args)
    assert_close(getattr(tmath, name)(*t), getattr(jmath, name)(*j))


def test_math_frame_to_world():
    r = rng(2)
    j, t = both(r.random((N, 3)).astype(np.float32), unit(r))
    assert_close(tmath.frame_to_world(t[0], t[1]), jmath.frame_to_world(j[0], j[1]))


def test_math_equirect_dir():
    uv = uniforms(rng(3))
    j, t = both(uv)
    assert_close(tmath.equirect_dir(t[0]), jmath.equirect_dir(j[0]))


def test_math_matrices():
    assert_close(tmath.perspective(0.8, 1.7, 0.1, 1000.0, device="cpu"),
                 jmath.perspective(0.8, 1.7, 0.1, 1000.0))
    eye, center, up = [0.3, 4.0, 9.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0]
    m_t = tmath.look_at(eye, center, up, device="cpu")
    m_j = jmath.look_at(jnp.asarray(eye), jnp.asarray(center), jnp.asarray(up))
    assert_close(m_t, m_j)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "sample_uniform_hemisphere", "sample_cosine_hemisphere",
    "sample_uniform_sphere", "sample_uniform_disk", "sample_concentric_disk",
])
def test_samplers(name):
    u = uniforms(rng(5))
    u[:4] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.2], [0.9, 0.5]]  # disk special cases
    j, t = both(u)
    assert_close(getattr(tsamp, name)(t[0]), getattr(jsamp, name)(j[0]))


def test_power_heuristic():
    r = rng(6)
    f, g = r.random(N).astype(np.float32), r.random(N).astype(np.float32)
    f[:8] = 0.0
    g[:4] = 0.0
    j, t = both(f, g)
    assert_close(tsamp.power_heuristic(1, t[0], 1, t[1]),
                 jsamp.power_heuristic(1, j[0], 1, j[1]))


# ---------------------------------------------------------------------------
# BRDF
# ---------------------------------------------------------------------------


def _materials(seed):
    r = rng(seed)
    arrays = (
        r.random((N, 3)).astype(np.float32),
        r.uniform(0.05, 1.0, N).astype(np.float32),
        r.random(N).astype(np.float32),
        np.full((N, 3), 0.04, np.float32),
    )
    j, t = both(*arrays)
    return jbrdf.MaterialParams(*j), tbrdf.MaterialParams(*t)


def _frames(seed):
    """Random normals with wo and wi in the upper hemisphere (plus a few
    grazing and below-horizon wi)."""
    r = rng(seed)
    n = unit(r)
    wo, wi = unit(r), unit(r)
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)
    wi[: N // 2] = np.where((wi[: N // 2] * n[: N // 2]).sum(-1, keepdims=True) < 0,
                            -wi[: N // 2], wi[: N // 2])
    return both(n, wo, wi)


@pytest.mark.parametrize("name", [
    "mixture_f", "mixture_pdf", "spec_f", "spec_pdf", "diff_f", "diff_pdf",
])
def test_brdf_eval(name):
    jm, tm = _materials(7)
    (jn, jwo, jwi), (tn, two, twi) = _frames(8)
    if name == "diff_pdf":
        out, ref = tbrdf.diff_pdf(tn, twi, two), jbrdf.diff_pdf(jn, jwi, jwo)
    else:
        out = getattr(tbrdf, name)(tm, tn, twi, two)
        ref = getattr(jbrdf, name)(jm, jn, jwi, jwo)
    assert_close(out, ref)


def test_brdf_terms():
    jm, tm = _materials(9)
    (jn, jwo, jwi), (tn, two, twi) = _frames(10)
    assert_close(tm.f0, jm.f0)
    assert_close(tbrdf.fresnel_schlick(tm.f0, two, twi), jbrdf.fresnel_schlick(jm.f0, jwo, jwi))
    assert_close(tbrdf.ndf_ggx_tr(tn, twi, tm.roughness), jbrdf.ndf_ggx_tr(jn, jwi, jm.roughness))
    assert_close(tbrdf.g1_schlick_ggx(twi, tn, tm.roughness),
                 jbrdf.g1_schlick_ggx(jwi, jn, jm.roughness))
    assert_close(tbrdf.geo_atten_schlick_ggx(twi, two, tn, tm.roughness),
                 jbrdf.geo_atten_schlick_ggx(jwi, jwo, jn, jm.roughness))


def test_brdf_sampling():
    jm, tm = _materials(11)
    (jn, jwo, _), (tn, two, _) = _frames(12)
    r = rng(13)
    coin, u2 = r.random(N).astype(np.float32), uniforms(r)
    (jc, ju), (tc, tu) = both(coin, u2)
    assert_close(tbrdf.diff_sample_wi(tn, tu), jbrdf.diff_sample_wi(jn, ju))
    assert_close(tbrdf.spec_sample_wi(tm, tn, two, tu),
                 jbrdf.spec_sample_wi(jm, jn, jwo, ju))
    assert_close(tbrdf.mixture_sample_wi(tm, tn, two, tc, tu),
                 jbrdf.mixture_sample_wi(jm, jn, jwo, jc, ju))


def test_material_table():
    """Untextured gather, emission and perturb_normal are row copies: exact."""
    r = rng(22)
    m = 16
    args = (r.random((m, 3)), r.uniform(0.05, 1.0, m), r.random(m),
            r.uniform(0.02, 0.9, (m, 3)), r.random((m, 3)) * 4)
    jt = jmat.make_material_table(*args)
    tt = tmat.make_material_table(*args, device="cpu")
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    (jid, jn), (tid, tn) = both(r.integers(0, m, N).astype(np.int32), unit(r))
    tid = tid.long()
    for a, b in zip(tt.gather(tid), jt.gather(jid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tt.emission(tid).numpy(), np.asarray(jt.emission(jid)))
    np.testing.assert_array_equal(tt.perturb_normal(tid, None, None, tn, None, None).numpy(),
                                  np.asarray(jt.perturb_normal(jid, None, None, jn, None, None)))


# ---------------------------------------------------------------------------
# environment map
# ---------------------------------------------------------------------------


def _env_tex(h=16, w=32, seed=14):
    return (rng(seed).uniform(0.1, 2.0, size=(h, w, 3)) ** 2).astype(np.float32)


@pytest.mark.parametrize("h,w", [(16, 32), (4, 1100)])
def test_envmap_distribution_and_sampling(h, w):
    """(4, 1100) takes the two-level column search."""
    tex = _env_tex(h, w)
    jd, td = jenv.build_distribution(tex), tenv.build_distribution(tex, "cpu")
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j, t = both(uniforms(rng(15)))
    wi_t, uv_t = tenv.sample_direction(td, t[0])
    wi_j, uv_j = jenv.sample_direction(jd, j[0])
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    assert_close(wi_t, wi_j)
    assert_close(tenv.pdf(td, wi_t), jenv.pdf(jd, wi_j))


def test_envmap_two_level_row_search():
    """A marginal CDF above _FLAT_SEARCH_MAX rows takes the two-level search."""
    tex = _env_tex(1100, 4)
    jd, td = jenv.build_distribution(tex), tenv.build_distribution(tex, "cpu")
    j, t = both(uniforms(rng(16)))
    np.testing.assert_array_equal(tenv.sample_direction(td, t[0])[1].numpy(),
                                  np.asarray(jenv.sample_direction(jd, j[0])[1]))


def test_envmap_pdf_radiance_packed():
    tex = _env_tex()
    jd, td = jenv.build_distribution(tex), tenv.build_distribution(tex, "cpu")
    (jt, jwi), (tt, twi) = both(tex, unit(rng(17)))
    assert_close(tenv.pdf(td, twi), jenv.pdf(jd, jwi))
    assert_close(tenv.radiance(tt, twi), jenv.radiance(jt, jwi))
    assert_close(tenv.pack_bilinear(tt), jenv.pack_bilinear(jt))
    assert_close(tenv.radiance_packed(tenv.pack_bilinear(tt), twi),
                 jenv.radiance_packed(jenv.pack_bilinear(jt), jwi))
    assert_close(tenv.sample_color_mode(torch.from_numpy(uniforms(rng(18)))),
                 jenv.sample_color_mode(jnp.asarray(uniforms(rng(18)))))
    assert_close(tenv.pdf_color_mode(twi), jenv.pdf_color_mode(jwi))


# ---------------------------------------------------------------------------
# camera, film, tone map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lens_radius", [0.0, 0.05])
def test_camera_rays(lens_radius):
    kw = dict(position=np.array([0.3, 4.0, 9.0]), target=np.array([0.0, 0.5, 0.0]),
              fov_deg=45.0, aspect=24 / 16, lens_radius=lens_radius, focal_distance=8.0)
    jp = jcam.PerspectiveCamera(**kw).params()
    tp = tcam.PerspectiveCamera(**kw).params("cpu")
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    r = rng(19)
    px = r.integers(0, 24, N).astype(np.float32)
    py = r.integers(0, 16, N).astype(np.float32)
    (jx, jy, ju), (tx, ty, tu) = both(px, py, uniforms(r))
    assert_close(tcam.gen_camera_rays(tp, 24, 16, tx, ty, tu),
                 jcam.gen_camera_rays(jp, 24, 16, jx, jy, ju))


@pytest.mark.parametrize("w,h", [(24, 16), (1920, 1080), (70, 33)])
def test_tile_order_exact(w, h):
    for a, b in zip(tfilm.tile_order(w, h), jfilm.tile_order(w, h)):
        np.testing.assert_array_equal(a, b)


def test_tonemap():
    r = rng(20)
    ld = (r.random((16, 24, 3)) * 8).astype(np.float32)
    samples = r.integers(0, 5, (16, 24)).astype(np.float32)
    (jl, js), (tl, ts) = both(ld, samples)
    assert_close(ttone.reinhard(tl, ts, 1.3), jtone.reinhard(jl, js, 1.3))
    rgb = np.concatenate([r.random(4096), [0.0, 1.0, 1.5, -0.2, 254.5 / 255]]).astype(np.float32)
    np.testing.assert_array_equal(ttone.quantize(torch.from_numpy(rgb)).numpy(),
                                  np.asarray(jtone.quantize(jnp.asarray(rgb))))
    film_t = tfilm.Film(tl, ts)
    film_j = jfilm.Film(jl, js)
    np.testing.assert_array_equal(film_t.to_uint8(1.3), film_j.to_uint8(1.3))


# ---------------------------------------------------------------------------
# lights
# ---------------------------------------------------------------------------


def _light_sets(hdri: bool):
    tex = _env_tex()
    dirs = np.array([[0.4, 1.0, 0.2], [-0.3, 0.8, 0.5]], np.float32)
    cols = np.array([[1.0, 0.95, 0.8], [0.2, 0.3, 1.0]], np.float32)
    ls = np.array([3.0, 1.5], np.float32)
    if hdri:
        je, te = jlights.make_env_hdri(tex), tlights.make_env_hdri(tex, device="cpu")
    else:
        je = jlights.make_env_color((0.4, 0.5, 0.7), 2.0)
        te = tlights.make_env_color((0.4, 0.5, 0.7), 2.0, device="cpu")
    jl = jlights.LightSet(env=je, directional=jlights.make_directional(dirs, cols, ls),
                          area=jlights.empty_area())
    tl = tlights.LightSet(env=te, directional=tlights.make_directional(dirs, cols, ls, "cpu"),
                          area=tlights.empty_area("cpu"))
    return jlights.with_packed(jl), tlights.with_packed(tl)


@pytest.mark.parametrize("hdri", [True, False])
@pytest.mark.parametrize("env_importance", [True, False])
def test_lights(hdri, env_importance):
    jl, tl = _light_sets(hdri)
    assert tlights.num_lights(tl) == jlights.num_lights(jl) == 3
    r = rng(21)
    l_id = r.integers(0, 3, N).astype(np.int32)
    (ji, ju, jw), (ti, tu, tw) = both(l_id, uniforms(r), unit(r))
    ti = ti.long()
    np.testing.assert_array_equal(tlights.is_delta(tl, ti).numpy(),
                                  np.asarray(jlights.is_delta(jl, ji)))
    wl_t = tlights.sample_dir(tl, ti, tu, env_importance=env_importance)
    wl_j = jlights.sample_dir(jl, ji, ju, env_importance=env_importance)
    assert_close(wl_t, wl_j)
    assert_close(tlights.radiance(tl, ti, tw), jlights.radiance(jl, ji, jw))
    assert_close(tlights.pdf(tl, ti, tw, env_importance=env_importance),
                 jlights.pdf(jl, ji, jw, env_importance=env_importance))
