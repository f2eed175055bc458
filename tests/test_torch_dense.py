"""The dense route: its plain version (the traversal's closest_plain /
anyhit_plain, every ray against every triangle) against the TPU dense
kernels run in interpret mode (intersect_dense_pallas,
occluded_dense_pallas, occluded_dense_soa with t_max) on the random scenes
of tests/test_pallas.py; the `auto` routing rule; the CPU routing and the
argument checks of the dense kernel's wrappers.

The CUDA kernel itself runs only on a GPU: chip_smoke.py holds it against
these plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.ops.intersect import TriangleSoA as JTriangleSoA
from mc_path_tracer_tpu.ops.pallas.intersect_kernel import (
    intersect_dense_pallas,
    occluded_dense_pallas,
    occluded_dense_soa,
)
from mc_path_tracer_tpu_torch.models.integrator import (
    DENSE_ACCEL_MAX_TRIS,
    RenderConfig,
    render,
    resolve_accel,
)
from mc_path_tracer_tpu_torch.ops.intersect import pack_rays
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, dense, traversal


def random_geo(n=100, seed=0):
    """tests/test_pallas.py _random_scene: [T, 9] rows (v0, e1, e2)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d1 = rng.normal(scale=0.4, size=(n, 3)).astype(np.float32)
    d2 = rng.normal(scale=0.4, size=(n, 3)).astype(np.float32)
    return np.concatenate([c, d1, d2], axis=1)


def random_rays(n=64, seed=1):
    """tests/test_pallas.py _random_rays."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def jax_tris(geo):
    n = geo.shape[0]
    zeros3, zeros2 = jnp.zeros((n, 3)), jnp.zeros((n, 2))
    g = jnp.asarray(geo)
    return JTriangleSoA(
        v0=g[:, 0:3], e1=g[:, 3:6], e2=g[:, 6:9],
        n0=zeros3, n1=zeros3, n2=zeros3, uv0=zeros2, uv1=zeros2, uv2=zeros2,
        material_id=jnp.zeros(n, jnp.int32), face_normal=zeros3,
    )


def packed(ro, rd, mask=None, t_max=None):
    return pack_rays(torch.from_numpy(ro), torch.from_numpy(rd),
                     None if mask is None else torch.from_numpy(mask),
                     None if t_max is None else torch.from_numpy(t_max))


@pytest.mark.parametrize("n_tris, n_rays, seed", [(100, 64, 0), (300, 256, 5)])
def test_dense_closest_plain_matches_pallas(n_tris, n_rays, seed):
    geo = random_geo(n_tris, seed)
    ro, rd = random_rays(n_rays, seed + 1)
    t_j, id_j, _, _ = intersect_dense_pallas(jnp.asarray(geo).T, jnp.asarray(ro),
                                             jnp.asarray(rd), interpret=True)
    t_p, id_p = dense.dense_closest(packed(ro, rd), torch.from_numpy(geo))
    id_j, t_j = np.asarray(id_j), np.asarray(t_j)
    assert 0 < (id_j >= 0).sum() < n_rays  # backface culling leaves few hits
    np.testing.assert_array_equal(id_p.numpy(), id_j)
    hit = id_j >= 0
    np.testing.assert_allclose(t_p.numpy()[hit], t_j[hit], rtol=1e-6)
    assert (t_p.numpy()[~hit] == 1e32).all()


@pytest.mark.parametrize("n_tris, n_rays, seed", [(77, 96, 3), (300, 256, 7)])
def test_dense_anyhit_plain_matches_pallas(n_tris, n_rays, seed):
    geo = random_geo(n_tris, seed)
    ro, rd = random_rays(n_rays, seed + 1)
    occ_j = np.asarray(occluded_dense_pallas(jnp.asarray(geo).T, jnp.asarray(ro),
                                             jnp.asarray(rd), interpret=True))
    occ_p = dense.dense_anyhit(packed(ro, rd), torch.from_numpy(geo)).numpy()
    assert 0 < occ_j.sum() < n_rays
    np.testing.assert_array_equal(occ_p, occ_j)


def test_dense_bounded_anyhit_matches_occluded_dense_soa():
    """Bounded shadow rays with dead lanes: t <= t_max against the JAX
    route's 'closest t <= t_max', masked."""
    geo = random_geo(200, 11)
    ro, rd = random_rays(300, 12)
    rng = np.random.default_rng(13)
    t_max = rng.uniform(0.2, 4.0, ro.shape[0]).astype(np.float32)
    mask = rng.random(ro.shape[0]) < 0.8
    ref = np.asarray(occluded_dense_soa(
        jax_tris(geo), jnp.asarray(ro), jnp.asarray(rd), mask=jnp.asarray(mask),
        t_max=jnp.asarray(t_max), interpret=True))
    occ = dense.dense_anyhit(packed(ro, rd, mask, t_max), torch.from_numpy(geo)).numpy()
    unbounded = dense.dense_anyhit(packed(ro, rd, mask), torch.from_numpy(geo)).numpy()
    assert 0 < ref.sum() < unbounded.sum()  # the bound matters on this set
    np.testing.assert_array_equal(occ, ref)


def test_dense_wrappers_take_the_plain_route_on_cpu():
    geo = torch.from_numpy(random_geo(50, 2))
    rays = packed(*random_rays(40, 3))
    before = dict(LAUNCHES)
    t, tri_id = dense.dense_closest(rays, geo)
    occ = dense.dense_anyhit(rays, geo)
    assert LAUNCHES["dense_closest"] == before["dense_closest"]
    assert LAUNCHES["dense_anyhit"] == before["dense_anyhit"]
    assert LAUNCHES["plain"] == before["plain"] + 2
    t_p, id_p = traversal.closest_plain(rays, geo)
    np.testing.assert_array_equal(tri_id.numpy(), id_p.numpy())
    np.testing.assert_array_equal(t.numpy(), t_p.numpy())
    np.testing.assert_array_equal(occ.numpy(), traversal.anyhit_plain(rays, geo).numpy())
    assert tri_id.dtype == torch.int32 and occ.dtype == torch.bool


@pytest.mark.parametrize("fn", [dense.dense_closest, dense.dense_anyhit])
@pytest.mark.parametrize("bad", ["float64", "width7", "flat", "geo_width8", "geo_float16"])
def test_dense_wrapper_rejects_bad_arguments(fn, bad):
    rays = packed(*random_rays(16, 4))
    geo = torch.from_numpy(random_geo(10, 4))
    rays, geo = {
        "float64": (rays.double(), geo),
        "width7": (rays[:, :7].contiguous(), geo),
        "flat": (rays.reshape(-1), geo),
        "geo_width8": (rays, geo[:, :8].contiguous()),
        "geo_float16": (rays, geo.half()),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        fn(rays, geo)


@pytest.mark.parametrize("n_tris, device, accel, route", [
    (4, "cuda", "auto", "dense"),
    (DENSE_ACCEL_MAX_TRIS, "cuda", "auto", "dense"),
    (DENSE_ACCEL_MAX_TRIS + 1, "cuda", "auto", "bvh"),
    (48002, "cuda", "auto", "bvh"),
    (4, "cpu", "auto", "bvh"),
    (48002, "cuda", "dense", "dense"),
    (4, "cuda", "brute", "brute"),
    (4, "cpu", "dense", "dense"),
    (4, "cuda", "pallas", "bvh"),
    (4, "cuda", "wide", "bvh"),
    (4, "cpu", "bvh", "bvh"),
])
def test_resolve_accel(n_tris, device, accel, route):
    """auto takes the dense kernel on a CUDA scene of at most
    DENSE_ACCEL_MAX_TRIS triangles, as the JAX package's _resolve_accel does
    on its accelerator (no card needed: the rule is pure)."""
    assert DENSE_ACCEL_MAX_TRIS == 2048
    assert resolve_accel(n_tris, torch.device(device), accel) == route


def test_resolve_accel_rejects_unknown():
    """"pallas", "wide" and "bvh" are routes now (the traversal kernel); a
    name the JAX package does not know is refused."""
    with pytest.raises(ValueError):
        resolve_accel(4, torch.device("cpu"), "octree")


def test_render_dense_route_on_cpu_equals_auto():
    """On CPU tensors accel="dense" and "auto" both reach the plain version,
    so the images are identical."""
    from tests.test_torch_arealight import AREA_CAM, area_scene
    from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera

    imgs = [render(area_scene(), PerspectiveCamera(**AREA_CAM), 8, 8,
                   RenderConfig(spp=1, max_depth=3, accel=a), device="cpu").ld.numpy()
            for a in ("auto", "dense")]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0].mean() > 0.0
