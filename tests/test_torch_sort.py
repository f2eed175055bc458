"""RenderConfig.sort_rays in the port: `traversal.sort_perm` against the
JAX package's `_sort_perm` (octant bins, dead lanes last, stable; the
TPU's block-local fine re-sort is not ported), the routes that sort
(`dispatch_route`: the traversal reached from accel "auto" or "pallas"),
and sorted against unsorted dispatches and renders, which must be bit-equal:
sorting only permutes the lanes of a dispatch.  On the CPU the traversal
wrapper runs its plain version, so the sorted path is the card's path up to
the kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.ops.pallas.traversal_kernel import _sort_perm
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera as TCam
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from mc_path_tracer_tpu_torch.ops import rng as trng
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, traversal
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)
from tests.test_torch_integrator import CAM
from tests.test_torch_scene import small_scene

pytestmark = pytest.mark.usefixtures("one_thread")

R = 3000


def rays(seed: int, r: int = R):
    """Origins around the 194-triangle scene, directions with exact zeros
    and negative zeros in some components (neither is > 0), and a mask
    with a third of the lanes dead."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-2.0, 2.0, (r, 3)).astype(np.float32) + np.float32([0.0, 1.0, 0.0])
    rd = g.normal(size=(r, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[::7, 0] = 0.0
    rd[3::11, 1] = -0.0
    mask = g.random(r) > 1.0 / 3.0
    return ro, rd, mask


@pytest.fixture(scope="module")
def scene():
    return small_scene(TScene).build(device="cpu")


@pytest.mark.parametrize("masked", [True, False])
def test_sort_perm_equals_jax(masked):
    _, rd, mask = rays(1)
    mask = mask if masked else None
    want, _ = _sort_perm(jnp.asarray(rd), None if mask is None else jnp.asarray(mask))
    before = LAUNCHES["sort"]
    got = traversal.sort_perm(torch.from_numpy(rd),
                              None if mask is None else torch.from_numpy(mask))
    assert LAUNCHES["sort"] - before == 1
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mask is not None:   # dead lanes last, in caller order
        dead = np.flatnonzero(~mask)
        np.testing.assert_array_equal(got.numpy()[R - dead.size:], dead)


@pytest.mark.parametrize("n_tris, device, accel, sort_rays, route", [
    (194, "cpu", "auto", True, "sorted"),
    (194, "cpu", "pallas", True, "sorted"),
    (194, "cpu", "auto", False, "bvh"),
    (194, "cpu", "wide", True, "bvh"),
    (194, "cpu", "bvh", True, "bvh"),
    (194, "cpu", "dense", True, "dense"),
    (194, "cpu", "brute", True, "brute"),
    (2048, "cuda", "auto", True, "dense"),
    (2049, "cuda", "auto", True, "sorted"),
    (100, "cuda", "pallas", True, "sorted"),
    (100, "cuda", "pallas", False, "bvh"),
])
def test_dispatch_route_sorts_where_jax_sorts(n_tris, device, accel, sort_rays, route):
    """The JAX package sorts only on its "pallas" route, which "auto" takes
    above DENSE_ACCEL_MAX_TRIS on its accelerator; its dense, brute, wide
    and bvh dispatches are unsorted."""
    assert tint.dispatch_route(n_tris, torch.device(device), accel, sort_rays) == route


@pytest.mark.parametrize("masked", [True, False])
def test_sorted_closest_is_bit_equal(scene, masked):
    ro, rd, mask = (torch.from_numpy(a) for a in rays(2))
    mask = mask if masked else None
    before = dict(LAUNCHES)
    got = tint._intersect(scene, "sorted", ro, rd, mask)
    assert LAUNCHES["sort"] - before["sort"] == 1 and LAUNCHES["plain"] - before["plain"] == 1
    want = tint._intersect(scene, "bvh", ro, rd, mask)
    assert int(want.hit.sum()) > R // 10
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("bounded", [True, False])
def test_sorted_anyhit_is_bit_equal(scene, bounded):
    ro, rd, mask = (torch.from_numpy(a) for a in rays(3))
    t_max = torch.from_numpy(np.random.default_rng(4).uniform(0.1, 3.0, R).astype(
        np.float32)) if bounded else None
    got = tint._occluded(scene, "sorted", ro, rd, mask, t_max)
    want = tint._occluded(scene, "bvh", ro, rd, mask, t_max)
    assert 0 < int(want.sum()) < int(mask.sum())
    assert torch.equal(got, want)


def test_render_with_and_without_sort_is_bit_equal():
    """A 24x16 render at 2 spp and depth 4 (both samples in one pass): one
    sort per traversal dispatch with sort_rays, none without, the same
    frame bit for bit."""
    sd = small_scene(TScene).build(device="cpu")
    films, sorts = {}, {}
    for sort in (True, False):
        before = dict(LAUNCHES)
        films[sort] = tint.render(sd, TCam(**CAM), 24, 16,
                                  tint.RenderConfig(spp=2, max_depth=4, sort_rays=sort),
                                  key=trng.prng_key(5), device="cpu")
        sorts[sort] = LAUNCHES["sort"] - before["sort"], LAUNCHES["plain"] - before["plain"]
    assert sorts[True] == (1 * 6, 1 * 6) and sorts[False] == (0, 1 * 6)
    assert films[True].ld.abs().sum() > 0
    assert torch.equal(films[True].ld, films[False].ld)
    assert torch.equal(films[True].samples, films[False].samples)
