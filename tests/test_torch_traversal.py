"""The traversal's plain versions against the JAX brute-force oracle
(intersect_brute / occluded_brute, the oracle of the Pallas kernels' own
tests), the port's hit record against the JAX one, the CPU routing of the
kernel wrappers, their argument checks, and the nvcc command line.

The CUDA kernel itself runs only on a GPU: chip_smoke.py holds it against
these plain versions on the card."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.ops import bvh as jbvh
from mc_path_tracer_tpu.ops import intersect as jisect
from mc_path_tracer_tpu_torch.ops import bvh as tbvh
from mc_path_tracer_tpu_torch.ops import intersect as tisect
from mc_path_tracer_tpu_torch.ops.kernels import build, traversal

REPO = Path(__file__).resolve().parents[1]


def random_tri_arrays(n=500, seed=7) -> dict:
    """Host triangle arrays in the style of tests/test_intersect.random_scene,
    with per-vertex normals, uvs and xyzw tangents so the 28-wide shading
    rows and the tangent frame are exercised."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    v1 = c + rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    v2 = c + rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    e1, e2 = v1 - c, v2 - c
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)

    def unit():
        v = fn + rng.normal(scale=0.2, size=(n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    def tangent():
        t = rng.normal(size=(n, 3))
        t /= np.linalg.norm(t, axis=-1, keepdims=True)
        w = np.where(rng.random((n, 1)) < 0.5, -1.0, 1.0)
        return np.concatenate([t, w], axis=1).astype(np.float32)

    return {
        "v0": c, "e1": e1, "e2": e2,
        "n0": unit(), "n1": unit(), "n2": unit(),
        "uv0": rng.random((n, 2)).astype(np.float32),
        "uv1": rng.random((n, 2)).astype(np.float32),
        "uv2": rng.random((n, 2)).astype(np.float32),
        "material_id": (np.arange(n) % 5).astype(np.int32),
        "face_normal": fn.astype(np.float32),
        "tan0": tangent(), "tan1": tangent(), "tan2": tangent(),
    }


def random_rays(n=600, seed=8):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    mask = rng.random(n) < 0.8
    t_max = np.where(rng.random(n) < 0.5, rng.uniform(0.5, 4.0, n), 1e32).astype(np.float32)
    return ro, rd, mask, t_max


@pytest.fixture(scope="module")
def scene():
    """The same triangles built by both packages: JAX-reordered TriangleSoA
    (the oracle's ids are then leaf-order ids, as the port's) and the port's
    BVH + leaf-order tensors."""
    arrays = random_tri_arrays()
    jb, jtris = jbvh.build_bvh(
        jisect.TriangleSoA(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        max_leaf=4,
    )
    tb, ttris, _ = tbvh.build_bvh(arrays, max_leaf=4, device="cpu")
    return (jb, jtris), tb, ttris


def test_port_bvh_equals_jax_bvh(scene):
    (jb, jtris), tb, ttris = scene
    np.testing.assert_array_equal(tb.packed.numpy(), np.asarray(jb.packed))
    np.testing.assert_array_equal(ttris.attrs.numpy(), np.asarray(jtris.attrs))
    np.testing.assert_array_equal(
        ttris.geo.numpy(),
        np.concatenate([np.asarray(jtris.v0), np.asarray(jtris.e1), np.asarray(jtris.e2)], 1),
    )


def test_closest_plain_matches_intersect_brute(scene):
    (_, jtris), _, ttris = scene
    ro, rd, mask, _ = random_rays()
    ref = jisect.intersect_brute(jtris, jnp.asarray(ro), jnp.asarray(rd))
    rays = tisect.pack_rays(torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(mask))
    t, tri_id = traversal.closest_plain(rays, ttris.geo)
    hit, ref_hit = tri_id.numpy() >= 0, np.asarray(ref.hit)
    assert ref_hit[mask].sum() > 50
    np.testing.assert_array_equal(hit, ref_hit & mask)
    np.testing.assert_array_equal(tri_id.numpy()[hit], np.asarray(ref.tri_id)[hit])
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    assert (t.numpy()[~hit] == 1e32).all()


def test_anyhit_plain_matches_occluded_brute(scene):
    (_, jtris), _, ttris = scene
    ro, rd, mask, t_max = random_rays(seed=9)
    ref = np.asarray(jisect.occluded_brute(jtris, jnp.asarray(ro), jnp.asarray(rd),
                                           t_max=jnp.asarray(t_max))) & mask
    rays = tisect.pack_rays(*(torch.from_numpy(a) for a in (ro, rd, mask, t_max)))
    occ = traversal.anyhit_plain(rays, ttris.geo).numpy()
    assert 0 < ref.sum() < mask.sum()
    np.testing.assert_array_equal(occ, ref)


def test_hit_record_matches_jax(scene):
    """winner_uvt + miss sanitizing + _shade_attrs against the JAX brute
    hit record, on the lanes that hit."""
    (_, jtris), _, ttris = scene
    ro, rd, _, _ = random_rays(seed=10)
    ref = jisect.intersect_brute(jtris, jnp.asarray(ro), jnp.asarray(rd))
    tro, trd = torch.from_numpy(ro), torch.from_numpy(rd)
    _, tri_id = traversal.closest_plain(tisect.pack_rays(tro, trd), ttris.geo)
    h = tisect.finish_closest(ttris, tri_id, tro, trd)
    m = np.asarray(ref.hit)
    np.testing.assert_array_equal(h.hit.numpy(), m)
    np.testing.assert_array_equal(h.material_id.numpy()[m], np.asarray(ref.material_id)[m])
    for name in ("t", "position", "normal", "uv", "tangent", "bitangent"):
        np.testing.assert_allclose(getattr(h, name).numpy()[m],
                                   np.asarray(getattr(ref, name))[m], atol=1e-5,
                                   err_msg=name)
    # misses stay finite: u = v = 0, t = K_HUGE
    assert (h.t.numpy()[~m] == 1e32).all()
    for name in ("normal", "uv", "tangent", "bitangent"):
        assert np.isfinite(getattr(h, name).numpy()).all(), name


def test_cpu_wrappers_take_the_plain_route(scene):
    _, tb, ttris = scene
    ro, rd, mask, t_max = random_rays(seed=11)
    rays = tisect.pack_rays(*(torch.from_numpy(a) for a in (ro, rd, mask, t_max)))
    before = dict(traversal.LAUNCHES)
    t, tri_id = traversal.trace_closest(rays, tb, ttris.geo)
    occ = traversal.trace_anyhit(rays, tb, ttris.geo)
    assert traversal.LAUNCHES["closest"] == before["closest"]
    assert traversal.LAUNCHES["anyhit"] == before["anyhit"]
    assert traversal.LAUNCHES["plain"] == before["plain"] + 2
    t_p, id_p = traversal.closest_plain(rays, ttris.geo)
    np.testing.assert_array_equal(tri_id.numpy(), id_p.numpy())
    np.testing.assert_array_equal(t.numpy(), t_p.numpy())
    np.testing.assert_array_equal(occ.numpy(), traversal.anyhit_plain(rays, ttris.geo).numpy())
    assert tri_id.dtype == torch.int32 and occ.dtype == torch.bool


def test_plain_chunking_is_exact(scene, monkeypatch):
    """Ray chunks of the plain versions give the unchunked answer."""
    _, _, ttris = scene
    ro, rd, mask, t_max = random_rays(seed=12)
    rays = tisect.pack_rays(*(torch.from_numpy(a) for a in (ro, rd, mask, t_max)))
    whole = traversal.closest_plain(rays, ttris.geo), traversal.anyhit_plain(rays, ttris.geo)
    monkeypatch.setattr(traversal, "PLAIN_PAIRS", 7 * ttris.num_triangles)
    chunked = traversal.closest_plain(rays, ttris.geo), traversal.anyhit_plain(rays, ttris.geo)
    for a, b in zip((*whole[0], whole[1]), (*chunked[0], chunked[1])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("fn", [traversal.trace_closest, traversal.trace_anyhit])
@pytest.mark.parametrize("bad", ["noncontiguous", "float64", "width7", "flat"])
def test_wrapper_rejects_bad_rays(scene, fn, bad):
    _, tb, ttris = scene
    rays = tisect.pack_rays(*(torch.from_numpy(a) for a in random_rays(n=16)[:2]))
    rays = {
        "noncontiguous": rays.T.contiguous().T,
        "float64": rays.double(),
        "width7": rays[:, :7].contiguous(),
        "flat": rays.reshape(-1),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        fn(rays, tb, ttris.geo)


@pytest.mark.parametrize("name", ["traversal", "dense", "tonemap"])
def test_nvcc_command_line(name):
    """Each kernel builds for sm_90a with --fmad=false into the gitignored
    build directory; checked as a list, without running nvcc."""
    src = build.CSRC_DIR / f"{name}.cu"
    out = build.library_path(src)
    cmd = build.nvcc_command(src, out)
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--fmad=false" in cmd and "-shared" in cmd
    assert cmd[cmd.index("-o") + 1] == str(out) and cmd[-1] == str(src)
    assert out.parent == build.BUILD_DIR == REPO / "build" / "kernels"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    # a changed source builds under another name
    assert out.name.startswith(f"lib{name}_") and out.suffix == ".so"
