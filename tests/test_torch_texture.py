"""Textures in the port against the JAX package: atlas packing and bilinear
wrap sampling, the textured material lookups, and a textured glTF scene
rendered by both packages.

Inputs are made from a seed with numpy; sampling and the material lookups
agree to rtol 1e-6 (the two packages' float32 arithmetic differs in the last
bits); the render takes test_torch_integrator's tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mc_path_tracer_tpu.models import integrator as jint
from mc_path_tracer_tpu.models import materials as jmat
from mc_path_tracer_tpu.models.camera import PerspectiveCamera as JCam
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu.utils import texture as jtex
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models import materials as tmat
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera as TCam
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from mc_path_tracer_tpu_torch.ops import rng as trng
from mc_path_tracer_tpu_torch.utils import texture as ttex
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)
from tests.test_torch_integrator import assert_images_agree

N = 4096
SIZES = ((4, 4), (8, 2), (3, 7), (16, 16), (1, 5))


def atlases(seed):
    r = np.random.default_rng(seed)
    images = [r.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32) for h, w in SIZES]
    return jtex.build_atlas(images), ttex.build_atlas(images, device="cpu"), r


def lanes(r, n_tex):
    """Texture ids from -2 to n_tex - 1 and UVs from -3 to 4."""
    tid = r.integers(-2, n_tex, N).astype(np.int32)
    uv = r.uniform(-3.0, 4.0, (N, 2)).astype(np.float32)
    return tid, uv


def assert_close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_build_atlas_equals_jax():
    ja, ta, _ = atlases(0)
    assert ta.count == ja.count == len(SIZES)
    np.testing.assert_array_equal(ta.data.numpy(), np.asarray(ja.data))
    np.testing.assert_array_equal(ta.sizes.numpy(), np.asarray(ja.sizes))
    empty = ttex.empty_atlas("cpu")
    assert empty.count == 0 and tuple(empty.data.shape) == (0, 1, 1, 3)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sample_atlas_matches_jax(seed):
    ja, ta, r = atlases(seed)
    tid, uv = lanes(r, len(SIZES))
    got = ttex.sample_atlas(ta, torch.from_numpy(tid), torch.from_numpy(uv))
    assert_close(got, jtex.sample_atlas(ja, jnp.asarray(tid), jnp.asarray(uv)))
    np.testing.assert_array_equal(got[torch.from_numpy(tid) < 0].numpy(), 1.0)


def test_empty_atlas_is_neutral_without_a_gather():
    uv = torch.rand(7, 2)
    got = ttex.sample_atlas(ttex.empty_atlas("cpu"), torch.zeros(7, dtype=torch.int32), uv)
    np.testing.assert_array_equal(got.numpy(), 1.0)


def tables(r, m=6):
    """Both packages' material tables with texture ids (some -1) into an
    atlas of len(SIZES) textures."""
    args = (r.random((m, 3)), r.uniform(0.05, 1.0, m), r.random(m),
            r.uniform(0.02, 0.9, (m, 3)), r.random((m, 3)) * 4)
    tex = {f: r.integers(-1, len(SIZES), m).astype(np.int32) for f in tmat.TEXTURE_FIELDS}
    return (jmat.make_material_table(*args, **tex),
            tmat.make_material_table(*args, device="cpu", **tex))


def unit(r, n=N):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("seed", [4, 5])
def test_textured_materials_match_jax(seed):
    ja, ta, r = atlases(seed)
    jt, tt = tables(r)
    mid = r.integers(0, tt.num_materials, N).astype(np.int32)
    _, uv = lanes(r, len(SIZES))
    n, tan, bit = unit(r), unit(r), unit(r)
    jm, juv = jnp.asarray(mid), jnp.asarray(uv)
    tm, tuv = torch.from_numpy(mid).long(), torch.from_numpy(uv)
    for a, b in zip(tt.gather(tm, tuv, ta), jt.gather(jm, juv, ja)):
        assert_close(a, b)
    assert_close(tt.emission(tm, tuv, ta), jt.emission(jm, juv, ja))
    assert_close(tt.ambient_occlusion(tm, tuv, ta), jt.ambient_occlusion(jm, juv, ja))
    got = tt.perturb_normal(tm, tuv, ta, *(torch.from_numpy(v) for v in (n, tan, bit)))
    want = jt.perturb_normal(jm, juv, ja, *(jnp.asarray(v) for v in (n, tan, bit)))
    assert_close(got, want)
    # untextured slots keep the factor, the normal and AO = 1
    plain = (tt.normal_tex[tm] < 0).numpy()
    np.testing.assert_array_equal(got.numpy()[plain], n[plain])


def test_untextured_paths_skip_the_atlas():
    _, ta, r = atlases(6)
    _, tt = tables(r)
    mid = torch.from_numpy(r.integers(0, tt.num_materials, 16)).long()
    uv = torch.rand(16, 2)
    n = torch.from_numpy(unit(r, 16))
    empty = ttex.empty_atlas("cpu")
    for atlas in (None, empty):
        np.testing.assert_array_equal(tt.perturb_normal(mid, uv, atlas, n, n, n).numpy(),
                                      n.numpy())
        np.testing.assert_array_equal(tt.ambient_occlusion(mid, uv, atlas).numpy(), 1.0)
        np.testing.assert_array_equal(tt.gather(mid, uv, atlas).albedo.numpy(),
                                      tt.albedo[mid].numpy())
    np.testing.assert_array_equal(tt.emission(mid).numpy(), tt.emissive[mid].numpy())


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    return chip_smoke.write_textured_glb(tmp_path_factory.mktemp("glb") / "textured.glb")


def test_textured_gltf_render_matches_jax(glb, one_thread):
    """The glTF test scene (textures in every slot, an emissive textured
    lamp, a moved object), 16x16 at 1 spp and depth 2, by both packages:
    textured primary emission, material lookups and normal maps at the
    first hit."""
    w = h = 16
    ref = jint.render(chip_smoke.textured_scene(JScene, glb), chip_smoke.textured_camera(JCam),
                      w, h, jint.RenderConfig(spp=1, max_depth=2, accel="brute"),
                      key=jax.random.PRNGKey(11))
    out = tint.render(chip_smoke.textured_scene(TScene, glb), chip_smoke.textured_camera(TCam),
                      w, h, tint.RenderConfig(spp=1, max_depth=2), key=trng.prng_key(11),
                      device="cpu")
    assert_images_agree(out, ref, (h, w))
    assert out.ld.numpy().mean() > 0.0
