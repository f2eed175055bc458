"""Progressive rendering in the port against the JAX package: the tile
schedule, render_progressive's films (pass p keyed by fold_in(key, p)), the
RenderSession restart on scene edits, the engine's modes, and film
checkpoints written by one package and read by the other."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.models import film as jfilm
from mc_path_tracer_tpu.models import integrator as jint
from mc_path_tracer_tpu.models.camera import PerspectiveCamera as JCam
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu.utils import checkpoint as jckpt
from mc_path_tracer_tpu_torch.models import engine
from mc_path_tracer_tpu_torch.models import film as tfilm
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera as TCam
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from mc_path_tracer_tpu_torch.ops import rng as trng
from mc_path_tracer_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)
from tests.test_torch_integrator import CAM, assert_images_agree
from tests.test_torch_scene import small_scene

W, H, TILE = 8, 8, 4


@pytest.mark.parametrize("size", [(100, 60, 32), (8, 8, 4), (384, 128, 128), (5, 3, 256)])
def test_tile_grid_equals_jax(size):
    assert list(tfilm.tile_grid(*size)) == list(jfilm.tile_grid(*size))
    film = tfilm.make_film(size[0], size[1], device="cpu")
    assert tuple(film.ld.shape) == (size[1], size[0], 3) and float(film.samples.sum()) == 0.0


def test_render_progressive_matches_jax(one_thread):
    """8x8 in 4x4 tiles, 2 passes of 1 spp at depth 2: every film the two
    generators yield agrees."""
    cfg = dict(spp=2, max_depth=2)
    ref = list(jint.render_progressive(small_scene(JScene), JCam(**CAM), W, H,
                                       jint.RenderConfig(accel="brute", **cfg),
                                       key=jax.random.PRNGKey(5), tile=TILE))
    out = list(tint.render_progressive(small_scene(TScene), TCam(**CAM), W, H,
                                       tint.RenderConfig(**cfg), key=trng.prng_key(5),
                                       tile=TILE, device="cpu"))
    assert len(out) == len(ref) == 2 * 4
    for o, r in zip(out, ref):
        assert_images_agree(o, r, (H, W))
    assert float(out[-1].samples.min()) == 2.0


def test_render_progressive_adds_up_to_render(one_thread):
    """The final film equals the sum of 1-spp renders keyed fold_in(key, p),
    bit for bit; each step returns a new film."""
    scene, cam = small_scene(TScene), TCam(**CAM)
    cfg = tint.RenderConfig(spp=2, max_depth=3)
    key = trng.prng_key(9)
    films = list(tint.render_progressive(scene, cam, W, H, cfg, key=key, tile=TILE,
                                         device="cpu"))
    assert float(films[0].samples.sum()) == TILE * TILE  # one tile sampled
    ref = torch.zeros((H, W, 3))
    for p in range(cfg.spp):
        ref = ref + tint.render(scene, cam, W, H, tint.RenderConfig(spp=1, max_depth=3),
                                key=trng.fold_in(key, p), device="cpu").ld
    torch.testing.assert_close(films[-1].ld, ref, rtol=0, atol=0)


def test_render_session_restarts_on_edit():
    s = small_scene(TScene)
    ses = engine.RenderSession(scene=s, camera=TCam(**CAM), width=W, height=H,
                               cfg=tint.RenderConfig(spp=4, max_depth=2), tile=W,
                               spp_per_pass=2, device="cpu")
    assert float(ses.step().samples.max()) == 2
    assert float(ses.step().samples.max()) == 4
    assert float(ses.step().samples.max()) == 4   # converged: the final film again
    s.set_transform(1, translation=(0.0, 0.2, 0.0))
    assert float(ses.step().samples.max()) == 2
    s.add_directional_light((1, 1, 0), ls=1.0)
    assert float(ses.step().samples.max()) == 2


def test_engine_modes():
    eng = engine.RenderEngine()
    film = eng.render(small_scene(TScene), TCam(**CAM), 4, 4, engine.MODE_PATH_TRACER,
                      tint.RenderConfig(spp=1, max_depth=2), device="cpu")
    assert tuple(film.ld.shape) == (4, 4, 3)
    for mode in (engine.MODE_RASTERIZER, engine.MODE_WIREFRAME, engine.MODE_DEBUG):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            eng.render(small_scene(TScene), TCam(**CAM), 4, 4, mode, device="cpu")
    with pytest.raises(ValueError, match="unknown render mode"):
        eng.render(small_scene(TScene), TCam(**CAM), 4, 4, "sketch", device="cpu")


def _film_values():
    r = np.random.default_rng(3)
    return r.random((3, 5, 3)).astype(np.float32), np.full((3, 5), 7.0, np.float32)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_film_checkpoint_crosses_packages(writer, tmp_path):
    ld, samples = _film_values()
    path = os.path.join(tmp_path, "film.npz")
    meta = {"spp": 7, "scene": "small"}
    if writer == "jax":
        jckpt.save_film(path, jfilm.Film(ld=jnp.asarray(ld), samples=jnp.asarray(samples)), meta)
        film, got = tckpt.load_film(path, device="cpu")
        a, b = film.ld.numpy(), film.samples.numpy()
    else:
        tckpt.save_film(path, tfilm.Film(ld=torch.from_numpy(ld), samples=torch.from_numpy(samples)),
                        meta)
        film, got = jckpt.load_film(path)
        a, b = np.asarray(film.ld), np.asarray(film.samples)
    np.testing.assert_array_equal(a, ld)
    np.testing.assert_array_equal(b, samples)
    assert got == meta
