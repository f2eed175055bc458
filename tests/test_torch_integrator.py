"""The slice as a whole: the port's render() against the JAX render() of the
same scene, camera and key, pixel by pixel.

The JAX side runs accel="brute" (its BVH routes take several times longer
to compile on the CPU and give the same image); the port runs accel="auto",
which on CPU tensors is the traversal's plain version.  Both draw the same
threefry streams, so the images agree to f32 rounding: per pixel rtol 1e-4
/ atol 1e-5 on at least 99% of pixels (rounding differences are amplified
along glossy paths), frame mean within 1e-4 relative."""

import jax
import numpy as np
import pytest

from mc_path_tracer_tpu.models import integrator as jint
from mc_path_tracer_tpu.models.camera import PerspectiveCamera as JCam
from mc_path_tracer_tpu.models.scene import Scene as JScene
from mc_path_tracer_tpu_torch.models import integrator as tint
from mc_path_tracer_tpu_torch.models.camera import PerspectiveCamera as TCam
from mc_path_tracer_tpu_torch.models.scene import Scene as TScene
from mc_path_tracer_tpu_torch.ops import rng as trng
from mc_path_tracer_tpu_torch.ops.kernels import traversal
from tests.test_torch_arealight import one_thread  # noqa: F401  (fixture)
from tests.test_torch_scene import small_scene

W, H, SPP, DEPTH, SEED = 24, 16, 2, 5, 3
CAM = dict(position=np.array([0.5, 2.5, 4.0]), target=np.array([0.0, 0.6, 0.0]),
           fov_deg=45.0)


def render_both(spp=SPP, depth=DEPTH, **cfg):
    ref = jint.render(small_scene(JScene), JCam(**CAM), W, H,
                      jint.RenderConfig(spp=spp, max_depth=depth, accel="brute", **cfg),
                      key=jax.random.PRNGKey(SEED))
    out = tint.render(small_scene(TScene), TCam(**CAM), W, H,
                      tint.RenderConfig(spp=spp, max_depth=depth, **cfg),
                      key=trng.prng_key(SEED), device="cpu")
    return out, ref


def assert_images_agree(out, ref, size=(H, W), share=0.99):
    a, b = out.ld.numpy(), np.asarray(ref.ld)
    assert a.shape == b.shape == (*size, 3)
    assert np.isfinite(a).all()
    close = np.isclose(a, b, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= share, (close.mean(), np.abs(a - b).max())
    assert abs(a.mean() - b.mean()) <= 1e-4 * abs(b.mean())
    np.testing.assert_array_equal(out.samples.numpy(), np.asarray(ref.samples))


@pytest.fixture(scope="module")
def default_render():
    before = dict(traversal.LAUNCHES)
    out, ref = render_both()
    return out, ref, before, dict(traversal.LAUNCHES)


def test_render_matches_jax(default_render):
    out, ref, _, _ = default_render
    assert_images_agree(out, ref)
    assert out.ld.numpy().mean() > 0.0


def test_render_on_cpu_takes_the_plain_route(default_render):
    *_, before, after = default_render
    assert after["closest"] == before["closest"] and after["anyhit"] == before["anyhit"]
    # one closest-hit per bounce after the primary, one fused any-hit per NEE
    # bounce: (1 + (DEPTH - 2) + (DEPTH - 1)) dispatches per pass, and the
    # SPP samples of the frame's one block run in one pass
    assert after["plain"] - before["plain"] == 1 * (2 * DEPTH - 2)


def test_render_reference_quirks_matches_jax():
    """1 spp at depth 3 keeps the JAX compile short (the JAX render unrolls
    samples and bounces); rr_start=1 puts Russian roulette before the last
    bounce, so the survivor reweight that the quirk mode drops shows in the
    image."""
    out, ref = render_both(spp=1, depth=3, rr_start=1, reference_quirks=True)
    assert_images_agree(out, ref)


@pytest.mark.parametrize("cfg", [
    dict(reuse_brdf_ray=True), dict(accel="pallas"), dict(accel="wide"),
])
def test_unported_options_are_refused(cfg, default_render, one_thread):
    """The options the first slices refused now render, each against the
    JAX accel="brute" image.  reuse_brdf_ray runs at 1 spp and depth 3 with
    rr_start=1, so Russian roulette acts before the shared trace of the
    first bounce and the last bounce takes the dedicated visibility lanes;
    "pallas" and "wide" are routes (the traversal's plain version on the
    CPU) and must give the default render's image."""
    if cfg.get("reuse_brdf_ray"):
        out, ref = render_both(spp=1, depth=3, rr_start=1, **cfg)
    else:
        _, ref, _, _ = default_render
        before = dict(traversal.LAUNCHES)
        out = tint.render(small_scene(TScene), TCam(**CAM), W, H,
                          tint.RenderConfig(spp=SPP, max_depth=DEPTH, **cfg),
                          key=trng.prng_key(SEED), device="cpu")
        assert traversal.LAUNCHES["plain"] - before["plain"] == 1 * (2 * DEPTH - 2)
    assert_images_agree(out, ref)
