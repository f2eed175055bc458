"""The tone-map kernel's plain version (quantize(reinhard(...))) against the
TPU display kernel run in interpret mode (tonemap_pallas), bit for bit, on
tests/test_pallas.py's inputs and on edge values; the wrapper's CPU route
and argument checks; Film.to_uint8 / save_png through the wrapper.

The CUDA kernel itself runs only on a GPU: chip_smoke.py holds it against
this plain version on the card, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.ops.pallas.tonemap_kernel import tonemap_pallas
from mc_path_tracer_tpu_torch.models.film import Film
from mc_path_tracer_tpu_torch.ops.kernels import LAUNCHES, tonemap


def _both(ld, samples, exposure):
    want = np.asarray(tonemap_pallas(jnp.asarray(ld), jnp.asarray(samples), exposure,
                                     interpret=True))
    got = tonemap.tonemap(torch.from_numpy(ld), torch.from_numpy(samples), exposure)
    return got, want


def test_tonemap_plain_matches_pallas():
    """tests/test_pallas.py's inputs: 13x37, exposure 1.7."""
    rng = np.random.default_rng(0)
    ld = rng.uniform(0, 10, size=(13, 37, 3)).astype(np.float32)
    samples = rng.integers(1, 9, size=(13, 37)).astype(np.float32)
    got, want = _both(ld, samples, 1.7)
    assert got.dtype == torch.uint8 and got.shape == (13, 37, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("exposure", [1.0, 0.37, 12.5])
def test_tonemap_plain_matches_pallas_on_edges(exposure):
    """Zero radiance, 1e30, zero sample counts (clamped to 1), values on
    every 8-bit boundary after the Reinhard curve, and random radiance at
    varied counts."""
    rng = np.random.default_rng(1)
    # c = k / (255 - k) lands c / (c + 1) on k / 255, where truncation is
    # decided by the last bit
    k = np.arange(256, dtype=np.float64)
    boundary = np.where(k < 255, k / np.maximum(255 - k, 1), 1e6).astype(np.float32)
    flat = np.concatenate([
        [0.0, 1e30, 1e-30, 3.0, 254.0],
        boundary / np.float32(exposure),
        rng.uniform(0, 50, 256 * 3 - 261).astype(np.float32),
    ]).astype(np.float32)
    ld = flat.reshape(16, 16, 3)
    samples = rng.integers(0, 5, size=(16, 16)).astype(np.float32)
    samples[0, :4] = 0.0
    got, want = _both(ld, samples, exposure)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy()[0, 0].tolist() == [0, 255, 0]


def test_tonemap_wrapper_takes_the_plain_route_on_cpu():
    ld = torch.rand(4, 5, 3) * 4
    samples = torch.full((4, 5), 2.0)
    before = dict(LAUNCHES)
    out = tonemap.tonemap(ld, samples, 1.3)
    assert LAUNCHES["tonemap"] == before["tonemap"]
    assert LAUNCHES["plain"] == before["plain"] + 1
    np.testing.assert_array_equal(out.numpy(), tonemap.tonemap_plain(ld, samples, 1.3).numpy())


@pytest.mark.parametrize("bad", ["float64", "ld_width4", "samples_shape", "noncontiguous"])
def test_tonemap_wrapper_rejects_bad_arguments(bad):
    ld, samples = torch.rand(4, 5, 3), torch.ones(4, 5)
    ld, samples = {
        "float64": (ld.double(), samples),
        "ld_width4": (torch.rand(4, 5, 4), samples),
        "samples_shape": (ld, torch.ones(5, 4)),
        "noncontiguous": (ld.transpose(0, 1), samples.T),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        tonemap.tonemap(ld, samples)


def test_film_png_goes_through_the_wrapper(tmp_path):
    """Film.save_png writes the wrapper's bytes as an 8-bit RGB PNG."""
    from PIL import Image

    rng = np.random.default_rng(2)
    film = Film(ld=torch.from_numpy(rng.uniform(0, 6, (6, 9, 3)).astype(np.float32)),
                samples=torch.full((6, 9), 3.0))
    path = tmp_path / "frame.png"
    film.save_png(str(path), exposure=0.8)
    img = np.asarray(Image.open(path))
    assert img.dtype == np.uint8 and img.shape == (6, 9, 3)
    np.testing.assert_array_equal(img, film.to_uint8(0.8))
    np.testing.assert_array_equal(img, tonemap.tonemap(film.ld, film.samples, 0.8).numpy())
