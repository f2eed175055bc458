"""The port's threefry streams (mc_path_tracer_tpu_torch/ops/rng.py) must be
bit-equal to jax.random under the repo's JAX configuration: every per-pixel
comparison of a port render against the JAX package rests on it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_path_tracer_tpu.ops import rng as jrng
from mc_path_tracer_tpu_torch.ops import rng as trng

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]
MAX_PID = 1920 * 1080


def _bits(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


def test_jax_config_is_the_ported_one():
    """The port reproduces the partitionable threefry2x32 layout."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_bit_equal(seed):
    np.testing.assert_array_equal(
        _bits(trng.prng_key(seed).numpy()), _bits(jax.random.PRNGKey(seed))
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), trng.prng_key(seed)
    for data in [0, 1, 5, 1_000_003, 1_000_007, MAX_PID - 1, 2**32 - 1]:
        np.testing.assert_array_equal(
            _bits(trng.fold_in(tk, data).numpy()),
            _bits(jax.random.fold_in(jk, data)),
        )
    # chained folds, as the integrator derives sample and bounce keys
    jk2 = jax.random.fold_in(jax.random.fold_in(jk, 3), 4)
    tk2 = trng.fold_in(trng.fold_in(tk, 3), 4)
    np.testing.assert_array_equal(_bits(tk2.numpy()), _bits(jk2))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_fold_in_vector_bit_equal(seed):
    pid = np.random.default_rng(seed).integers(0, MAX_PID, 4096).astype(np.int32)
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    tk = trng.fold_in(trng.prng_key(seed), 2)
    ref = jax.vmap(jax.random.fold_in, (None, 0))(jk, jnp.asarray(pid))
    np.testing.assert_array_equal(
        _bits(trng.fold_in(tk, torch.from_numpy(pid)).numpy()), _bits(ref)
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 10])
@pytest.mark.parametrize("form", ["key", "words", "stacked"])
def test_pixel_uniforms_bit_equal(seed, n, form):
    """A [2] key ("key"), the same key as [1, 2] words ("words"), and three
    samples' [3, 2] words over sample-major lanes ("stacked": run j of the
    lanes, its own pixel ids, keyed by words[j]), held to JAX calls laid
    end to end."""
    rng = np.random.default_rng(seed + n)
    pid = np.concatenate([
        [0, 1, MAX_PID - 1],
        rng.integers(0, MAX_PID, 2045),
    ]).astype(np.int32)
    k = 3 if form == "stacked" else 1
    pids = [np.roll(pid, 101 * j) for j in range(k)]
    jks = [jax.random.fold_in(jax.random.PRNGKey(seed), 7 + j) for j in range(k)]
    tk = torch.stack([trng.fold_in(trng.prng_key(seed), 7 + j) for j in range(k)])
    if form == "key":
        tk = tk[0]
    ref = np.concatenate([np.asarray(jrng.pixel_uniforms(jk, jnp.asarray(p), n))
                          for jk, p in zip(jks, pids)])
    out = trng.pixel_uniforms(tk, torch.from_numpy(np.concatenate(pids)), n).numpy()
    assert out.shape == ref.shape == (k * pid.shape[0], n)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    assert (out >= 0.0).all() and (out < 1.0).all()


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_bit_equal(seed):
    jk, tk = jax.random.PRNGKey(seed), trng.prng_key(seed)
    ref = np.asarray(jax.random.uniform(jk, (37,), dtype=jnp.float32))
    np.testing.assert_array_equal(trng.uniform(tk, 37, device="cpu").numpy().view(np.uint32),
                                  ref.view(np.uint32))
