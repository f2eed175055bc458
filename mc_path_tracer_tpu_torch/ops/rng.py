"""Counter-based random streams: threefry2x32 in torch integer ops, bit for
bit the streams of mc_path_tracer_tpu/ops/rng.py under JAX's default
configuration (threefry2x32 with `jax_threefry_partitionable` on).

torch has no usable uint32 arithmetic, so 32-bit words live in int64 and
every add and shift is masked with `& 0xFFFFFFFF`; right shifts of these
non-negative values are logical.  The same code runs on Python ints (scalar
key derivation on the host, no device round trip) and on int64 tensors of
any device (per-lane streams), so a render on the card draws the same
numbers as the JAX reference.

A key is a [2] int64 tensor holding two uint32 words (JAX's raw key);
`prng_key(s)` is `[0, s]`, like `jax.random.PRNGKey(s)`.  Keys are derived
on the host (`fold_in` of a [2] key by an int, on Python ints) and sent to
the device once, as [k, 2] words; `pixel_uniforms` reads those words there,
the threefry being elementwise, so k samples' words broadcast against
their runs of sample-major lanes.
"""

from __future__ import annotations

import torch

from mc_path_tracer_tpu_torch.device import DEFAULT_DEVICE, resolve_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters (x1, x2) under key
    (k1, k2): JAX's `_threefry2x32_lowering`, on ints or int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: the words [0, seed]."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def _words(key: torch.Tensor):
    """A key's two words: Python ints of a [2] host key, or the [..., 2]
    words of keys on a device as two [...] tensors."""
    if key.dim() > 1:
        return key[..., 0], key[..., 1]
    k1, k2 = key.tolist()
    return int(k1), int(k2)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: hash the counter pair (0, data) under key.

    `key` is a [2] key or [..., 2] key words, which broadcast against
    `data`.  `data` is an int (returns a [2] key of a [2] key) or an integer
    tensor (returns one key per element, [*broadcast shape, 2], on data's
    device)."""
    k1, k2 = _words(key)
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    y1, y2 = threefry2x32(k1, k2, 0, data)
    if isinstance(y1, torch.Tensor):
        return torch.stack([y1, y2], dim=-1)
    return torch.tensor([y1, y2], dtype=torch.int64)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): 23 mantissa bits under exponent 0,
    minus 1 (`jax.random.uniform`'s float construction)."""
    mant = (bits >> 9) | 0x3F800000   # < 2**31, exact in int32
    return mant.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, n: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """`jax.random.uniform(key, (n,))` in f32."""
    k1, k2 = _words(key)
    lo = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return _bits_to_unit(b1 ^ b2)


def uniforms(key: torch.Tensor, shape, n: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """`n` independent uniform [0, 1) variates per ray, [*shape, n] f32:
    `jax.random.uniform(key, (*shape, n))`, whose partitionable threefry
    counts the flat index over the whole shape."""
    shape = (*shape, n)
    return uniform(key, int(torch.Size(shape).numel()), device).reshape(shape)


def pixel_uniforms(key: torch.Tensor, pid: torch.Tensor, n: int) -> torch.Tensor:
    """Per-pixel uniform streams: `n` variates per lane keyed by the lane's
    pixel id, so a pixel's noise does not depend on how the frame is cut
    into blocks.  `key` holds k samples' key words, [k, 2] (a [2] key is k
    = 1), over sample-major lanes: pid's N lanes are k runs of N / k, run j
    keyed by key[j].  Words not on pid's device are copied there.  Shape
    [*pid.shape, n], on pid's device."""
    words = key.view(-1, 2).to(pid.device)
    k = words.shape[0]
    keys = fold_in(words[:, None], pid.view(k, pid.numel() // k)).view(*pid.shape, 2)
    lo = torch.arange(n, dtype=torch.int64, device=pid.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(lo), lo)
    return _bits_to_unit(b1 ^ b2)
