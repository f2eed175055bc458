"""Counter-based random streams: threefry2x32 (20 rounds) in torch integer
ops, JAX's raw-key conventions (a key is a [2] int64 tensor of two uint32
words; prng_key(s) = [0, s]).  A frozen copy of the arithmetic the port's
ops/rng.py implements, so that the reference draws each pixel's numbers
itself; 32-bit words live in int64 and every add and shift is masked."""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of counters (x1, x2) under key (k1, k2), on Python
    ints or int64 tensors."""
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
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data):
    """jax.random.fold_in: hash (0, data) under key; `data` an int (one
    [2] key) or an integer tensor (a key per element)."""
    k1, k2 = (int(w) for w in key.tolist())
    if isinstance(data, torch.Tensor):
        y1, y2 = threefry2x32(k1, k2, 0, data.to(torch.int64) & MASK)
        return torch.stack([y1, y2], dim=-1)
    y1, y2 = threefry2x32(k1, k2, 0, int(data) & MASK)
    return torch.tensor([y1, y2], dtype=torch.int64)


def seed_key(seed: int) -> torch.Tensor:
    """A run's base key from its --seed, whatever its size: the low 32
    bits make the key, the rest is folded in."""
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return fold_in(prng_key(seed & MASK), seed >> 32)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def pixel_uniforms(key: torch.Tensor, pid: torch.Tensor, n: int) -> torch.Tensor:
    """`n` uniforms in [0, 1) per lane, keyed by the lane's pixel id."""
    keys = fold_in(key, pid)
    lo = torch.arange(n, dtype=torch.int64, device=pid.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(lo), lo)
    return _bits_to_unit(b1 ^ b2)
