"""The Threefry-2x32 counter-based PRNG, bit for bit as `jax.random` draws it.

`ops.denoise.deband` picks its sample offsets and its per-pixel selection
from `jax.random` in the JAX package, so the port reproduces that stream:
the same keys give the same bits on the CPU and on the card. Keys are
(k1, k2) pairs of uint32 values, held as int64 tensors of shape [..., 2]
with every value in [0, 2^32); every operation masks back to 32 bits.

What is reproduced (JAX's default `threefry2x32` implementation with
`jax_threefry_partitionable` on, the default since JAX 0.5):

- `threefry2x32(k1, k2, x1, x2)`: 20 rounds, key injection every 4;
- `prng_key(seed)`: a uint32 seed becomes the key (0, seed);
- `fold_in(key, d)`: threefry2x32(key, (0, d));
- `split(key, n)`: key i is threefry2x32(key, (0, i));
- `random_bits(key, shape)`: 32-bit words; element i (row-major) is
  y1 ^ y2 of threefry2x32(key, (i >> 32, i & 0xffffffff));
- `randint(key, shape, lo, hi)`: int32 values in [lo, hi) from two such
  draws of the two halves of split(key), reduced as `jax.random._randint`
  reduces them (span arithmetic in uint32).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2); all int64 tensors (or ints) of uint32 values, broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey of a uint32 seed: int64 [2]."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in of keys [..., 2] with uint32 data (an int or a
    tensor broadcast against the keys' leading shape)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split of keys [..., 2] -> [..., num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], i)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.bits (32 bits) of keys [..., 2] -> int64 [..., *shape]
    of uint32 values."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (y1 ^ y2).reshape(*lead, *shape)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) at the default int32
    dtype, for keys [..., 2] -> int64 [..., *shape]. minval and maxval
    are ints inside the int32 range, as `deband` passes them."""
    span = (maxval - minval) & MASK if maxval > minval else 1
    # 2^32 % span, as JAX takes it in 32 bits: (2^16 % span)^2 % span
    multiplier = ((65536 % span) ** 2) % span
    halves = split(key)
    low = random_bits(halves[..., 1, :], shape) % span
    if multiplier:
        high = random_bits(halves[..., 0, :], shape) % span
        low = ((high * multiplier) & MASK) + low
        low = (low & MASK) % span
    return low + minval
