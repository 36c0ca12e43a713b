"""Frozen for the benchmark's reference: a copy of
iivision_tpu_torch/ops/random.py, which this package never imports.

Threefry-2x32 nonces in torch integer ops, bit-equal to `jax.random`.

The JAX encoder draws its tie-break nonces as

    skey    = fold_in(PRNGKey(seed), step)
    nonce_p = uniform(fold_in(skey, 0), (32,))           page scores
    nonce_o = uniform(fold_in(skey, 1 + jj), (k, 256))   sub-op jj offsets

(iivision_tpu/encoder.py step_body and sub_op).  This module reproduces
those bits for JAX's default threefry2x32 implementation with
`jax_threefry_partitionable=True` (the default since JAX 0.5; the source
is jax/_src/prng.py: threefry_seed, _threefry_fold_in,
_threefry_random_bits_partitionable, and random.py _uniform).

uint32 words are held in int64 tensors and masked to 32 bits after every
add and shift, so no operation relies on integer wrap-around.  Keys are
pairs of int64 tensors that broadcast, so one call derives the nonces of
many steps at once; `step_nonces` does that for a block of encoder steps,
for one key or for a (B,) batch of keys (`prng_keys`, the form of
`jax.vmap(jax.random.PRNGKey)(seeds)`).  The body kernel (csrc/body.cu)
computes the same bits in uint32 registers from `key_words`.
"""

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 tensors
    holding uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device) -> tuple:
    """jax.random.PRNGKey(seed) for a 32-bit seed: the key (0, seed)."""
    k1, k2 = prng_keys([seed], device)
    return k1[0], k2[0]


def prng_keys(seeds, device) -> tuple:
    """jax.vmap(jax.random.PRNGKey)(seeds): one key per seed, as a pair of
    (B,) int64 tensors."""
    seeds = [int(s) for s in seeds]
    for s in seeds:
        if not -(1 << 31) <= s < (1 << 31):
            raise ValueError("seed %d does not fit 32 bits" % s)
    return (torch.zeros(len(seeds), dtype=torch.int64, device=device),
            torch.tensor([s & MASK32 for s in seeds], dtype=torch.int64,
                         device=device))


def key_words(seeds, device) -> torch.Tensor:
    """The keys of `prng_keys` as a (B, 2) int32 tensor holding the uint32
    words (the body kernel's key input)."""
    k1, k2 = prng_keys(seeds, device)
    words = torch.stack([k1, k2], dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def fold_in(key: tuple, data) -> tuple:
    """jax.random.fold_in(key, data): the key pair hashed with the counter
    pair (0, data).  `data` may be a tensor of many values."""
    k1, k2 = key
    data = torch.as_tensor(data, dtype=torch.int64, device=k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(data), data & MASK32)


def random_bits(key: tuple, n: int) -> torch.Tensor:
    """32-bit random words for n counters, shape key-shape + (n,):
    counters are (hi, lo) = (0, iota(n)) and the two outputs are xored."""
    k1, k2 = key
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    y0, y1 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(key: tuple, shape) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) in [0, 1): the top 23 bits
    of each word become the mantissa of a float in [1, 2), minus 1."""
    n = 1
    for s in shape:
        n *= s
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return f.reshape(f.shape[:-1] + tuple(shape))


def step_nonces(key: tuple, steps: torch.Tensor, k: int, j: int):
    """The encoder's nonces for a block of absolute step indices.

    `key` is one key (scalar tensors) or a batch of keys (shape (B,)).
    Returns (nonce_p key-shape + (S, 32), nonce_o key-shape + (S, j, k,
    256)) float32, equal to the JAX scan's per-step draws for every step in
    `steps` (under vmap over the keys for a batch)."""
    k1, k2 = key
    skey = fold_in((k1[..., None], k2[..., None]), steps)  # (..., S) pairs
    # the counter 0 made on the device: no copy from the host, so a CUDA
    # graph can hold the draw
    zero = torch.zeros((), dtype=torch.int64, device=steps.device)
    nonce_p = uniform(fold_in(skey, zero), (32,))
    jj = torch.arange(1, j + 1, dtype=torch.int64, device=steps.device)
    okey = fold_in((skey[0][..., None], skey[1][..., None]), jj)
    nonce_o = uniform(okey, (k, 256))  # (..., S, j, k, 256)
    return nonce_p, nonce_o
