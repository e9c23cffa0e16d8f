"""Threefry-2x32 keys and draws: the pieces of ``jax.random`` that the engine's
sampling reaches, bit for bit, as torch integer ops.

The JAX package samples with ``jax.random`` (``PRNGKey``, ``fold_in`` and
``categorical``); a request's token stream is a function of its keys, so the
port reproduces the generator itself rather than drawing from another one.
This follows the installed JAX 0.9.0 (``jax/_src/prng.py``: ``threefry_2x32``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``;
``jax/_src/random.py``: ``_uniform``, ``_gumbel``, ``categorical``) with
``jax_threefry_partitionable`` on, its default there.

A key is an int64 tensor whose last axis holds the two uint32 words; every
word is kept in [0, 2**32) by masking, so the hash runs on any device torch
runs integer ops on. ``categorical`` draws its Gumbel noise on the logits'
device: a 128,256-way draw for llama3-8b is made on the card, not on the host.

The bits and the uniforms are exact. The Gumbel noise takes two f32 logs,
which may differ from XLA's by an ulp.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny

KeyLike = Union[torch.Tensor, tuple, list]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)`` under
    the key ``(k1, k2)``; int64 tensors (or ints) of uint32 values that
    broadcast together. Returns the two output words. An int key word stays
    a Python scalar (no tensor is made from it on the device, which a CUDA
    graph capture would refuse)."""
    k1, k2 = _word(k1, x1), _word(k2, x1)
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


def _word(k, like: torch.Tensor):
    """A key word as an int64 tensor on ``like``'s device, or an int."""
    if isinstance(k, torch.Tensor):
        return k.to(like.device, torch.int64)
    return int(k) & MASK


def as_key(key: KeyLike, device=None) -> torch.Tensor:
    """A key (or a stack of keys) as an int64 tensor of uint32 words."""
    return torch.as_tensor(key, dtype=torch.int64, device=device) & MASK


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(0, seed mod 2**32)`` (the
    installed JAX casts the seed to 32 bits before splitting it)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def fold_in(key: KeyLike, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter ``(0, data)`` under
    ``key``. ``key`` (..., 2) and ``data`` (an int or a tensor) broadcast, so
    one call folds a batch of keys with a batch of indices."""
    key = as_key(key)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: KeyLike, n: int, device=None) -> torch.Tensor:
    """32-bit ``random_bits`` of shape (..., n) for a key (..., 2): the
    partitionable layout hashes the 64-bit flat index ``i`` as the counter
    ``(i >> 32, i & MASK)`` and XORs the two output words."""
    key = as_key(key, device)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0, None], key[..., 1, None]
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return y1 ^ y2


def uniform(key: KeyLike, n: int, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """f32 ``uniform`` of shape (..., n): 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to ``[minval, maxval)`` and clamped
    below at ``minval``, rounding in f32 where ``_uniform`` does."""
    bits = random_bits(key, n, device)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span rounded to f32 on the host, as _uniform rounds
    # them, then applied as scalars (exact in f32): no tensor is made from them
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(key: KeyLike, n: int, device=None) -> torch.Tensor:
    """f32 Gumbel noise (``_gumbel``'s ``low`` mode): ``-log(-log(u))`` with
    ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY, 1.0, device)))


def categorical(key: KeyLike, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per row:
    ``argmax(logits + gumbel)`` (the first index on ties). ``key`` is (2,)
    for logits (V,) or (B, 2) for logits (B, V), as ``vmap`` over keys."""
    noise = gumbel(key, logits.shape[-1], device=logits.device)
    return torch.argmax(noise.to(logits.dtype) + logits, dim=-1)
