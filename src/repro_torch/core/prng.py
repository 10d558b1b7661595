"""Keyed randomness: the port's own ``jax.random`` for the threefry2x32
implementation, with the partitionable bit layout
(``jax_threefry_partitionable = True``, the reference's default).

Keys are ``[2]`` int64 tensors holding two 32-bit words (``key_data``
of a jax key); a batch of keys is ``[S, 2]``. Every word is an int64
masked to 32 bits, since torch's uint32 arithmetic is partial, so the
same integer ops give the same bits on the CPU and on CUDA:

* ``key(seed)``            — ``[0, seed mod 2^32]`` (``threefry_seed``
                             without x64);
* ``fold_in(key, data)``   — ``threefry2x32(key, [0, data])``;
* ``split(key, n)``        — counters ``(0, i)``, key i = the pair;
* ``random_bits``          — counters ``(i >> 32, i & 0xffffffff)`` of the
                             flat index i, the word ``bits1 ^ bits2``;
* ``uniform``              — the mantissa trick: ``bits >> 9`` under the
                             exponent of 1.0, minus 1, scaled, then
                             ``max(minval, .)``;
* ``randint``              — two bit streams from ``split``, combined
                             modulo the span in 32-bit arithmetic;
* ``gumbel``               — mode "low": ``-log(-log(uniform(tiny, 1)))``;
* ``categorical``          — ``argmax(gumbel + logits)``, one key per row.

Bits, keys, uniforms and integers are bitwise jax's; gumbel noise goes
through ``log``, which may differ from XLA's by an ulp.

A single key on the CPU with a scalar draw (``fold_in``, and the
shape-``()`` draws) runs the same rounds on Python integers: the host
rules (the speculative sampler, the fault injector, the engine's
per-request keys) draw one scalar at a time, where the ~170 tiny tensor
ops of a draw cost far more (``chip_smoke.py``'s ``[rng]`` phase times
both and holds them bitwise equal).
"""

from __future__ import annotations

import math
import struct

import torch

from repro_torch import device as _device

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The 20-round threefry2x32 hash of the counter pair (x1, x2) under
    the key (k1, k2): five groups of four rounds, a key injection after
    each. Generic over Python ints and int64 tensors (broadcasting)."""
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


def _host_scalar(key: torch.Tensor) -> bool:
    return key.device.type == "cpu" and key.dim() == 1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` (32-bit seeds: the
    high word is 0). ``device`` defaults to the card."""
    dev = _device.resolve(device)
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=dev)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold ``data`` (an int in [0, 2^32), or an int64 tensor broadcast
    against the batch of keys) into ``key`` ([2] or [S, 2])."""
    if isinstance(data, int):
        if not 0 <= data <= MASK:
            raise ValueError(f"fold_in data {data} is out of uint32 range")
        if _host_scalar(key):
            k1, k2 = key.tolist()
            return torch.tensor(threefry2x32(k1, k2, 0, data),
                                dtype=torch.int64)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data & MASK)
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` keys [num, 2] from one key (the fold-like split)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32-bit words (int64) of ``jax.random.bits(key, shape, uint32)``.
    A batch of keys [S, 2] draws [S, *shape], one stream per key (what
    ``jax.vmap`` over the keys gives)."""
    shape = tuple(shape)
    batch = key.shape[:-1]
    n = math.prod(shape)
    if not batch and not shape and _host_scalar(key):
        b1, b2 = threefry2x32(*key.tolist(), 0, 0)
        return torch.tensor(b1 ^ b2, dtype=torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k1 = key[..., 0].reshape(*batch, 1)
    k2 = key[..., 1].reshape(*batch, 1)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(tuple(batch) + shape)


def _f32(x: float) -> float:
    """``x`` rounded to f32 (a Python float holding an f32 value)."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) f32 from the top 23 bits of each word: the word under the
    exponent of 1.0, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval), bitwise ``jax.random.uniform``:
    ``max(minval, u * (maxval - minval) + minval)``. XLA contracts the
    multiply-add into one fused, once-rounded op; here the product is
    exact in f64 (23 x 24 bits) and the sum rounds to f64, then to f32.
    The default ranges have a span of 1, where the product is exact in
    f32 too and every formulation agrees."""
    lo = _f32(minval)
    span = _f32(_f32(maxval) - lo)
    bits = random_bits(key, shape)
    if bits.dim() == 0 and bits.device.type == "cpu":
        u = struct.unpack("<f", struct.pack(
            "<I", (int(bits) >> 9) | 0x3F800000))[0] - 1.0
        return torch.tensor(max(lo, _f32(u * span + lo)),
                            dtype=torch.float32)
    u = _unit_floats(bits).to(torch.float64)
    return torch.clamp_min((u * span + lo).to(torch.float32), lo)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """int32-range integers in [minval, maxval), bitwise
    ``jax.random.randint`` (int32 dtype): two 32-bit streams from
    ``split``, combined modulo the span with uint32 wraparound."""
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    if not tuple(shape) and _host_scalar(key):
        k1, k2 = key.tolist()
        words = []
        for i in (0, 1):
            b1, b2 = threefry2x32(*threefry2x32(k1, k2, 0, i), 0, 0)
            words.append(b1 ^ b2)
        hi_b, lo_b = words
    else:
        ka, kb = split(key, 2)
        hi_b, lo_b = random_bits(ka, shape), random_bits(kb, shape)
    off = ((((hi_b % span) * mult) & MASK) + lo_b % span) & MASK
    out = minval + off % span
    return out if isinstance(out, torch.Tensor) else torch.tensor(out)


def gumbel(key: torch.Tensor, shape=()) -> torch.Tensor:
    """f32 Gumbel noise, mode "low" (jax's default)."""
    u = uniform(key, shape, minval=F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``argmax(gumbel + logits)`` over the last axis. ``key`` [*B, 2]
    gives row b its own stream over counters 0..V-1 (``jax.vmap`` of
    ``jax.random.categorical`` over the rows; one key and one row is the
    plain call). Ties go to the lower index, as ``jnp.argmax``."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits.to(torch.float32), dim=-1)
