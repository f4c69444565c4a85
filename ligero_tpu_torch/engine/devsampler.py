"""Fiat-Shamir challenge expansion on the device: ChaCha20 + ``F::rand``.

The counterpart of ``ligero_tpu.engine.devsampler.fr_sample_device``:
ChaCha20 (``rand_chacha``'s djb layout, counter from 0) in counter mode,
vectorised over blocks, then ark-ff ``F::rand`` rejection sampling (mask
the top u64 limb to the modulus width, accept iff below p) compacted in
stream order with a cumulative sum.  The i-th accepted attempt lands at
row i, so the output is bit-identical to
``ligero_tpu.sampling.rand_field_elements_limbs`` (Montgomery limbs).

Every attempt consumes a fixed slice of the keystream, so a shortfall is
handled exactly by drawing again with more attempts: the longer stream
has the shorter one as its prefix.  PyTorch ops in int64 (masked to 32
bits) on any device; the JAX package had no Pallas kernel here either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import FieldSpec

M32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def chacha20_blocks(key_words, num_blocks: int, device) -> torch.Tensor:
    """First ``num_blocks`` ChaCha20 keystream blocks from counter 0 as
    (num_blocks, 16) int64 words (``ligero_tpu.chacha.chacha_blocks``)."""
    counters = torch.arange(num_blocks, dtype=torch.int64, device=device)
    zeros = torch.zeros_like(counters)
    state = [torch.full_like(counters, c) for c in _CONSTANTS]
    state += [torch.full_like(counters, int(k)) for k in key_words]
    state += [counters & M32, counters >> 32, zeros, zeros]
    x = list(state)

    def rotl(v, n):
        return ((v << n) | (v >> (32 - n))) & M32

    def quarter(a, b, c, d):
        x[a] = (x[a] + x[b]) & M32
        x[d] = rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & M32
        x[b] = rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & M32
        x[d] = rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & M32
        x[b] = rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        quarter(0, 4, 8, 12)
        quarter(1, 5, 9, 13)
        quarter(2, 6, 10, 14)
        quarter(3, 7, 11, 15)
        quarter(0, 5, 10, 15)
        quarter(1, 6, 11, 12)
        quarter(2, 7, 8, 13)
        quarter(3, 4, 9, 14)
    return torch.stack([(x[i] + state[i]) & M32 for i in range(16)], dim=1)


def plan_attempts(field: FieldSpec, count: int) -> int:
    """First-round attempt budget, the host sampler's formula."""
    accept = field.p / float(2 ** field.modulus_bit_size)
    return int(count / accept * 1.05) + 64


def fr_sample(field: FieldSpec, count: int, seed: bytes, device) -> torch.Tensor:
    """``count`` ``F::rand`` draws from a ChaCha20 stream seeded with
    ``seed`` as (count, L) int32 Montgomery limbs on ``device``."""
    L = field.num_limbs
    if count == 0:
        return torch.zeros((0, L), dtype=torch.int32, device=device)
    key = np.frombuffer(seed, dtype="<u4")
    if key.shape != (8,):
        raise ValueError("fr_sample: seed must be 32 bytes")
    nl = field.num_u64_limbs
    wp = 2 * nl                                  # 32-bit words per attempt
    shave = 64 * nl - field.modulus_bit_size
    mask64 = (1 << (64 - shave)) - 1
    p_words = [(field.p >> (32 * i)) & M32 for i in range(wp)]
    attempts = plan_attempts(field, count)
    while True:
        num_blocks = -(-attempts * wp // 16)
        words = chacha20_blocks(key, num_blocks, device)
        cand = words.reshape(-1)[:attempts * wp].reshape(attempts, wp).clone()
        cand[:, wp - 2] &= mask64 & M32
        cand[:, wp - 1] &= mask64 >> 32
        lt = torch.zeros(attempts, dtype=torch.bool, device=device)
        decided = torch.zeros_like(lt)
        for i in reversed(range(wp)):
            lt |= ~decided & (cand[:, i] < p_words[i])
            decided |= cand[:, i] != p_words[i]
        pos = torch.cumsum(lt.to(torch.int64), 0) - 1
        if int(pos[-1]) + 1 >= count:
            break
        attempts *= 2
    dest = torch.where(lt & (pos < count), pos, torch.full_like(pos, count))
    out = torch.zeros((count + 1, wp), dtype=torch.int64, device=device)
    out[dest] = cand          # rejected attempts all land on the dump row
    out = out[:count]
    limbs = torch.stack([out & 0xFFFF, out >> 16], dim=-1).reshape(count, L)
    return limbs.to(torch.int32)
