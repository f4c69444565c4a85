"""Fiat-Shamir challenge expansion on the device: ChaCha20 + ``F::rand``.

The counterpart of ``ligero_tpu.engine.devsampler.fr_sample_device``:
ChaCha20 (``rand_chacha``'s djb layout, counter from 0) in counter mode,
vectorised over blocks, then ark-ff ``F::rand`` rejection sampling (mask
the top u64 limb to the modulus width, accept iff below p) compacted in
stream order with a cumulative sum.  The i-th accepted attempt lands at
row i, so the output is bit-identical to
``ligero_tpu.sampling.rand_field_elements_limbs`` (Montgomery limbs).

Every attempt consumes a fixed slice of the keystream, so the stream can
be drawn in segments of attempts (:class:`FrStream`): segment j starts at
a known keystream word, possibly inside a ChaCha20 block, and draws
accepted near a segment's end wait for the next request.  The draws are
the same whatever the segments, so a shortfall is handled exactly by the
next segment, and the streaming mode draws 4mk challenges with only one
segment's words live.  PyTorch ops in int64 (masked to 32
bits) on any device; the JAX package had no Pallas kernel here either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import FieldSpec

M32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def chacha20_blocks(key_words, num_blocks: int, device,
                    first: int = 0) -> torch.Tensor:
    """ChaCha20 keystream blocks ``first`` .. ``first + num_blocks - 1`` as
    (num_blocks, 16) int64 words (``ligero_tpu.chacha.chacha_blocks``
    from counter 0)."""
    counters = torch.arange(first, first + num_blocks, dtype=torch.int64,
                            device=device)
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


def _key(seed: bytes) -> np.ndarray:
    key = np.frombuffer(seed, dtype="<u4")
    if key.shape != (8,):
        raise ValueError("fr_sample: seed must be 32 bytes")
    return key


def _accepted(field: FieldSpec, cand: torch.Tensor) -> torch.Tensor:
    """``F::rand``'s test on (attempts, 2 u64-limbs) int64 words, masked
    in place to the modulus width: a bool per attempt, True below p."""
    nl = field.num_u64_limbs
    wp = 2 * nl
    shave = 64 * nl - field.modulus_bit_size
    mask64 = (1 << (64 - shave)) - 1
    p_words = [(field.p >> (32 * i)) & M32 for i in range(wp)]
    cand[:, wp - 2] &= mask64 & M32
    cand[:, wp - 1] &= mask64 >> 32
    lt = torch.zeros(cand.shape[0], dtype=torch.bool, device=cand.device)
    decided = torch.zeros_like(lt)
    for i in reversed(range(wp)):
        lt |= ~decided & (cand[:, i] < p_words[i])
        decided |= cand[:, i] != p_words[i]
    return lt


def _limbs(words: torch.Tensor, L: int) -> torch.Tensor:
    """(count, 2 u64-limbs) int64 words -> (count, L) int32 16-bit limbs."""
    return torch.stack([words & 0xFFFF, words >> 16], dim=-1).reshape(
        words.shape[0], L).to(torch.int32)


def fr_sample(field: FieldSpec, count: int, seed: bytes, device) -> torch.Tensor:
    """``count`` ``F::rand`` draws from a ChaCha20 stream seeded with
    ``seed`` as (count, L) int32 Montgomery limbs on ``device``: one
    :class:`FrStream` segment of the host sampler's attempt budget (a
    shortfall takes the next segment of the same stream)."""
    return FrStream(field, seed, device,
                    plan_attempts(field, count)).take(count)


class FrStream:
    """The draws of :func:`fr_sample` from ``seed``, taken in order by
    successive :meth:`take` calls, from ``segment`` attempts of keystream
    at a time: ``take(a)`` then ``take(b)`` give ``fr_sample(a + b)``'s
    rows.  Live: one segment's words and the accepted draws not yet taken
    (at most a segment's)."""

    def __init__(self, field: FieldSpec, seed: bytes, device, segment: int):
        if segment < 1:
            raise ValueError("FrStream: a segment holds at least one attempt")
        self.field, self.device, self.segment = field, device, segment
        self.key = _key(seed)
        self.attempt = 0                         # the next segment's first
        self.pending = torch.zeros((0, field.num_limbs), dtype=torch.int32,
                                   device=device)

    def _next_segment(self) -> torch.Tensor:
        """The accepted draws of the next ``segment`` attempts, in order."""
        wp = 2 * self.field.num_u64_limbs
        w0, w1 = self.attempt * wp, (self.attempt + self.segment) * wp
        b0 = w0 // 16
        words = chacha20_blocks(self.key, -(-w1 // 16) - b0, self.device,
                                first=b0).reshape(-1)
        cand = words[w0 - 16 * b0:w1 - 16 * b0].reshape(self.segment, wp)
        del words
        lt = _accepted(self.field, cand)
        self.attempt += self.segment
        return _limbs(cand[lt], self.field.num_limbs)

    def take(self, count: int) -> torch.Tensor:
        """The next ``count`` draws as (count, L) int32 Montgomery limbs."""
        out = torch.empty((count, self.field.num_limbs), dtype=torch.int32,
                          device=self.device)
        filled = 0
        while filled < count:
            if not self.pending.shape[0]:
                self.pending = self._next_segment()
                continue
            t = min(count - filled, self.pending.shape[0])
            out[filled:filled + t] = self.pending[:t]
            self.pending = self.pending[t:]
            filled += t
        return out
