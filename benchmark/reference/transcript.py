"""The Fiat-Shamir transcript of a Ligero proof, in plain Python and torch.

A frozen copy of the arithmetic of the program's host transcript (ark's
``test_sponge``: a Poseidon duplex sponge of width 3, alpha 17, 8 full and
31 partial rounds, MDS [[1,0,1],[1,1,0],[0,1,1]], round constants drawn by
``F::rand`` from ``ark_std::test_rng()``, a ChaCha12 stream) and of its
challenge expansions (``rand_chacha``'s ChaCha20 seeded with 32 squeezed
bytes; ``F::rand`` rejection sampling, whose accepted raw limbs are the
Montgomery form; rand 0.8's ``gen_range`` for the column indices).  The
bulk expansion runs the ChaCha20 block function on a torch device, one
lane a block.  Imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import Field

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_M32 = 0xFFFFFFFF
_QUARTERS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
             (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))
TEST_RNG_SEED = bytes([1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0]
                      + [0] * 16)


def chacha_words(seed: bytes, first_block: int, blocks: int, rounds: int,
                 device) -> torch.Tensor:
    """(blocks, 16) keystream words (int64 holding u32) of the djb ChaCha
    with a 64-bit block counter starting at ``first_block``."""
    key = np.frombuffer(seed, dtype="<u4").astype(np.int64)
    ctr = torch.arange(first_block, first_block + blocks, dtype=torch.int64,
                       device=device)
    state = [torch.full((blocks,), v, dtype=torch.int64, device=device)
             for v in list(_SIGMA) + key.tolist()]
    state += [ctr & _M32, ctr >> 32,
              torch.zeros(blocks, dtype=torch.int64, device=device),
              torch.zeros(blocks, dtype=torch.int64, device=device)]
    x = list(state)

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & _M32

    for _ in range(rounds // 2):
        for a, b, c, d in _QUARTERS:
            x[a] = (x[a] + x[b]) & _M32
            x[d] = rotl(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & _M32
            x[b] = rotl(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & _M32
            x[d] = rotl(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & _M32
            x[b] = rotl(x[b] ^ x[c], 7)
    return torch.stack([(x[i] + state[i]) & _M32 for i in range(16)], dim=1)


class ChaChaRng:
    """``rand_chacha``'s ChaChaXRng drawn a u64 at a time from a fresh
    seed (the buffer index stays even, so a u64 is two consecutive
    keystream words, low first)."""

    def __init__(self, seed: bytes, rounds: int = 20):
        self.seed, self.rounds = seed, rounds
        self.block, self.buf = 0, []

    def next_u64(self) -> int:
        if not self.buf:
            words = chacha_words(self.seed, self.block, 4, self.rounds,
                                 "cpu").reshape(-1).tolist()
            self.block += 4
            self.buf = [words[i] | (words[i + 1] << 32)
                        for i in range(0, 64, 2)][::-1]
        return self.buf.pop()


def _top_mask(field: Field) -> int:
    return (1 << (field.bits - 64 * (field.u64_limbs - 1))) - 1


def rand_scalar(field: Field, rng: ChaChaRng) -> int:
    """One ``F::rand`` draw as a canonical element."""
    nl = field.u64_limbs
    while True:
        limbs = [rng.next_u64() for _ in range(nl)]
        limbs[-1] &= _top_mask(field)
        raw = sum(v << (64 * i) for i, v in enumerate(limbs))
        if raw < field.p:
            return raw * field.r_inv % field.p


def rand_raw16(field: Field, count: int, seed: bytes, device) -> torch.Tensor:
    """The first ``count`` ``F::rand`` draws of ChaCha20(seed) as their
    raw accepted limbs (the Montgomery form: the element is raw * R^-1):
    (count, L) int64 16-bit limbs on ``device``.  Every attempt takes the
    next u64-limb count of u64s, so the keystream is cut into attempts
    before any is rejected."""
    nl, L = field.u64_limbs, field.limbs
    p16 = torch.tensor([(field.p >> (16 * i)) & 0xFFFF for i in range(L)],
                       dtype=torch.int64, device=device)
    accept = field.p / float(1 << field.bits)
    got, parts, attempt0 = 0, [], 0
    while got < count:
        attempts = int((count - got) / accept * 1.05) + 64
        # attempt a takes u64s [a nl, (a + 1) nl): 8 u64s a block
        w0 = 2 * nl * attempt0
        w1 = 2 * nl * (attempt0 + attempts)
        b0, b1 = w0 // 16, -(-w1 // 16)
        words = chacha_words(seed, b0, b1 - b0, 20, device).reshape(-1)
        words = words[w0 - 16 * b0:w1 - 16 * b0].reshape(attempts, 2 * nl)
        limbs = torch.stack([words & 0xFFFF, words >> 16], dim=2).reshape(
            attempts, L)
        top = 4 * nl - 4                    # the top u64's four limbs
        mask = _top_mask(field)
        for i in range(4):
            limbs[:, top + i] &= (mask >> (16 * i)) & 0xFFFF
        # limbs < p, compared from the top limb down
        lt = torch.zeros(attempts, dtype=torch.bool, device=device)
        decided = torch.zeros_like(lt)
        for i in range(L - 1, -1, -1):
            lt |= ~decided & (limbs[:, i] < p16[i])
            decided |= limbs[:, i] != p16[i]
        acc = limbs[lt]
        parts.append(acc[:count - got])
        got += min(len(acc), count - got)
        attempt0 += attempts
    return torch.cat(parts)


def gen_range(rng: ChaChaRng, n: int) -> int:
    """rand 0.8 ``gen_range(0..n)`` for a u64: widening multiply with
    rejection above the zone."""
    zone = ((n << (64 - n.bit_length())) - 1) & ((1 << 64) - 1)
    while True:
        prod = rng.next_u64() * n
        if prod & ((1 << 64) - 1) <= zone:
            return prod >> 64


def column_indices(n: int, t: int, seed: bytes) -> list[int]:
    """The t sorted distinct columns of ``get_distinct_indices_from_prng``
    (the complement drawn where t > n / 2)."""
    rng = ChaChaRng(seed)
    want = min(t, n - t)
    chosen: set[int] = set()
    while len(chosen) < want:
        chosen.add(gen_range(rng, n))
    if want == t:
        return sorted(chosen)
    return [i for i in range(n) if i not in chosen]


class Sponge:
    """ark's ``PoseidonSponge`` of ``test_sponge`` (rate 2, capacity 1,
    the capacity element first), its duplex absorb and squeeze modes."""

    FULL, PARTIAL, ALPHA, RATE = 8, 31, 17, 2

    def __init__(self, field: Field):
        self.field = field
        rng = ChaChaRng(TEST_RNG_SEED, rounds=12)
        self.ark = [[rand_scalar(field, rng) for _ in range(3)]
                    for _ in range(self.FULL + self.PARTIAL)]
        self.state = [0, 0, 0]
        self.squeezing = False
        self.index = 0

    def _permute(self) -> None:
        p, s = self.field.p, self.state
        half = self.FULL // 2
        for r, rc in enumerate(self.ark):
            s = [(v + c) % p for v, c in zip(s, rc)]
            if r < half or r >= half + self.PARTIAL:
                s = [pow(v, self.ALPHA, p) for v in s]
            else:
                s[0] = pow(s[0], self.ALPHA, p)
            s = [(s[0] + s[2]) % p, (s[0] + s[1]) % p, (s[1] + s[2]) % p]
        self.state = s

    def absorb(self, elems: list[int]) -> None:
        if not elems:
            return
        p = self.field.p
        elems = [e % p for e in elems]
        if not self.squeezing and self.index < self.RATE:
            start = self.index
        else:
            self._permute()
            start = 0
        while True:
            take = min(self.RATE - start, len(elems))
            for i in range(take):
                self.state[1 + start + i] = (self.state[1 + start + i]
                                             + elems[i]) % p
            elems = elems[take:]
            if not elems:
                self.squeezing, self.index = False, start + take
                return
            self._permute()
            start = 0

    def absorb_bytes(self, data: bytes) -> None:
        buf = len(data).to_bytes(8, "little") + data
        u = self.field.sponge_bytes
        self.absorb([int.from_bytes(buf[i:i + u], "little")
                     for i in range(0, len(buf), u)])

    def squeeze(self, count: int) -> list[int]:
        if not self.squeezing or self.index == self.RATE:
            self._permute()
            start = 0
        else:
            start = self.index
        out = []
        while True:
            if start + count <= self.RATE:
                out += self.state[1 + start:1 + start + count]
                self.squeezing, self.index = True, start + count
                return out
            out += self.state[1 + start:1 + self.RATE]
            if count != self.RATE:       # as ark's squeeze does
                self._permute()
            count -= self.RATE - start
            start = 0

    def squeeze_bytes(self, count: int) -> bytes:
        u, size = self.field.sponge_bytes, self.field.byte_size
        elems = self.squeeze(-(-count // u))
        return b"".join(e.to_bytes(size, "little")[:u] for e in elems)[:count]
