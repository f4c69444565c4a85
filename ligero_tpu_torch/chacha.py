"""ChaCha stream-cipher PRNG, bit-compatible with the Rust ``rand_chacha`` crate.

The port's own copy of ``ligero_tpu/chacha.py``, same names and structure;
the tests hold the two against each other on the same inputs.

The reference derives every Fiat–Shamir challenge from ``ChaCha20Rng``
seeded with 32 sponge bytes (reference src/utils.rs:23-55), and the Poseidon
sponge's round constants from ``ark_std::test_rng()`` which is
``StdRng = ChaCha12Rng`` with a fixed seed.  Both are reproduced here.

``rand_chacha`` specifics that matter for bit-exactness:

* djb ChaCha variant: state = 4 constant words | 8 key words | 2 counter
  words (64-bit counter, low word first) | 2 stream-id words (0).
* The RNG refills a buffer of **4 blocks = 64 u32 words** at a time; words
  are the little-endian state words of blocks ``c, c+1, c+2, c+3``.
* ``next_u64`` = ``lo | hi << 32`` from two consecutive buffer words (with
  block-straddling semantics from ``rand_core::BlockRng`` — never hit in
  practice here because all consumers draw only u64s from a fresh RNG, so
  the index stays even).

The block function is vectorised over counters with numpy ``uint32``
arithmetic — this is the same formulation the JAX device kernel uses.
"""

from __future__ import annotations

import numpy as np

_CONSTANTS = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def chacha_blocks(key_words: np.ndarray, counter0: int, num_blocks: int,
                  rounds: int = 20, stream: int = 0) -> np.ndarray:
    """Generate ``num_blocks`` ChaCha blocks starting at ``counter0``.

    Returns ``(num_blocks, 16)`` uint32 words (the serialised keystream read
    as little-endian u32s).
    """
    # word-major (16, num_blocks) working layout: every quarter-round op
    # then touches a contiguous row instead of a stride-64B column slice
    # (~8x faster at the protocol's multi-million-word draws)
    counters = np.arange(counter0, counter0 + num_blocks, dtype=np.uint64)
    state = np.zeros((16, num_blocks), dtype=np.uint32)
    state[0:4] = _CONSTANTS[:, None]
    state[4:12] = np.asarray(key_words, dtype=np.uint32)[:, None]
    state[12] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    state[13] = (counters >> np.uint64(32)).astype(np.uint32)
    state[14] = np.uint32(stream & 0xFFFFFFFF)
    state[15] = np.uint32((stream >> 32) & 0xFFFFFFFF)

    x = state.copy()

    def quarter(a, b, c, d):
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        # column round
        quarter(0, 4, 8, 12)
        quarter(1, 5, 9, 13)
        quarter(2, 6, 10, 14)
        quarter(3, 7, 11, 15)
        # diagonal round
        quarter(0, 5, 10, 15)
        quarter(1, 6, 11, 12)
        quarter(2, 7, 8, 13)
        quarter(3, 4, 9, 14)

    return np.ascontiguousarray((x + state).T)


def key_words_from_seed(seed: bytes) -> np.ndarray:
    assert len(seed) == 32
    return np.frombuffer(seed, dtype="<u4").copy()


def word_stream(seed: bytes, num_words: int, rounds: int = 20) -> np.ndarray:
    """First ``num_words`` u32 keystream words for a freshly seeded RNG."""
    key = key_words_from_seed(seed)
    nblocks = (num_words + 15) // 16
    return chacha_blocks(key, 0, nblocks, rounds=rounds).reshape(-1)[:num_words]


def u64_stream(seed: bytes, num_u64: int, rounds: int = 20) -> np.ndarray:
    """First ``num_u64`` ``next_u64`` outputs of a freshly seeded rand_chacha RNG.

    Valid provided the consumer only ever draws u64s (true for ``F::rand``
    and ``gen_range::<usize>``): the buffer index then stays even and the
    BlockRng straddle path is never taken.
    """
    words = word_stream(seed, 2 * num_u64, rounds=rounds)
    # rand_chacha's next_u64 = lo_word | hi_word << 32 over the LE word
    # stream — exactly the little-endian u64 view of the contiguous pairs
    return np.ascontiguousarray(words).view("<u8")


class ChaChaRng:
    """Faithful scalar model of ``rand_chacha``'s ``ChaChaXRng``.

    Implements the exact ``rand_core::BlockRng`` buffering semantics
    (64-word refills, u64 straddle handling) so it can serve as the golden
    model in tests and for the small transcript-side draws.
    """

    BUF_WORDS = 64  # rand_chacha generates 4 blocks per refill

    def __init__(self, seed: bytes, rounds: int = 20):
        self.key = key_words_from_seed(seed)
        self.rounds = rounds
        self.block_counter = 0  # counts 16-word blocks
        self.buf = np.zeros(0, dtype=np.uint32)
        self.index = self.BUF_WORDS  # force refill on first use

    def _refill(self):
        self.buf = chacha_blocks(self.key, self.block_counter, 4,
                                 rounds=self.rounds).reshape(-1)
        self.block_counter += 4
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= self.BUF_WORDS:
            self._refill()
        w = int(self.buf[self.index])
        self.index += 1
        return w

    def next_u64(self) -> int:
        # rand_core::BlockRng::next_u64 semantics
        if self.index < self.BUF_WORDS - 1 and self.index < len(self.buf):
            lo = int(self.buf[self.index])
            hi = int(self.buf[self.index + 1])
            self.index += 2
            return lo | (hi << 32)
        if self.index >= len(self.buf) or self.index >= self.BUF_WORDS:
            self._refill()
            lo = int(self.buf[0])
            hi = int(self.buf[1])
            self.index = 2
            return lo | (hi << 32)
        # straddle: last word of this buffer + first word of the next
        lo = int(self.buf[self.BUF_WORDS - 1])
        self._refill()
        hi = int(self.buf[0])
        self.index = 1
        return lo | (hi << 32)


def ark_std_test_rng() -> ChaChaRng:
    """``ark_std::test_rng()``: StdRng (= ChaCha12) with ark's fixed seed."""
    seed = bytes([1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0,
                  0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0])
    return ChaChaRng(seed, rounds=12)
